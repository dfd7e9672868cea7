"""The port's CUDA kernels against their plain PyTorch versions, and the
card's refit, half-precision records, GI compaction and render_many
against the CPU forms or against themselves, on the card.

These tests import neither JAX nor the JAX package, so they also run on
a machine without JAX.  The repository's conftest.py imports JAX, so run
them there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel must equal its plain version bit for bit: t/u/v, the hit
slot (occlusion) and the three per-chunk stats.  Both are built with the same
operation order and without FMA contraction (ops/stream_trace.py), and
the worklists are the same tensors, so ties resolve alike.  Without a
card the tests skip (marker ``gpu``).
"""

import numpy as np
import pytest
import torch

from royaltracer_dx_tpu_torch.ops import stream_trace as tst
from royaltracer_dx_tpu_torch.scene.procedural import menger_sponge


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _scene_and_rays(n, seed=3):
    rng = np.random.default_rng(seed)
    v, idx = menger_sponge(2)
    c = rng.uniform(-1, 1, (3000, 1, 3)).astype(np.float32)
    soup = c + rng.uniform(-0.08, 0.08, (3000, 3, 3)).astype(np.float32)
    tris = np.concatenate([v[idx].astype(np.float32), soup])
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # every third lane is masked (t_max < t_min), like a dead shadow lane
    t_max = np.where(np.arange(n) % 3 == 0, -1.0, 3.0).astype(np.float32)
    return tris, o, d, t_max


@pytest.mark.gpu
@pytest.mark.parametrize("occlusion", [False, True])
def test_cuda_kernel_matches_plain(occlusion):
    dev = _card()
    tris, o, d, t_max = _scene_and_rays(20000)
    ta = tst.build_stream_accel(torch.as_tensor(tris, device=dev))
    rows, wl, went, cnt = tst.prepare_stream(
        torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev), ta,
        1e-4, torch.as_tensor(t_max, device=dev), 16)
    kern = tst.stream_any if occlusion else tst.stream_closest
    name = "stream_any" if occlusion else "stream_closest"
    before = tst.LAUNCHES[name]
    k_tuv, k_slot, k_stats = kern(rows, wl, went, cnt, ta.blk_tris,
                                  ta.blk_boxes)
    torch.cuda.synchronize()
    assert tst.LAUNCHES[name] == before + 1
    p_tuv, p_slot, p_stats = tst._stream_plain(
        rows, wl, went, cnt, ta.blk_tris, ta.blk_boxes, occlusion)
    assert torch.equal(k_slot, p_slot)
    assert torch.equal(k_tuv, p_tuv)
    assert k_stats.shape == (rows.shape[0] // tst.RAYS_PER_CHUNK, 3)
    assert torch.equal(k_stats, p_stats)


@pytest.mark.gpu
@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("case", ["one_in_16", "one_per_chunk",
                                  "empty_worklists", "single_chunk"])
def test_cuda_kernel_matches_plain_on_sparse_batches(case, occlusion):
    """Few valid lanes (the warp-per-ray forms of the slab and hit tests),
    chunks with an empty worklist between live ones, and a single chunk:
    all three stats, slots and t/u/v equal the plain version's."""
    dev = _card()
    n = 100 if case == "single_chunk" else 20001
    tris, o, d, _ = _scene_and_rays(n, seed=11)
    lane = np.arange(n)
    keep = {"one_in_16": lane % 16 == 0,
            "one_per_chunk": lane % tst.RAYS_PER_CHUNK == 77}.get(
                case, np.ones(n, bool))
    ta = tst.build_stream_accel(torch.as_tensor(tris, device=dev))
    t_max = torch.as_tensor(np.where(keep, 3.0, -1.0).astype(np.float32),
                            device=dev)
    rows, wl, went, cnt = tst.prepare_stream(
        torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev), ta,
        1e-4, t_max, 16)
    rows[:n, 8] = torch.as_tensor(keep, device=dev).float()
    if case == "empty_worklists":
        cnt[1::2] = 0
    kern = tst.stream_any if occlusion else tst.stream_closest
    k_out = kern(rows, wl, went, cnt, ta.blk_tris, ta.blk_boxes)
    torch.cuda.synchronize()
    p_out = tst._stream_plain(rows, wl, went, cnt, ta.blk_tris, ta.blk_boxes,
                              occlusion)
    for k, p in zip(k_out, p_out):
        assert torch.equal(k, p)
    assert int(k_out[2][:, 2].sum()) > 0


@pytest.mark.gpu
def test_cuda_hits_match_brute():
    """The whole trace on the card (padding, worklists, kernel, slot ->
    triangle id) against brute force: the same t and occlusion, with
    masked lanes never occluded.  A hit within an ulp of a cluster box's
    face may fall to the slab test's rounding, so at most one lane in a
    thousand may differ."""
    from royaltracer_dx_tpu_torch.ops import intersect as tit

    dev = _card()
    n = 5000
    tris, o, d, t_max = _scene_and_rays(n, seed=8)
    tv = torch.as_tensor(tris, device=dev)
    ta = tst.build_stream_accel(tv)
    ot, dt = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    th = tst.closest_hit_stream(ot, dt, ta)
    bh = tit.closest_hit_brute(ot, dt, tv)
    assert int((th.t < 1e29).sum()) > n // 10
    assert int((th.t != bh.t).sum()) <= n // 1000
    tm = torch.as_tensor(t_max, device=dev)
    occ = tst.any_hit_stream(ot, dt, ta, 1e-4, tm)
    assert int((occ != tit.any_hit_brute(ot, dt, tv, 1e-4, tm)).sum()) \
        <= n // 1000
    assert not occ[::3].any()


@pytest.mark.gpu
def test_cuda_refit_matches_cpu():
    """Build and refit on the card equal build and refit on the CPU (the
    CPU forms are held against the JAX package by the CPU tests)."""
    dev = _card()
    tris, _, _, _ = _scene_and_rays(16)
    moved = tris + np.float32([0.1, -0.2, 0.05])
    out = []
    for d in (dev, torch.device("cpu")):
        acc = tst.build_stream_accel(torch.as_tensor(tris, device=d))
        out.append(tst.refit_stream_accel(acc, torch.as_tensor(moved,
                                                               device=d)))
    for f in ("perm", "blk_tris", "blk_boxes", "top_lo", "top_hi"):
        np.testing.assert_array_equal(getattr(out[0], f).cpu().numpy(),
                                      getattr(out[1], f).numpy(), err_msg=f)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f16", "bf16"])
def test_cuda_half_records_match_cpu(dtype):
    from royaltracer_dx_tpu_torch.render import restir_renderer as tr

    dev = _card()
    rng = np.random.default_rng(9)
    n = 4096

    def state(keys):
        return {k: (rng.normal(size=(n, 3)) * 10.0 ** rng.uniform(
            -9, 6, (n, 1))).astype(np.float32) for k in keys}

    di = dict(state(("x2", "n2", "l2")),
              **{k: np.abs(rng.normal(size=n)).astype(np.float32)
                 for k in ("w_sum", "w", "m")})
    gi = dict(state(("xn", "nn", "e3")),
              **{k: np.abs(rng.normal(size=n)).astype(np.float32)
                 for k in ("w_sum", "w", "m")})
    sd = dict(state(("x1", "n1", "o", "l1")),
              mid=rng.integers(-2, 200, n).astype(np.int32),
              obj=rng.integers(0, 40, n).astype(np.int32))
    packs = [tr._pack_last(*({k: torch.as_tensor(v, device=d)
                              for k, v in x.items()} for x in (di, gi, sd)),
                           tr._REC_DTYPES[dtype])
             for d in (dev, torch.device("cpu"))]
    for rec_c, rec_h in zip(*packs):
        for a, b in zip(rec_c, rec_h):
            assert torch.equal(a.cpu().view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
def test_cuda_compaction_and_render_many_bit_identical():
    """On the card: compacted GI bounces give the uncompacted frames bit
    for bit, and render_many(2) gives two render() calls bit for bit."""
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    _card()
    states = {}
    for key, mode, many in (("on", "on", False), ("off", "off", False),
                            ("many", "off", True)):
        scene, camera = menger_scene()
        r = RestirRenderer(scene, camera, RenderConfig(
            width=128, height=96, gi_compaction=mode))
        if many:
            r.render_many(2)
        else:
            r.render()
            r.render()
        states[key] = r.state_dict()
    for key in ("on", "many"):
        for k, v in states["off"].items():
            np.testing.assert_array_equal(states[key][k], v, err_msg=k)


def _lane_state(n, seed, dev):
    """A megakernel lane state around the menger sponge (many rays miss:
    their shadow rays start at ~1e30 with t_min NaN)."""
    rng = np.random.default_rng(seed)

    def unit():
        v = rng.normal(size=(n, 3))
        return torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True),
                               dtype=torch.float32, device=dev)

    return dict(
        origin=torch.as_tensor(rng.uniform(-0.5, 1.5, (n, 3)),
                               dtype=torch.float32, device=dev),
        direction=unit(),
        throughput=torch.as_tensor(rng.uniform(0.05, 1.0, (n, 3)),
                                   dtype=torch.float32, device=dev),
        pdf_prev=torch.as_tensor(rng.uniform(0.1, 5.0, n),
                                 dtype=torch.float32, device=dev),
        seed=torch.as_tensor(rng.integers(0, 2**32, (n, 2)),
                             dtype=torch.int64, device=dev),
        emission=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        alive=torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev),
        prev_normal=unit(),
        rays=torch.zeros((), dtype=torch.float32, device=dev))


def _menger_arrays(dev):
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    scene, _ = menger_scene()
    return scene.flatten(scene.build_materials(device=dev),
                         build_stream=True, device=dev)


@pytest.mark.gpu
def test_cuda_megakernel_bounce_matches_cpu():
    """One megakernel bounce (bounce 4: russian roulette on) on the card,
    through the stream kernels, against the same bounce on the CPU
    through their plain versions: ints and decisions equal and floats
    within 1e-5 + 1e-4 relative on >= 99.9% of the lanes (an ulp of
    difference in sqrt/cos/sin between the devices can flip a decision)."""
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render import megakernel as tmk

    dev = _card()
    cfg = RenderConfig(width=64, height=64, traversal="stream")
    sa = _menger_arrays(dev)
    sa_cpu = _menger_arrays(torch.device("cpu"))
    n = 16384
    before = dict(tst.LAUNCHES)
    out = tmk.bounce_step(sa, _lane_state(n, 5, dev), 4, cfg)
    torch.cuda.synchronize()
    assert all(tst.LAUNCHES[k] > before[k] for k in before)
    ref = tmk.bounce_step(sa_cpu, _lane_state(n, 5, torch.device("cpu")), 4,
                          cfg)
    agree = torch.ones(n, dtype=torch.bool)
    for k, v in ref.items():
        a = out[k].cpu()
        if k == "rays":
            assert float(a) == float(v)
            continue
        ok = (torch.isclose(a, v, rtol=1e-4, atol=1e-5, equal_nan=True)
              if v.is_floating_point() else a == v)
        agree &= ok.reshape(n, -1).all(dim=1)
    assert float(agree.float().mean()) >= 0.999
    assert 0.1 < float(ref["alive"].float().mean()) < 0.9


@pytest.mark.gpu
def test_cuda_megakernel_kernels_match_plain(monkeypatch):
    """Every stream-kernel launch of two megakernel frames on the card
    (closest batches with dead lanes, shadow batches with missed lanes
    whose t_min is NaN) equals the plain version bit for bit, and every
    chunk with a live lane that the plain version finds occluded walks."""
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render.renderer import Renderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    _card()
    calls = []
    real = tst._launch

    def spy(name, rows, wl, went, cnt, blk_tris, blk_boxes, lib=None):
        out = real(name, rows, wl, went, cnt, blk_tris, blk_boxes, lib)
        calls.append((name, (rows, wl, went, cnt, blk_tris, blk_boxes), out))
        return out

    monkeypatch.setattr(tst, "_launch", spy)
    r = Renderer(*menger_scene(), RenderConfig(width=160, height=120,
                                               max_bounces=5))
    r.render()
    r.render()
    torch.cuda.synchronize()
    assert len(calls) == 2 * 2 * 5
    nan_lanes = 0
    for name, args, out in calls:
        plain = tst._stream_plain(*args, name == "stream_any")
        for k, p in zip(out, plain):
            assert torch.equal(k, p), name
        nan_lanes += int(torch.isnan(args[0][:, 6]).sum())
    assert nan_lanes > 0
    assert np.isfinite(r.radiance()).all() and r.radiance().mean() > 0


# ------------------------- LBVH kernels and bands -------------------------


def _bvh_case(case, dev):
    """(LBVH, rays [N, 8]) on ``dev``: the menger + soup triangles with
    random rays (every third lane dead), or the Cornell box with rays from
    inside it (every fifth lane dead)."""
    from royaltracer_dx_tpu_torch.ops import bvh as tbvh
    from royaltracer_dx_tpu_torch.ops import traverse as ttr
    from royaltracer_dx_tpu_torch.scene.procedural import cornell_box

    if case == "soup":
        tris, o, d, t_max = _scene_and_rays(20000)
        t_min = np.full(len(o), 1e-4, np.float32)
    else:
        s = cornell_box()
        tris = s.flatten(s.build_materials(with_lut=False, device="cpu"),
                         device="cpu").tri_verts.numpy()
        rng = np.random.default_rng(8)
        n = 16384
        o = (rng.uniform(-0.9, 0.9, (n, 3)) * 0.4 + 0.5).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t_min = np.zeros(n, np.float32)
        t_max = np.where(np.arange(n) % 5 == 0, -1.0, 0.6).astype(np.float32)
    b = tbvh.build_lbvh(torch.as_tensor(tris, device=dev), leaf_size=4)
    rays = ttr.pack_rays(torch.as_tensor(o, device=dev),
                         torch.as_tensor(d, device=dev),
                         torch.as_tensor(t_min, device=dev),
                         torch.as_tensor(t_max, device=dev))
    return b, rays


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["soup", "cornell"])
@pytest.mark.parametrize("occlusion", [False, True])
def test_cuda_bvh_kernel_matches_plain(case, occlusion):
    """bvh_closest / bvh_any against their plain versions on the same
    inputs: t, u, v, tri and the walk counts (node and triangle tests)
    bit-equal for closest; the occlusion flags equal for any hit (its
    kernel walks in another order, so its counts differ)."""
    from royaltracer_dx_tpu_torch.ops import traverse as ttr

    dev = _card()
    b, rays = _bvh_case(case, dev)
    name = "bvh_any" if occlusion else "bvh_closest"
    before = ttr.LAUNCHES[name]
    if occlusion:
        k_occ, k_st = ttr.bvh_any(rays, b, stats=True)
        torch.cuda.synchronize()
        p_occ, _ = ttr._any_plain(rays, b)
        assert torch.equal(k_occ, p_occ)
        assert 0 < int(k_occ.sum()) < rays.shape[0]
        assert not bool(k_occ[rays[:, 7] <= rays[:, 6]].any())
    else:
        k_tuv, k_tri, k_st = ttr.bvh_closest(rays, b, stats=True)
        torch.cuda.synchronize()
        p_tuv, p_tri, p_st = ttr._closest_plain(rays, b)
        assert torch.equal(k_tri, p_tri)
        assert torch.equal(k_tuv, p_tuv)
        assert torch.equal(k_st[:, :2], p_st[:, :2])
        assert int((k_tuv[:, 0] < 1e29).sum()) > 0
    assert ttr.LAUNCHES[name] == before + 1
    work = ttr.bvh_work(rays, b, k_st, not occlusion)
    assert work["node_tests"] > 0 and work["bytes"] > 0


@pytest.mark.gpu
def test_cuda_sharded_frame_matches_cpu():
    """A 2-band sharded 96x54 menger frame on the card (both bands on
    cuda:0) against the same 2-band frame on the CPU (the plain versions),
    at small_frames_agree's tolerance in chip_smoke.py: >= 99% of pixels
    within 1e-3 and per-channel means within 0.5%."""
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.parallel.shard import ShardedRestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    dev = _card()
    imgs = []
    for devs in ([dev] * 2, ["cpu"] * 2):
        scene, camera = menger_scene()
        r = ShardedRestirRenderer(scene, camera,
                                  RenderConfig(width=96, height=54),
                                  devices=devs)
        for _ in range(2):
            r.render()
        assert float(r.fb.count.min()) == 2.0
        imgs.append(r.radiance())
    a, b = imgs
    assert np.isfinite(a).all() and a.mean() > 0.0
    close = np.abs(a - b) <= 1e-3 * np.maximum(1.0, np.abs(b))
    assert close.all(axis=-1).mean() >= 0.99
    np.testing.assert_allclose(a.reshape(-1, 3).mean(0),
                               b.reshape(-1, 3).mean(0), rtol=5e-3)
