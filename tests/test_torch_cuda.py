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

from royaltracer_dx_tpu_torch.ops import brute_trace as tbt
from royaltracer_dx_tpu_torch.ops import light_sampling as tls
from royaltracer_dx_tpu_torch.ops import cluster_traverse as tct
from royaltracer_dx_tpu_torch.ops import mxu_trace as tmx
from royaltracer_dx_tpu_torch.ops import stream_trace as tst
from royaltracer_dx_tpu_torch.ops import traverse as ttr
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from royaltracer_dx_tpu_torch.scene.procedural import menger_sponge
from royaltracer_dx_tpu_torch.tools.brute_cases import BRUTE_CASES, brute_case
from royaltracer_dx_tpu_torch.tools.mxu_cases import MXU_CASES, mxu_case
from royaltracer_dx_tpu_torch.utils import rng as trng


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


def _aimed(tris, rng, n, jitter=1e-3):
    """Rays from a shell around the triangles at random triangles'
    centroids (most hit)."""
    c = tris.mean(axis=(0, 1))
    ext = float(np.abs(tris - c).max()) * 1.5
    o = c + rng.uniform(-ext, ext, (n, 3))
    aim = tris[rng.integers(0, len(tris), n)].mean(axis=1)
    d = aim + rng.normal(scale=jitter, size=(n, 3)) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _quads():
    """Axis-aligned unit quads (two triangles sharing a diagonal) on a
    4x4 grid in 8 planes z = const, and the same grid turned to the x and
    y planes."""
    tris = []
    for z in np.linspace(-1.0, 1.0, 8):
        for i in range(4):
            for j in range(4):
                x0, y0 = -1.0 + 0.5 * i, -1.0 + 0.5 * j
                a, b = (x0, y0, z), (x0 + 0.5, y0, z)
                c, d = (x0 + 0.5, y0 + 0.5, z), (x0, y0 + 0.5, z)
                tris += [(a, b, c), (a, c, d)]
    t = np.asarray(tris, np.float32)
    return np.concatenate([t, t[..., [2, 0, 1]], t[..., [1, 2, 0]]])


def bvh_order_case(name):
    """(triangles, rays [N, 8] on the CPU, leaf size) of a case that
    stresses the closest walk's order: "soup64" / "soup1024" (random
    soups of 64 and 1,024 leaves: S < 256 and S = 256), "ties" (each
    triangle five times, so two leaves hold exact ties in t), "axis"
    (axis-aligned rays on axis-aligned quads, through their corners,
    edges and diagonals), "edges" (rays through a mesh's shared edges and
    vertices).  Every case mixes in dead lanes, NaN bounds, t_max = inf,
    t_max = 1e30 and t_max = t_min; soup64 also NaN t_max lanes (the
    plain version then runs its whole iteration cap)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name in ("soup64", "soup1024"):
        n_tris = 250 if name == "soup64" else 4000
        v, idx = tproc.random_tris(n_tris, seed=7, size=0.05)
        tris = np.asarray(v[idx], np.float32)
        o, d = _aimed(tris, rng, 160)
    elif name == "ties":
        # each triangle 5 times: the copies straddle leaves of 4, so two
        # leaves hold exact ties in t
        v, idx = tproc.random_tris(60, seed=3, size=0.08)
        tris = np.repeat(np.asarray(v[idx], np.float32), 5, axis=0)
        o, d = _aimed(tris, rng, 160, jitter=0.0)
    elif name == "axis":
        tris = _quads()
        # quad corners, edge midpoints and diagonal points
        g = np.asarray([-1.0, -0.75, -0.5, 0.0, 0.25, 1.0], np.float32)
        gx, gy = np.meshgrid(g, g)
        pts = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
        o, d = [], []
        for axis in range(3):
            for sign in (1.0, -1.0):
                q = np.insert(pts, axis, -1.5 * sign, axis=1)
                o.append(q)
                axis_dir = np.eye(3, dtype=np.float32)[axis] * sign
                d.append(np.broadcast_to(axis_dir, q.shape))
        o = np.concatenate(o).astype(np.float32)
        d = np.concatenate(d).astype(np.float32)
    elif name == "edges":
        # a folded mesh: rays through its shared edges and vertices
        v, idx = tproc.heightfield(13, extent=1.0, seed=2)
        v = np.asarray(v, np.float32)
        tris = v[np.asarray(idx)]
        e = rng.integers(0, len(tris), 160)
        k = rng.integers(0, 3, 160)
        a, b = tris[e, k], tris[e, (k + 1) % 3]
        w = np.where(rng.random(160) < 0.3, 0.0, 0.5)[:, None]
        aim = (a * (1 - w) + b * w).astype(np.float32)
        o = (aim + rng.normal(scale=1.0, size=(160, 3))).astype(np.float32)
        o[:, 1] = np.abs(o[:, 1]) + 1.0
        d = aim - o
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    n = len(o)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 1e4, np.float32)
    t_max[1::16] = -1.0                        # dead
    t_max[2::16] = np.inf                      # the first-iteration window
    t_min[3::16] = np.nan
    t_max[4::16] = 1e30
    t_max[5::16] = t_min[5::16]
    t_min[6::16] = np.nan
    t_max[6::16] = np.inf
    if name == "soup64":                      # the plain loop runs the cap
        t_max[7::16] = np.nan
    rays = ttr.pack_rays(torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(t_min), torch.as_tensor(t_max))
    return tris, rays, 4


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["soup", "cornell", "soup64", "soup1024",
                                  "ties", "axis", "edges"])
@pytest.mark.parametrize("occlusion", [False, True])
def test_cuda_bvh_kernel_matches_plain(case, occlusion):
    """bvh_closest / bvh_any against their plain versions on the same
    inputs: t, u, v, tri and all three stats (node tests, triangle tests,
    root transitions) bit-equal for closest; the occlusion flags equal for
    any hit (its kernel walks in another order, so its counts differ).
    The cases of ``bvh_order_case`` add exact ties, axis-aligned rays,
    shared edges, dead lanes, NaN bounds and t_max = inf."""
    from royaltracer_dx_tpu_torch.ops import bvh as tbvh

    dev = _card()
    if case in ("soup", "cornell"):
        b, rays = _bvh_case(case, dev)
    else:
        tris, rays, ls = bvh_order_case(case)
        b = tbvh.build_lbvh(torch.as_tensor(tris, device=dev), leaf_size=ls)
        rays = rays.to(dev)
    name = "bvh_any" if occlusion else "bvh_closest"
    before = ttr.LAUNCHES[name]
    if occlusion:
        k_occ, _ = ttr.bvh_any(rays, b, stats=True)
        torch.cuda.synchronize()
        p_occ, _ = ttr._any_plain(rays, b)
        assert torch.equal(k_occ, p_occ)
        assert 0 < int(k_occ.sum()) < rays.shape[0]
        assert not bool(k_occ[~(rays[:, 7] > rays[:, 6])].any())
    else:
        k_tuv, k_tri, k_st = ttr.bvh_closest(rays, b, stats=True)
        torch.cuda.synchronize()
        p_tuv, p_tri, p_st = ttr._closest_plain(rays, b)
        assert torch.equal(k_tri, p_tri)
        assert torch.equal(k_tuv.view(torch.int32), p_tuv.view(torch.int32))
        assert torch.equal(k_st, p_st)
        assert int((k_tuv[:, 0] < 1e29).sum()) > 0
    assert ttr.LAUNCHES[name] == before + 1


@pytest.mark.gpu
def test_cuda_bvh_kernels_match_plain_beyond_one_wave():
    """1,100,000 lanes, many times what the persistent warps hold at once
    (every warp takes 32 lanes at a time, again and again), every third
    lane dead: both kernels against their plain versions on a strided
    sample of 11,000 lanes, the closest kernel's stats included, and the
    top-level slab tests of the closest kernel's root scans: at least the
    ones one scan needs (``top_scan_tests``), and one a live lane."""
    from royaltracer_dx_tpu_torch.ops import bvh as tbvh

    dev = _card()
    n = 1_100_000
    tris, o, d, t_max = _scene_and_rays(n, seed=5)
    b = tbvh.build_lbvh(torch.as_tensor(tris, device=dev), leaf_size=4)
    rays = ttr.pack_rays(torch.as_tensor(o, device=dev),
                         torch.as_tensor(d, device=dev), 1e-4,
                         torch.as_tensor(t_max, device=dev))
    tuv, tri, st = ttr.bvh_closest(rays, b, stats=True)
    out = torch.empty_like(tuv), torch.empty_like(tri)
    counters = ttr._launch("bvh_closest", rays, b, out,
                           torch.empty_like(st))
    occ, _ = ttr.bvh_any(rays, b)
    torch.cuda.synchronize()
    assert torch.equal(out[0], tuv) and torch.equal(out[1], tri)
    live = int((rays[:, 7] > rays[:, 6]).sum())
    assert int(counters[0]) >= n and int(counters[1]) >= live
    assert int(counters[1]) >= int(ttr.top_scan_tests(rays, b).sum()) > 0
    idx = torch.arange(0, n, 100, device=dev)
    p_tuv, p_tri, p_st = ttr._closest_plain(rays[idx], b)
    assert torch.equal(tri[idx], p_tri)
    assert torch.equal(tuv[idx].view(torch.int32), p_tuv.view(torch.int32))
    assert torch.equal(st[idx], p_st)
    p_occ, _ = ttr._any_plain(rays[idx], b)
    assert torch.equal(occ[idx], p_occ)
    assert 0 < int(p_occ.sum()) < len(idx)


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


@pytest.mark.gpu
@pytest.mark.parametrize("bvh", [False, True])
def test_cuda_bands_on_two_cards_match_one_card(bvh):
    """A 2-band 96x54 menger frame on cuda:0 and cuda:1 equals the same
    2-band frame with both bands on cuda:0, with the stream kernels and
    with the LBVH kernels: each launch runs on its inputs' card.  Skips
    on a machine with one card."""
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.parallel.shard import ShardedRestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    imgs = []
    for devs in (["cuda:0", "cuda:1"], ["cuda:0", "cuda:0"]):
        scene, camera = menger_scene()
        r = ShardedRestirRenderer(scene, camera, RenderConfig(
            width=96, height=54, use_bvh=bvh), devices=devs)
        r.render()
        imgs.append(r.radiance())
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.0
    np.testing.assert_array_equal(imgs[0], imgs[1])


# ------------------------- the cluster traversal --------------------------


def _cluster_case(dev, tile, group, n, seed=5):
    """Menger(2) clusters built on the card and n box-crossing rays in
    tiles of ``tile``: every seventh lane dead, one NaN t_max (its tile
    retires at once) and one NaN direction."""
    rng = np.random.default_rng(seed)
    v, idx = menger_sponge(2)
    cl = tct.build_clusters(torch.as_tensor(v[idx].astype(np.float32),
                                            device=dev), group=group)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5 + 0.5
    d = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[11, 2] = np.nan
    t_max = np.where(np.arange(n) % 7 == 0, -1.0, 1e4).astype(np.float32)
    t_max[tile + 3] = np.nan
    rows = tct.prepare_rays(torch.as_tensor(o, device=dev),
                            torch.as_tensor(d, device=dev), 1e-4,
                            torch.as_tensor(t_max, device=dev), tile)
    return cl, rows


@pytest.mark.gpu
def test_cuda_cluster_build_matches_cpu():
    """build_clusters on the card equals the CPU build (which the CPU
    tests hold to the JAX build) bit for bit: the centroid is a true
    division by 3 on both."""
    dev = _card()
    tris, _, _, _ = _scene_and_rays(16)
    for group in (128, 32):
        a = tct.build_clusters(torch.as_tensor(tris, device=dev), group)
        b = tct.build_clusters(torch.as_tensor(tris), group)
        for f in ("tri_planes", "tri_index", "aabb_lo", "aabb_hi"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("tile,group", [(128, 128), (96, 128), (32, 64),
                                        (1024, 16)])
def test_cuda_cluster_kernels_match_plain(tile, group):
    """cluster_mask, cluster_closest and cluster_any on the card against
    their plain versions on the same inputs, on whole tiles of 400,003
    rays (beyond one wave of CTAs at every tile size): the mask and entry
    tables, t/u/v, triangle ids, occlusion and the per-tile stats (steps
    and the triangle tests the answer needs) bit-equal, and each launch
    counted once."""
    dev = _card()
    cl, rows = _cluster_case(dev, tile, group, 400003)
    before = dict(tct.LAUNCHES)
    mask, entry = tct.cluster_mask(rows, cl, tile)
    wl, went, count = tct.worklists(mask, entry)
    closest = tct.cluster_closest(rows, cl, wl, went, count, tile,
                                  stats=True)
    occ = tct.cluster_any(rows, cl, wl, count, tile, stats=True)
    torch.cuda.synchronize()
    assert {k: tct.LAUNCHES[k] - before[k] for k in before} == {
        "cluster_mask": 1, "cluster_closest": 1, "cluster_any": 1}
    p_mask, p_entry = tct._mask_plain(rows, cl, tile)
    assert torch.equal(mask, p_mask)
    assert torch.equal(_bits(entry), _bits(p_entry))
    p_closest = tct._phase_b_plain(rows, cl, wl, went, count, tile, False)
    p_occ = tct._phase_b_plain(rows, cl, wl, None, count, tile, True)
    for k, p in zip(closest + occ, p_closest + p_occ):
        assert torch.equal(k, p)
    steps, tests = closest[2][:, 0], closest[2][:, 1]
    assert int((steps < count).sum()) > 0 and int(occ[0].sum()) > 0
    assert (tests <= steps * tile * group).all() and int(tests.sum()) > 0
    assert int((closest[0][:, 0] < 1e30).sum()) > rows.shape[0] // 4


def _bits(x):
    """A tensor's bits: float32 as int32, so that -0.0 and NaN payloads
    count."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.gpu
@pytest.mark.parametrize("tile,group,level", [
    (128, 128, 2), (128, 1, 1), (128, 100, 2), (128, 1024, 2), (96, 128, 2),
    (1024, 128, 2), (1024, 1024, 2)])
def test_cuda_cluster_packing_matches_plain(tile, group, level):
    """cluster_closest and cluster_any on ``cluster_cases.pack_case``'s
    adversarial tiles (every packing width of live rays from 0 to the
    tile, dead rays whose t_max decides the bound, a NaN t_max, tiles
    without a live ray that overlap boxes, exact-t ties within and across
    clusters) against ``_phase_b_plain``: t, u, v, tri, occlusion and the
    per-tile steps and tests bit for bit, from the builds with and
    without stats.  The tiles without a live ray count their steps
    without testing: the ones whose dead rays reach 1e4 walk their whole
    list, the NaN tiles none."""
    from royaltracer_dx_tpu_torch.tools.cluster_cases import pack_case

    dev = _card()
    rows, cl, kinds = pack_case(dev, tile, group, level)
    mask, entry = tct.cluster_mask(rows, cl, tile)
    wl, went, count = tct.worklists(mask, entry)
    before = dict(tct.LAUNCHES)
    closest = tct.cluster_closest(rows, cl, wl, went, count, tile,
                                  stats=True)
    occ = tct.cluster_any(rows, cl, wl, count, tile, stats=True)
    fast = (tct.cluster_closest(rows, cl, wl, went, count, tile)[:2]
            + tct.cluster_any(rows, cl, wl, count, tile)[:1])
    torch.cuda.synchronize()
    assert {k: tct.LAUNCHES[k] - before[k] for k in before} == {
        "cluster_mask": 0, "cluster_closest": 2, "cluster_any": 2}
    p_closest = tct._phase_b_plain(rows, cl, wl, went, count, tile, False)
    p_occ = tct._phase_b_plain(rows, cl, wl, None, count, tile, True)
    for k, p in zip(closest + occ, p_closest + p_occ):
        assert torch.equal(_bits(k), _bits(p))
    for k, p in zip(fast, p_closest[:2] + p_occ[:1]):
        assert torch.equal(_bits(k), _bits(p))
    kinds = np.asarray(kinds)
    steps, tests = closest[2][:, 0].cpu(), closest[2][:, 1].cpu()
    cnt = count.cpu()
    over = torch.as_tensor(kinds == "dead_overlap")
    assert (cnt[over] > 0).all() and torch.equal(steps[over], cnt[over])
    assert (tests[over] == 0).all()
    assert (steps[torch.as_tensor(kinds == "nan_dead")] == 0).all()
    assert int((closest[0][:, 0] < 1e30).sum()) > 0
    assert int(occ[0].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 38, 2073])
@pytest.mark.parametrize("tile", [96, 128, 1024])
def test_cuda_cluster_mask_matches_plain(tile, c):
    """cluster_mask on ``cluster_cases.mask_case``'s adversarial tiles
    (every live count from 0 to the tile, dead rays of every kind, equal
    bounds, -0.0 entries, rays on box faces, zero, tiny, huge and
    non-finite components, non-finite boxes), repeated beyond one wave of
    CTAs, against ``_mask_plain``: mask and entry bit for bit, one launch
    counted."""
    from royaltracer_dx_tpu_torch.tools.cluster_cases import mask_case

    dev = _card()
    reps = max(1, 4096 // (tile + 4))
    rows, cl, _ = mask_case(dev, tile, c, reps)
    before = tct.LAUNCHES["cluster_mask"]
    got = tct.cluster_mask(rows, cl, tile)
    torch.cuda.synchronize()
    assert tct.LAUNCHES["cluster_mask"] - before == 1
    want = tct._mask_plain(rows, cl, tile)
    for k, p in zip(got, want):
        assert torch.equal(_bits(k), _bits(p))
    assert bool(got[0].any()) and not bool(got[0].all())


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["morton", "median_host"])
@pytest.mark.parametrize("occlusion", [False, True])
def test_cuda_stream_kernels_on_other_builds(method, occlusion):
    """The stream kernels on a ``morton`` and a ``median_host`` accel of
    three blocks (not a power of two) equal their plain version, and the
    card's build equals the CPU's."""
    dev = _card()
    tris, o, d, t_max = _scene_and_rays(20000)
    tris = tris[:6000]
    ta = tst.build_stream_accel(torch.as_tensor(tris, device=dev), method)
    cpu = tst.build_stream_accel(torch.as_tensor(tris), method)
    assert ta.num_blocks == 3
    for f in ("perm", "blk_tris", "blk_boxes", "top_lo", "top_hi"):
        assert torch.equal(getattr(ta, f).cpu(), getattr(cpu, f)), f
    rows, wl, went, cnt = tst.prepare_stream(
        torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev), ta,
        1e-4, torch.as_tensor(t_max, device=dev), 16)
    kern = tst.stream_any if occlusion else tst.stream_closest
    k_out = kern(rows, wl, went, cnt, ta.blk_tris, ta.blk_boxes)
    torch.cuda.synchronize()
    p_out = tst._stream_plain(rows, wl, went, cnt, ta.blk_tris, ta.blk_boxes,
                              occlusion)
    for k, p in zip(k_out, p_out):
        assert torch.equal(k, p)
    assert int((k_out[1] >= 0).sum()) > 1000


@pytest.mark.gpu
@pytest.mark.parametrize("case", MXU_CASES)
def test_cuda_mxu_kernels_match_plain(case):
    """mxu_closest and mxu_any (its tests too) equal their plain versions
    bit for bit on tools/mxu_cases.py's adversarial inputs: zero-area and
    duplicated triangles, all misses, non-finite rays, T = 1 and 200, odd
    bounds, rays aimed at vertices and edges, triangles 1e-20 across, a
    soup at an offset of 1e6 with t -> 0; N = 1,001 rays."""
    dev = _card()
    tris, o, d, lo, hi = mxu_case(case, dev)
    mt = tmx.build_mxu_tris(tris)
    before = dict(tmx.LAUNCHES)
    k_c = tmx.mxu_closest(o, d, lo, hi, mt)
    k_a = tmx.mxu_any(o, d, lo, hi, mt, stats=True)
    torch.cuda.synchronize()
    assert tmx.LAUNCHES["mxu_closest"] == before["mxu_closest"] + 1
    assert tmx.LAUNCHES["mxu_any"] == before["mxu_any"] + 1
    p_c = tmx._closest_plain(o, d, lo, hi, mt.coeff, mt.center)
    p_a = tmx._any_plain(o, d, lo, hi, mt.coeff, mt.center, mt.num_tris)
    for k, p in zip((*k_c, *k_a), (*p_c, *p_a)):
        assert k.dtype == p.dtype
        assert torch.equal(_bits(k), _bits(p))
    assert torch.equal(k_c[0] < 1e30, k_a[0])


@pytest.mark.gpu
@pytest.mark.parametrize("closest", [True, False])
def test_cuda_mxu_filter_counts(closest):
    """The counted builds of mxu_closest / mxu_any give the same answers
    and account for every live ray (packed or left to the exact scan) and
    pair: accepted <= kept <= filtered <= live rays x triangles, and, on
    ``non_finite``, some rays on the exact scan."""
    dev = _card()
    tris, o, d, lo, hi = mxu_case("non_finite", dev)
    mt = tmx.build_mxu_tris(tris)
    c = tmx.filter_counts(o, d, lo, hi, mt, closest=closest)
    torch.cuda.synchronize()
    live = int((lo < hi).sum())
    assert c["packed_rays"] + c["exact_rays"] == live
    assert c["exact_rays"] > 0
    assert 0 < c["accepted"] <= c["candidates"] <= c["pairs"]
    assert c["pairs"] <= c["packed_rays"] * mt.num_tris
    if closest:
        assert c["pairs"] == c["packed_rays"] * mt.num_tris


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["near_first", "far_first", "far_only"])
def test_cuda_mxu_hits_beyond_inf(order):
    """Triangles 1.1e30 along x (their coefficients beyond the filter's
    safe range, so every pair of their step is kept) hit by axis rays
    with t_max = inf at t > INF = 1e30: those rays leave the tensor-core
    path for the exact scan, where misses compete at INF (the first
    miss, or the first padded column, wins).  Both kernels equal their
    plain versions bit for bit, and the exact scan ran."""
    dev = _card()

    def tri_at(x):
        return [[x, -5e3, -5e3], [x, 5e3, -5e3], [x, 0.0, 5e3]]

    near = [[0.5, -0.2, -0.2], [0.5, 0.2, -0.2], [0.5, 0.0, 0.3]]
    tris = {"near_first": [near, tri_at(1.1e30), tri_at(-1.1e30)],
            "far_first": [tri_at(1.1e30), near, tri_at(-1.1e30)],
            "far_only": [tri_at(1.1e30)]}[order]
    rng = np.random.default_rng(4)
    n = 1001
    o = np.zeros((n, 3), np.float32)
    o[:, 1:] = rng.uniform(-0.4, 0.4, (n, 2))
    d = np.zeros((n, 3), np.float32)
    d[:, 0] = np.where(np.arange(n) % 5 == 0, -1.0, 1.0)
    hi = np.where(np.arange(n) % 2 == 0, np.inf, 1e4).astype(np.float32)
    o, d, lo, hi = (torch.as_tensor(x, device=dev) for x in (
        o, d, np.full(n, 1e-4, np.float32), hi))
    mt = tmx.build_mxu_tris(torch.as_tensor(np.array(tris, np.float32),
                                            device=dev))
    k_c = tmx.mxu_closest(o, d, lo, hi, mt)
    k_a = tmx.mxu_any(o, d, lo, hi, mt, stats=True)
    counts = tmx.filter_counts(o, d, lo, hi, mt)
    torch.cuda.synchronize()
    p_c = tmx._closest_plain(o, d, lo, hi, mt.coeff, mt.center)
    p_a = tmx._any_plain(o, d, lo, hi, mt.coeff, mt.center, mt.num_tris)
    for k, p in zip((*k_c, *k_a), (*p_c, *p_a)):
        assert torch.equal(_bits(k), _bits(p))
    assert counts["exact_rays"] > 0
    assert bool(k_a[0].any())


# --------------------------- brute-force kernels --------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", BRUTE_CASES)
def test_cuda_brute_kernels_match_plain(case):
    """brute_closest and brute_any (its counted build's tests too) equal
    the plain versions bit for bit on tools/brute_cases.py's inputs: a
    triangle count that is no multiple of the tile, T = 1 and 0, NaN and
    odd bounds, exact ties between duplicated triangles, the 70 x 70 grid
    with rays aimed at vertices and edges, non-finite rays and hits
    beyond INF; N = 10,001 rays."""
    from royaltracer_dx_tpu_torch.ops import intersect as tit

    dev = _card()
    tris, o, d, lo, hi = brute_case(case, dev)
    before = dict(tbt.LAUNCHES)
    k_c = tbt.brute_closest(o, d, lo, hi, tris)
    k_a = tbt.brute_any(o, d, lo, hi, tris, stats=True)
    k_o, _ = tbt.brute_any(o, d, lo, hi, tris)
    torch.cuda.synchronize()
    assert tbt.LAUNCHES["brute_closest"] == before["brute_closest"] + 1
    assert tbt.LAUNCHES["brute_any"] == before["brute_any"] + 2
    h = tit.closest_hit_brute(o, d, tris, lo, hi)
    p_a = (tit.any_hit_brute(o, d, tris, lo, hi),
           tbt.first_hit_tests(o, d, lo, hi, tris))
    for k, p in zip((*k_c, *k_a, k_o), (h.t, h.tri, h.u, h.v, *p_a, p_a[0])):
        assert k.dtype == p.dtype
        assert torch.equal(_bits(k), _bits(p))
    if case not in ("no_tris", "beyond_inf"):
        assert bool((k_c[0] < 1e30).any()) and bool(k_a[0].any())


@pytest.mark.gpu
def test_cuda_cornell_takes_brute_force(tmp_path):
    """The CLI's default scene on the card (32 triangles, traversal
    "auto") and its megakernel frame trace by brute force, as the JAX
    package decides: brute launches, no stream launch."""
    from royaltracer_dx_tpu_torch import cli

    _card()
    for renderer in ("restir", "megakernel"):
        before = dict(tst.LAUNCHES)
        b_before = dict(tbt.LAUNCHES)
        res = cli.main(["--scene", "cornell", "--width", "64", "--height",
                        "64", "--frames", "2", "--renderer", renderer,
                        "--out", str(tmp_path / f"{renderer}.png")])
        torch.cuda.synchronize()
        assert tst.LAUNCHES == before, renderer
        assert all(tbt.LAUNCHES[k] > b_before[k] for k in b_before), renderer
        img = res["renderer"].radiance()
        assert np.isfinite(img).all() and img.mean() > 0


def _brute_batch(kind, dev):
    """(tri_verts, origins, dirs, t_min, t_max) on the card: "sparse" is
    the menger sponge's 4,800 triangles with 64 live rays among 20,000
    lanes (many slices); "dense" a 32-triangle soup with 262,144 live
    rays (one slice)."""
    rng = np.random.default_rng(41)
    if kind == "sparse":
        v, idx = menger_sponge(2)
        tris = v[idx].astype(np.float32)
        n = 20000
        keep = np.zeros(n, bool)
        keep[rng.choice(n, 64, replace=False)] = True
    else:
        c = rng.uniform(-1, 1, (32, 1, 3)).astype(np.float32)
        tris = c + rng.uniform(-0.4, 0.4, (32, 3, 3)).astype(np.float32)
        n = 262144
        keep = np.ones(n, bool)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(keep, 4.0, -1.0).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return (t(tris), t(o), t(d), t(np.full(n, 1e-4, np.float32)),
            t(t_max))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_cuda_brute_slices_match_plain(kind):
    """Both kernels and the counted build bit for bit against the plain
    versions on a batch sparse enough for the device to pick many
    slices (the atomic merge and the last slice's epilogue) and on a
    dense one-slice batch; the plan read back from the launch."""
    from royaltracer_dx_tpu_torch.ops import intersect as tit

    dev = _card()
    tris, o, d, lo, hi = _brute_batch(kind, dev)
    k_c = tbt.brute_closest(o, d, lo, hi, tris)
    k_a = tbt.brute_any(o, d, lo, hi, tris, stats=True)
    k_o, _ = tbt.brute_any(o, d, lo, hi, tris)
    torch.cuda.synchronize()
    h = tit.closest_hit_brute(o, d, tris, lo, hi)
    p_occ = tit.any_hit_brute(o, d, tris, lo, hi)
    p_tests = tbt.first_hit_tests(o, d, lo, hi, tris)
    for k, p in zip((*k_c, *k_a, k_o), (h.t, h.tri, h.u, h.v, p_occ,
                                         p_tests, p_occ)):
        assert k.dtype == p.dtype
        assert torch.equal(_bits(k), _bits(p))
    assert bool((k_c[0] < 1e30).any()) and bool(k_a[0].any())
    live = int((lo < hi).sum())
    for which in ("closest", "any", "any_counted"):
        plan = tbt.launch_plan(which, o, d, lo, hi, tris)
        assert plan["live"] == live
        assert (plan["slices"] > 1) == (kind == "sparse"), (which, plan)
        for r in plan["rounds"]:
            want = tbt.slice_plan(r["live"], r["tri_hi"] - r["tri_lo"],
                                  r["grid"])
            assert r["slices"] == want["slices"], (which, plan)
        assert plan["rounds"][-1]["live"] <= live
        assert plan["rounds"][0]["tri_hi"] in (
            tris.shape[0], min(tris.shape[0], tbt.FIRST_ROUND))


@pytest.mark.gpu
def test_cuda_brute_planes_equal_rows():
    """Planar rays of any stride with scalar or strided bounds (the
    dispatch's inputs, read in place) give the [N, 3] rows' bits."""
    dev = _card()
    for kind in ("sparse", "dense"):
        tris, o, d, lo, hi = _brute_batch(kind, dev)
        rows = torch.cat([o, d, hi[:, None]], dim=1)   # stride 7
        op = tuple(rows[:, c] for c in range(3))
        dp = tuple(rows[:, 3 + c] for c in range(3))
        ref_c = tbt.brute_closest(o, d, lo, hi, tris)
        ref_a = tbt.brute_any(o, d, lo, hi, tris, stats=True)
        for args in ((op, dp, 1e-4, rows[:, 6]),
                     (op, dp, torch.tensor(1e-4, device=dev), hi),
                     (o, d, 1e-4, rows[:, 6])):
            got_c = tbt.brute_closest(*args, tris)
            got_a = tbt.brute_any(*args, tris, stats=True)
            for k, p in zip((*got_c, *got_a), (*ref_c, *ref_a)):
                assert torch.equal(_bits(k), _bits(p))
        h = tbt.closest_hit_brute_traced(op, dp, tris, 1e-4, rows[:, 6])
        assert torch.equal(_bits(h.t), _bits(ref_c[0]))
        assert torch.equal(tbt.any_hit_brute_traced(op, dp, tris, 1e-4, hi),
                           ref_a[0])


@pytest.mark.gpu
def test_cuda_brute_launch_does_not_synchronise():
    """A wrapper call makes no host synchronisation: the live count stays
    on the device (torch.cuda.set_sync_debug_mode raises on one)."""
    dev = _card()
    tris, o, d, lo, hi = _brute_batch("sparse", dev)
    op = tuple(o[:, c] for c in range(3))
    dp = tuple(d[:, c] for c in range(3))
    tbt.brute_closest(o, d, lo, hi, tris)     # builds the library
    torch.cuda.synchronize()
    before = dict(tbt.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        tbt.brute_closest(o, d, lo, hi, tris)
        tbt.brute_any(o, d, lo, hi, tris, stats=True)
        tbt.closest_hit_brute_traced(op, dp, tris, 1e-4, hi)
        tbt.any_hit_brute_traced(op, dp, tris, 1e-4, hi)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tbt.LAUNCHES["brute_closest"] == before["brute_closest"] + 2
    assert tbt.LAUNCHES["brute_any"] == before["brute_any"] + 2


# seeds whose counter-0 draw ends in v0 = 2^32 - 1 and 2^32 - 100, both
# rounding to u == 1.0 in float32 (test_torch_rng_camera.py's _untea of
# (0xFFFFFFFF, 12345) and (0xFFFFFF9C, 777))
_TEA_ONES = [(0x5F68E92F, 0x99EF495C), (0xB4C21448, 0xE40E44B5)]


def _tea_seeds(shape, dev):
    """int64 [*shape, 2] uint32 words, the last two lanes _TEA_ONES."""
    s = np.random.default_rng(sum(shape) + 7).integers(
        0, 2**32, (*shape, 2), dtype=np.int64)
    if s.size >= 4:
        s.reshape(-1, 2)[-2:] = _TEA_ONES
    return torch.as_tensor(s, device=dev)


def _same(got, want):
    assert got.device.type == "cuda" and got.shape == want.shape
    assert got.dtype == want.dtype
    assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4099,), (37, 53), (3, 1031)])
def test_cuda_tea_draws_match_plain(shape):
    """The TEA kernel against the plain form on the CPU, bit for bit, for
    every entry point: leading shapes [N], [H, W] and [M, N], n in {1, 2,
    3, 18, 30}, counters up to 2^31 - 1 and beyond 2^32, draws that round
    to exactly 1.0; one launch a call."""
    dev = _card()
    seed = _tea_seeds(shape, dev)
    cpu = seed.cpu()
    before = trng.LAUNCHES["tea"]
    calls = 0
    u, s = trng.tea_random(seed)
    pu, ps = trng.tea_random(cpu)
    _same(u, pu)
    _same(s, ps)
    assert bool((u.reshape(-1)[-2:] == 1.0).all())
    calls += 1
    for n in (1, 2, 3, 18, 30):
        for fn in (trng.tea_batch, trng.tea_batch_major):
            u, s = fn(seed, n)
            pu, ps = fn(cpu, n)
            _same(u, pu)
            _same(s, ps)
            calls += 1
    for i in (0, 1, 2, 17, 29, 2**31 - 1, 2**32 + 7):
        _same(trng.tea_batch_at(seed, i), trng.tea_batch_at(cpu, i))
        calls += 1
    u, s = trng.tea_randoms(seed, 3)
    pu, ps = trng.tea_randoms(cpu, 3)
    _same(u, pu)
    _same(s, ps)
    calls += 3
    torch.cuda.synchronize()
    assert trng.LAUNCHES["tea"] - before == calls


@pytest.mark.gpu
def test_cuda_tea_draws_edge_inputs():
    """Empty batches launch nothing; n = 0 still advances the seed (one
    launch); a strided and an 8-byte-offset seed give the contiguous
    seed's bits; a seed that is not int64 [..., 2] raises."""
    dev = _card()
    before = trng.LAUNCHES["tea"]
    for shape in ((0,), (5, 0)):
        seed = _tea_seeds(shape, dev)
        u, s = trng.tea_batch(seed, 3)
        assert u.shape == (*shape, 3) and s.shape == (*shape, 2)
        assert trng.tea_batch_at(seed, 4).shape == shape
        u, s = trng.tea_random(seed)
        assert u.shape == shape and s.shape == (*shape, 2)
    assert trng.LAUNCHES["tea"] == before
    seed = _tea_seeds((1000,), dev)
    for fn in (trng.tea_batch, trng.tea_batch_major):
        u, s = fn(seed, 0)
        pu, ps = fn(seed.cpu(), 0)
        _same(u, pu)
        _same(s, ps)
    assert trng.LAUNCHES["tea"] == before + 2
    strided = torch.stack([seed[:, 0], seed[:, 1]], dim=0).t()
    assert not strided.is_contiguous()
    buf = torch.empty(2 * 1000 + 1, dtype=torch.int64, device=dev)
    offset = buf[1:].view(1000, 2)
    offset.copy_(seed)
    assert offset.data_ptr() % 16 == 8
    want_u, want_s = trng.tea_batch(seed.cpu(), 18)
    for x in (strided, offset):
        u, s = trng.tea_batch(x, 18)
        _same(u, want_u)
        _same(s, want_s)
        _same(trng.tea_batch_at(x, 5), trng.tea_batch_at(seed.cpu(), 5))
    for bad in (seed.to(torch.int32), seed[:, :1]):
        with pytest.raises(ValueError):
            trng.tea_random(bad)


@pytest.mark.gpu
def test_cuda_tea_draws_do_not_synchronise():
    """No entry point waits for the device (set_sync_debug_mode raises on
    a host synchronisation)."""
    dev = _card()
    seed = _tea_seeds((2048,), dev)
    trng.tea_random(seed)                   # builds the library
    torch.cuda.synchronize()
    before = trng.LAUNCHES["tea"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        trng.tea_random(seed)
        trng.tea_batch(seed, 18)
        trng.tea_batch_major(seed, 30)
        trng.tea_batch_at(seed, 7)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert trng.LAUNCHES["tea"] == before + 4


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [2, 3])
def test_cuda_frames_with_tea_kernel_match_plain(levels, monkeypatch):
    """Two 256x144 menger frames, flat (level 2: 4,802 triangles) and
    windowed (level 3: presorted stream traces, GI compaction), give the
    same state bit for bit with the TEA kernel and with the plain form
    run on the card in its place; each RNG call of a frame is one
    launch, and every seed it hands the kernel is contiguous and 16-byte
    aligned (no copy)."""
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    _card()
    calls = []

    def plain(seed):
        calls.append((seed.dim(), seed.shape[0], seed.is_contiguous(),
                      seed.data_ptr() % 16))
        return False

    states, launches = [], []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(trng, "_takes_kernel", plain)
        scene, camera = menger_scene(levels=levels)
        r = RestirRenderer(scene, camera,
                           RenderConfig(width=256, height=144))
        before = trng.LAUNCHES["tea"]
        r.render()
        r.render()
        torch.cuda.synchronize()
        launches.append(trng.LAUNCHES["tea"] - before)
        states.append(r.state_dict())
    assert launches[1] == 0
    assert launches[0] == len(calls) > 0
    assert all(c[0] == 2 and c[1] > 0 and c[2] and c[3] == 0 for c in calls)
    for k, v in states[1].items():
        np.testing.assert_array_equal(states[0][k], v, err_msg=k)


def _pick_cdf(l_count, kind, dev):
    """A float32 [L] CDF: "sorted" as scene/lights.py builds it (a
    normalised cumulative sum, the last forced to 1, a fifth of the
    lights of weight 0, so values repeat), "unsorted" random values,
    "nan" a sorted one with a NaN in it."""
    g = np.random.default_rng(l_count + 17)
    w = g.uniform(0.1, 2.0, l_count) * (g.uniform(0, 1, l_count) > 0.2)
    w[0] = 1.0
    c = np.cumsum(w / w.sum()).astype(np.float32)
    c[-1] = 1.0
    if kind == "unsorted":
        c = g.uniform(0, 1, l_count).astype(np.float32)
    elif kind == "nan" and l_count > 2:
        c[l_count // 2] = np.nan
    return torch.as_tensor(c, device=dev)


def _pick_u(shape, cdf, dev):
    """float32 u of ``shape``: uniform, its first lanes 0, -0, 1, NaN,
    inf, every CDF value and both its float neighbours."""
    g = torch.Generator(device=dev).manual_seed(int(np.prod(shape)) + 3)
    u = torch.rand(shape, generator=g, device=dev)
    flat = u.view(-1)
    special = torch.cat([
        torch.tensor([0.0, -0.0, 1.0, float("nan"), float("inf")],
                     device=dev),
        cdf, torch.nextafter(cdf, torch.zeros_like(cdf)),
        torch.nextafter(cdf, torch.full_like(cdf, 2.0))])
    k = min(flat.numel(), special.numel())
    flat[:k] = special[:k]
    return u


def _pick_plain(table, cdf, u, monkeypatch):
    """The plain form run on the card (``_takes_kernel`` patched)."""
    with monkeypatch.context() as m:
        m.setattr(tls, "_takes_kernel", lambda _u: False)
        return tls.select_light_records(table, cdf, u)


def _same_planes(got, want, shape):
    assert len(got) == len(want) == tls.RECORD
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == shape, k
        assert a.is_contiguous(), k
        assert torch.equal(_bits(a), _bits(b)), k


@pytest.mark.gpu
@pytest.mark.parametrize("l_count", [1, 2, 384, 5003])
def test_cuda_light_pick_matches_plain(l_count, monkeypatch):
    """The light-pick kernel against the plain form run on the card, bit
    for bit, on the frame's 2,073,600 lanes (0, 1, NaN and every CDF value
    among them), on a candidate-major strided [M, N] view (``us[0::3]``
    of ``nee_candidates_p``) and on empty batches; one launch a call that
    has lanes, 16 contiguous planes."""
    dev = _card()
    cdf = _pick_cdf(l_count, "sorted", dev)
    table = torch.randn((l_count, tls.RECORD), device=dev)
    before = tls.LAUNCHES["light_pick"]
    u = _pick_u((1920 * 1080,), cdf, dev)
    _same_planes(tls.select_light_records(table, cdf, u),
                 _pick_plain(table, cdf, u, monkeypatch), u.shape)
    us = _pick_u((3 * 4, 4099), cdf, dev)
    view = us[0::3]
    assert not view.is_contiguous()
    _same_planes(tls.select_light_records(table, cdf, view),
                 _pick_plain(table, cdf, view, monkeypatch), view.shape)
    for shape in ((0,), (4, 0)):
        e = torch.empty(shape, device=dev)
        _same_planes(tls.select_light_records(table, cdf, e),
                     _pick_plain(table, cdf, e, monkeypatch), e.shape)
    torch.cuda.synchronize()
    assert tls.LAUNCHES["light_pick"] - before == 2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "nan"])
@pytest.mark.parametrize("l_count", [3, 384, 4097, 4098, 9000])
def test_cuda_light_pick_edge_cdfs(kind, l_count, monkeypatch):
    """Repeated CDF values, a CDF out of order and one holding a NaN (the
    kernel's count-every-value path), and CDFs one value over a staged
    tile (4,097 lights: 4,096 values counted) and beyond: bit-equal to the
    plain form on u at 0, 1, NaN, inf, each CDF value and its
    neighbours; a transposed u (copied to fold) too."""
    dev = _card()
    cdf = _pick_cdf(l_count, kind, dev)
    table = torch.randn((l_count, tls.RECORD), device=dev)
    u = _pick_u((4 * l_count + 77,), cdf, dev)
    _same_planes(tls.select_light_records(table, cdf, u),
                 _pick_plain(table, cdf, u, monkeypatch), u.shape)
    t = _pick_u((3, 5, 2 * l_count + 1), cdf, dev).transpose(0, 2)
    assert tls._fold(t) is None
    _same_planes(tls.select_light_records(table, cdf, t),
                 _pick_plain(table, cdf, t, monkeypatch), t.shape)


@pytest.mark.gpu
def test_cuda_light_pick_checks_and_does_not_synchronise():
    """No host wait in a pick (set_sync_debug_mode raises on one); a table
    or CDF on another device, or of another dtype, raises."""
    dev = _card()
    cdf = _pick_cdf(384, "sorted", dev)
    table = torch.randn((384, tls.RECORD), device=dev)
    u = _pick_u((1 << 16,), cdf, dev)
    tls.select_light_records(table, cdf, u)         # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tls.select_light_records(table, cdf, u)
        tls.select_light_records(table, cdf, u.view(256, 256)[::2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for args in ((table.cpu(), cdf, u), (table, cdf.cpu(), u),
                 (table.half(), cdf, u), (table, cdf, u.double())):
        with pytest.raises(ValueError):
            tls.select_light_records(*args)


def _pick_frames(scene_fn, monkeypatch, animate=False):
    """Two 256x144 frames of ``scene_fn()``'s scene (``animate``: instance
    1 moved and ``update()`` between them), with the light-pick kernel
    and with the plain form run on the card in its place: the states and
    the kernel's launches of each run."""
    from royaltracer_dx_tpu_torch.camera import Camera
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer

    states, launches = [], []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(tls, "_takes_kernel", lambda _u: False)
        scene, camera = scene_fn()
        r = RestirRenderer(scene, camera or Camera(eye=(0.5, 0.5, 1.72),
                                                   center=(0.5, 0.5, 0.0)),
                           RenderConfig(width=256, height=144))
        before = tls.LAUNCHES["light_pick"]
        r.render()
        if animate:
            scene.set_transform(1, np.array(
                [[1, 0, 0, 0.3], [0, 1, 0, 0.35], [0, 0, 1, 0.3],
                 [0, 0, 0, 1]], np.float32)
                @ np.diag([0.2, 0.2, 0.2, 1.0]).astype(np.float32))
            r.update()
        r.render()
        torch.cuda.synchronize()
        launches.append(tls.LAUNCHES["light_pick"] - before)
        states.append(r.state_dict())
    return states, launches


def _two_cornells():
    scene = tproc.cornell_box(emission=18.0)
    scene.add_instance(0, np.diag([0.2, 0.2, 0.2, 1.0]).astype(np.float32))
    return scene, None


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["atrium", "animated"])
def test_cuda_frames_with_light_pick_kernel_match_plain(case, monkeypatch):
    """Two 256x144 frames give the same state bit for bit with the
    light-pick kernel and with the plain form in its place: a hall of 192
    lamps (384 emissive triangles, the atrium's count), and two Cornell
    boxes, the lit inner one moved with ``update()`` between the frames
    (the second frame picks from the new arrays' table).  16 launches a
    frame (4 DI candidates, 4 a GI bounce x 3)."""
    from royaltracer_dx_tpu_torch import cli

    _card()
    if case == "atrium":
        states, launches = _pick_frames(
            lambda: (tproc.many_lights(n_lights=192),
                     cli.build_scene("many_lights")[1]), monkeypatch)
    else:
        states, launches = _pick_frames(_two_cornells, monkeypatch,
                                        animate=True)
    assert launches == [32, 0]
    for k, v in states[1].items():
        np.testing.assert_array_equal(states[0][k], v, err_msg=k)
