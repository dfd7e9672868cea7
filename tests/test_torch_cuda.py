"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

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
