"""The stream kernels' third stat and the plain version on sparse and
ragged batches.

The plain PyTorch version is what the CUDA kernels are held to on the
card, so it is held here to independent counts and to brute force on the
batches that exercise a kernel's edges: few valid lanes, chunks with an
empty worklist, a single chunk, a worklist wider than the accel.
Integers and slots must be exact; t is within 1e-5 of brute force, as in
tests/test_stream.py.  Stats columns 0-1 are held against the JAX
Pallas kernel's output columns 4-5 in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.ops import stream_trace as jst

from royaltracer_dx_tpu_torch.ops import intersect as tit
from royaltracer_dx_tpu_torch.ops import stream_trace as tst

R = tst.RAYS_PER_CHUNK


def soup(t, seed=7):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (t, 1, 3)).astype(np.float32)
    e = rng.uniform(-0.08, 0.08, (t, 3, 3)).astype(np.float32)
    return c + e


def rays(n, seed=3, spread=1.5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def t_(a):
    return torch.as_tensor(np.asarray(a))


def numpy_pairs_closest(rows, wl, went, cnt, blk_tris, blk_boxes):
    """An independent float32 numpy walk of the closest-hit kernel, ray by
    ray and triangle by triangle, that counts per chunk the blocks
    visited, the hot clusters and the ray-cluster candidate pairs."""
    f = np.float32
    rows, wl, went, cnt = (np.asarray(x) for x in (rows, wl, went, cnt))
    tris, boxes = np.asarray(blk_tris), np.asarray(blk_boxes)
    chunks = rows.shape[0] // R
    stats = np.zeros((chunks, 3), np.int64)
    for ch in range(chunks):
        rr = rows[ch * R:(ch + 1) * R]
        o, d, t_min = rr[:, 0:3], rr[:, 3:6], rr[:, 6]
        valid = rr[:, 8] > 0.5
        tbest = rr[:, 7].copy()
        with np.errstate(divide="ignore", over="ignore"):
            inv = np.where(np.abs(d) > 1e-20, f(1.0) / d,
                           np.where(d >= 0, f(1e30), f(-1e30))).astype(f)
        for w in range(int(cnt[ch])):
            if not went[ch, w] < np.max(np.where(valid, tbest, f(0.0))):
                break
            b = wl[ch, w]
            lo, hi = boxes[b, 0:3, :tst.S], boxes[b, 3:6, :tst.S]   # [3, S]
            with np.errstate(over="ignore", invalid="ignore"):
                t0 = lo[None] * inv[:, :, None] - (o * inv)[:, :, None]
                t1 = hi[None] * inv[:, :, None] - (o * inv)[:, :, None]
            tn = np.maximum(t_min[:, None], np.minimum(t0, t1).max(axis=1))
            tf = np.minimum(tbest[:, None], np.maximum(t0, t1).min(axis=1))
            cand = (tn <= tf) & valid[:, None]                      # [R, S]
            stats[ch, 0] += 1
            stats[ch, 1] += int(cand.any(axis=0).sum())
            stats[ch, 2] += int(cand.sum())
            for r, s in zip(*np.nonzero(cand)):
                p = tris[b, s * 9:(s + 1) * 9, :].astype(np.float64)
                v0, e1, e2 = p[0:3].T, p[3:6].T, p[6:9].T
                pv = np.cross(d[r].astype(np.float64), e2)
                det = (e1 * pv).sum(-1)
                ok = np.abs(det) > 1e-12
                idet = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
                tv = o[r].astype(np.float64) - v0
                u = (tv * pv).sum(-1) * idet
                q = np.cross(tv, e1)
                v = (d[r] * q).sum(-1) * idet
                t = (e2 * q).sum(-1) * idet
                hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1)
                       & (t > t_min[r]) & (t < tbest[r]))
                if hit.any():
                    tbest[r] = f(t[hit].min())
    return stats


def hand_case():
    """2 blocks of soup, 3 chunks: 300 rays, every third lane masked."""
    tris = soup(tst.S * tst.G + 500, seed=21)
    ta = tst.build_stream_accel(t_(tris))
    assert ta.num_blocks == 2
    o, d = rays(300, seed=12, spread=1.2)
    t_max = np.where(np.arange(300) % 3 == 0, -1.0, 1e4).astype(np.float32)
    rows, wl, went, cnt = tst.prepare_stream(t_(o), t_(d), ta, 1e-4,
                                             t_(t_max), 16)
    rows[:300, 8] = t_((np.arange(300) % 3 != 0).astype(np.float32))
    return tris, ta, (rows, wl, went, cnt, ta.blk_tris, ta.blk_boxes)


def test_third_stat_equals_numpy_pair_count():
    _, ta, args = hand_case()
    _, slot, stats = tst.stream_closest(*args)
    assert stats.shape == (3, 3) and stats.dtype == torch.int32
    want = numpy_pairs_closest(*args)
    # the numpy walk runs Moller-Trumbore in float64, so a best-t may
    # differ by an ulp; the counts it feeds are integers of slab tests
    # that such a difference can flip only on a box face (none here)
    np.testing.assert_array_equal(stats.numpy(), want)
    assert int(stats[:, 2].sum()) > int(stats[:, 1].sum()) > 0
    # masked lanes add no pairs: with every lane masked there are none
    rows = args[0].clone()
    rows[:, 8] = 0.0
    _, slot0, stats0 = tst.stream_any(rows, *args[1:])
    assert int(stats0[:, 1:].sum()) == 0 and int(stats0[:, 0].sum()) == 0
    # (dead lanes, t_max < t_min, read as the t=0 encoding: any_hit_stream
    # masks them by liveness)
    assert (slot0[rows[:, 7] > rows[:, 6]] == -1).all()


def _sparse_cases():
    n = 1024
    lane = np.arange(n)
    every = np.ones(n, bool)
    odd_chunks = (np.arange(n // R) % 2 == 1)
    return {
        "one_in_16": dict(keep=lane % 16 == 0),
        "one_per_chunk": dict(keep=lane % R == 77),
        "empty_worklists": dict(keep=every, empty=odd_chunks),
        "single_chunk": dict(keep=every[:100], n=100),
        "wb_wider_than_accel": dict(keep=every, wb=64),
    }


@pytest.mark.parametrize("case", list(_sparse_cases()))
def test_plain_matches_brute_on_sparse_batches(case):
    spec = _sparse_cases()[case]
    tris = soup(2 * tst.S * tst.G + 300, seed=5)
    ta = tst.build_stream_accel(t_(tris))
    assert ta.num_blocks == 4
    n = spec.get("n", 1024)
    o, d = rays(n, seed=17, spread=1.2)
    keep = t_(spec["keep"])
    live = keep.clone()
    bh = tit.closest_hit_brute(t_(o), t_(d), t_(tris), 1e-4, 1e4)
    bo = tit.any_hit_brute(t_(o), t_(d), t_(tris), 1e-4,
                           torch.full((n,), 0.6))
    for occ, t_far in ((False, 1e4), (True, 0.6)):
        t_max = torch.where(keep, t_far, -1.0)
        rows, wl, went, cnt = tst.prepare_stream(t_(o), t_(d), ta, 1e-4,
                                                 t_max, spec.get("wb", 16))
        assert wl.shape[1] == max(spec.get("wb", 16), 4)
        rows[:n, 8] = keep.float()
        if "empty" in spec:
            cnt[t_(spec["empty"])] = 0
            live = keep & ~t_(spec["empty"]).repeat_interleave(R)[:n]
        kern = tst.stream_any if occ else tst.stream_closest
        tuv, slot, stats = kern(rows, wl, went, cnt, ta.blk_tris,
                                ta.blk_boxes)
        assert stats.shape == (rows.shape[0] // R, 3)
        # any-hit: a dead lane (t_max < t_min) carries the t=0 encoding,
        # and the liveness mask of any_hit_stream keeps it unoccluded
        found = (slot >= 0) & (rows[:, 7] > rows[:, 6])
        assert not found[:n][~live].any()
        assert not found[n:].any()
        assert (stats[cnt == 0] == 0).all()
        found = found[:n]
        if occ:
            assert torch.equal(found[live], bo[live])
            assert 0 < int(found.sum())
            continue
        k_t = torch.where(found, tuv[:n, 0], tit.INF)
        np.testing.assert_allclose(k_t[live].numpy(), bh.t[live].numpy(),
                                   rtol=1e-5, atol=1e-5)
        tri = ta.perm[slot[:n].clamp_min(0).long()].long()
        hit = live & found
        assert int(hit.sum()) > 0
        assert torch.equal(tri[hit], bh.tri[hit])
        # every valid ray of a visited block is counted once per candidate
        assert int(stats[:, 2].sum()) >= int(hit.sum())


@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "any"])
def test_stats_match_pallas_columns(occlusion):
    """Blocks visited and clusters tested against the JAX kernel's output
    columns 4-5 (interpret mode), on a 4-block soup with short rays for
    the any-hit mode; the third stat has no JAX counterpart."""
    tris = soup(2 * tst.S * tst.G + 300, seed=5)
    o, d = rays(512, seed=23, spread=1.2)
    ja = jst.build_stream_accel(jnp.asarray(tris))
    ta = tst.build_stream_accel(t_(tris))
    t_max = 0.5 if occlusion else 1e4
    rows, wl, went, cnt = tst.prepare_stream(t_(o), t_(d), ta, 1e-4, t_max,
                                             16)
    jout = np.asarray(jst._trace_stream(jnp.asarray(o), jnp.asarray(d), ja,
                                        1e-4, t_max, occlusion, 16))
    kern = tst.stream_any if occlusion else tst.stream_closest
    _, _, stats = kern(rows, wl, went, cnt, ta.blk_tris, ta.blk_boxes)
    jstats = jout.reshape(-1, R, jout.shape[-1])[:, 0, 4:6]
    assert jstats.shape == (4, 2)
    np.testing.assert_array_equal(stats[:, :2].numpy(),
                                  jstats.astype(np.int64))
    assert int(stats[:, 2].sum()) >= int(stats[:, 1].sum()) > 0
