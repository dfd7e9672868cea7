"""The port's stream traversal against the JAX package.

The accel build must be exact (it is integer sorting and min/max of the
same float32 inputs).  The kernels' plain versions are held against the
JAX Pallas kernel, run in interpret mode as tests/test_stream.py runs it,
and against brute force: t within 1e-5 (the JAX side is compiled by
XLA-CPU, which contracts products into FMAs, so t/u/v may differ by an
ulp or two), equal triangle ids except on exact-t ties, identical
occlusion, and masked lanes never occluded.  The CUDA kernels themselves
only run on a card: tests/test_torch_cuda.py holds them against the
plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.ops import intersect as jit_
from royaltracer_dx_tpu.ops import stream_trace as jst
from royaltracer_dx_tpu.scene.procedural import menger_sponge as j_menger

from royaltracer_dx_tpu_torch import convert
from royaltracer_dx_tpu_torch.ops import intersect as tit
from royaltracer_dx_tpu_torch.ops import stream_trace as tst


def soup(t, seed=7):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (t, 1, 3)).astype(np.float32)
    e = rng.uniform(-0.08, 0.08, (t, 3, 3)).astype(np.float32)
    return c + e


def menger_tris(levels=2):
    v, idx = j_menger(levels)
    return v[idx].astype(np.float32)


def rays(n, seed=3, spread=1.5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def t_(a):
    return torch.as_tensor(np.asarray(a))


def tie_lanes(o, d, tris, t_min=1e-4, t_max=1e4):
    """Lanes whose closest t is shared by two triangles (the slot there
    depends on visiting order)."""
    t, _, _ = tit._mt_chunk_planar(
        tuple(t_(o[:, c])[:, None] for c in range(3)),
        tuple(t_(d[:, c])[:, None] for c in range(3)),
        tuple(t_(tris[:, 0, c]) for c in range(3)),
        tuple(t_(tris[:, 1, c] - tris[:, 0, c]) for c in range(3)),
        tuple(t_(tris[:, 2, c] - tris[:, 0, c]) for c in range(3)),
        t_min, t_max)
    t = t.numpy()
    best = t.min(axis=1, keepdims=True)
    near = np.abs(t - best) <= 1e-6 * np.maximum(1.0, np.abs(best))
    return (near & (t < 1e29)).sum(axis=1) > 1


# ------------------------------- build -----------------------------------


@pytest.mark.parametrize("tris", [soup(700), soup(9000), menger_tris()],
                         ids=["soup700", "soup9000", "menger"])
def test_accel_build_exact(tris):
    ja = jst.build_stream_accel(jnp.asarray(tris))
    ta = tst.build_stream_accel(t_(tris))
    for f in ("perm", "blk_tris", "blk_boxes", "top_lo", "top_hi"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    # the converter carries a JAX accel over unchanged
    ca = convert.stream_accel_from_numpy(
        {f: np.asarray(getattr(ja, f)) for f in
         ("blk_tris", "blk_boxes", "top_lo", "top_hi", "perm")}, device="cpu")
    assert ca.perm.dtype == torch.int32
    assert torch.equal(ca.blk_tris, ta.blk_tris)


# ------------------------- plain version vs JAX --------------------------


@pytest.mark.parametrize("tris", [soup(900), menger_tris(1)],
                         ids=["soup900", "menger1"])
def test_plain_closest_matches_pallas_and_brute(tris):
    o, d = rays(300)
    ja = jst.build_stream_accel(jnp.asarray(tris))
    ta = tst.build_stream_accel(t_(tris))
    jh = jst.closest_hit_stream(jnp.asarray(o), jnp.asarray(d), ja)
    th = tst.closest_hit_stream(t_(o), t_(d), ta)
    bh = tit.closest_hit_brute(t_(o), t_(d), t_(tris))
    jt, tt = np.asarray(jh.t), th.t.numpy()
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt, bh.t.numpy(), rtol=1e-5, atol=1e-5)
    hit = tt < 1e29
    assert hit.sum() >= 20
    ties = tie_lanes(o, d, tris)
    keep = hit & ~ties
    np.testing.assert_array_equal(th.tri.numpy()[keep],
                                  np.asarray(jh.tri)[keep])
    np.testing.assert_array_equal(th.tri.numpy()[keep], bh.tri.numpy()[keep])
    np.testing.assert_allclose(th.u.numpy()[hit], np.asarray(jh.u)[hit],
                               atol=1e-5)


def test_plain_any_hit_matches_pallas_with_masked_lanes():
    tris = soup(900, seed=11)
    o, d = rays(300, seed=5)
    ja = jst.build_stream_accel(jnp.asarray(tris))
    ta = tst.build_stream_accel(t_(tris))
    t_min = np.full(300, 1e-4, np.float32)
    # every other lane masked (t_max < t_min), like dead shadow lanes
    t_max = np.where(np.arange(300) % 2 == 0, 2.0, -1.0).astype(np.float32)
    jo = np.asarray(jst.any_hit_stream(jnp.asarray(o), jnp.asarray(d), ja,
                                       jnp.asarray(t_min), jnp.asarray(t_max)))
    to = tst.any_hit_stream(t_(o), t_(d), ta, t_(t_min), t_(t_max)).numpy()
    bo = tit.any_hit_brute(t_(o), t_(d), t_(tris), t_(t_min),
                           t_(t_max)).numpy()
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(to, bo)
    assert not to[1::2].any()
    assert to[0::2].any()


def test_many_block_worklists_and_early_exit():
    """8 blocks with wb=1: the worklist widens to every block
    (wb_eff = max(wb, num_blocks)) and chunks walk several blocks.  Rays
    facing a wall in front of the soup stop after the wall's block: the
    closest-hit early exit skips blocks whose entry lies beyond every
    ray's best t."""
    wall = np.asarray([[[-4, -4, -2], [4, -4, -2], [4, 4, -2]],
                       [[-4, -4, -2], [4, 4, -2], [-4, 4, -2]]], np.float32)
    tris = np.concatenate([soup(4 * tst.S * tst.G + 11, seed=2), wall])
    ta = tst.build_stream_accel(t_(tris))
    assert ta.num_blocks == 8
    o, d = rays(640, seed=9, spread=0.5)
    rng = np.random.default_rng(4)
    fo = np.concatenate([rng.uniform(-0.5, 0.5, (256, 2)),
                         np.full((256, 1), -3.0)], 1).astype(np.float32)
    fd = np.concatenate([rng.uniform(-0.05, 0.05, (256, 2)),
                         np.ones((256, 1))], 1).astype(np.float32)
    fd /= np.linalg.norm(fd, axis=1, keepdims=True)
    o, d = np.concatenate([o, fo]), np.concatenate([d, fd])
    n = o.shape[0]
    rows, wl, went, cnt = tst.prepare_stream(t_(o), t_(d), ta, 1e-4, 1e4,
                                             wb=1)
    assert wl.shape[1] == 8
    _, slot, stats = tst.stream_closest(rows, wl, went, cnt, ta.blk_tris,
                                        ta.blk_boxes)
    assert stats.shape == (cnt.shape[0], 3)
    visited = stats[:, 0]
    assert (stats[:, 2] >= stats[:, 1]).all()        # pairs >= hot clusters
    assert (visited[:5] > 1).any()
    assert (visited[5:] < cnt[5:]).all()             # early exit taken
    th = tst.closest_hit_stream(t_(o), t_(d), ta, wb=1)
    jb = jit_.closest_hit_brute(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tris))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jb.t), rtol=1e-5,
                               atol=1e-5)
    hit = th.t.numpy() < 1e29
    np.testing.assert_array_equal(th.tri.numpy()[hit],
                                  np.asarray(jb.tri)[hit])
    t_min = torch.full((n,), 1e-4)
    t_max = torch.full((n,), 0.3)
    occ = tst.any_hit_stream(t_(o), t_(d), ta, t_min, t_max, wb=1)
    bo = tit.any_hit_brute(t_(o), t_(d), t_(tris), t_min, t_max)
    assert torch.equal(occ, bo)
    assert 0 < int(occ.sum()) < n


def test_padding_lanes_never_hit():
    tris = soup(300)
    ta = tst.build_stream_accel(t_(tris))
    o, d = rays(130)
    rows, wl, went, cnt = tst.prepare_stream(t_(o), t_(d), ta, 0.0, 1e4, 16)
    assert rows.shape[0] == 256
    tuv, slot, _ = tst.stream_closest(rows, wl, went, cnt, ta.blk_tris,
                                      ta.blk_boxes)
    assert (slot[130:] == -1).all()
    _, occ, _ = tst.stream_any(rows, wl, went, cnt, ta.blk_tris,
                               ta.blk_boxes)
    # padding lanes carry t_max = -1: the t=0 encoding marks them, and the
    # liveness mask of any_hit_stream keeps them unoccluded
    assert (rows[130:, 7] < rows[130:, 6]).all()


def test_wrapper_checks_inputs():
    ta = tst.build_stream_accel(t_(soup(100)))
    o, d = rays(128)
    rows, wl, went, cnt = tst.prepare_stream(t_(o), t_(d), ta, 1e-4, 1e4, 16)
    with pytest.raises(ValueError):
        tst.stream_closest(rows.double(), wl, went, cnt, ta.blk_tris,
                           ta.blk_boxes)
    with pytest.raises(ValueError):
        tst.stream_any(rows, wl.long(), went, cnt, ta.blk_tris, ta.blk_boxes)
    with pytest.raises(ValueError):
        tst.stream_closest(rows[:100], wl, went, cnt, ta.blk_tris,
                           ta.blk_boxes)
