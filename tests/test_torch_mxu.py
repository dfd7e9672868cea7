"""The port's matmul-form tracer (royaltracer_dx_tpu_torch/ops/mxu_trace.py)
against the JAX package's closest_hit_mxu / any_hit_mxu, on the CPU.

The cases are tests/test_mxu_trace.py's (same sizes and seeds): a random
soup, an off-centre scene at offset 50, masked shadow lanes, degenerate
triangles and more than one 4096-ray chunk; then the coefficients carried
across (``convert.mxu_tris_from_numpy``) and the miss and tie semantics.

Tolerances, as measured here: the port sums each bilinear form over its
nonzero rows in a fixed order and XLA-CPU's dot in its own (with fused
multiply-adds), so the two agree to a tolerance, not to bits:

* hit / miss state and triangle ids equal on >= 0.999 of the rays
  (measured: all of them);
* t within 3e-6 max(1, |t|) where both hit the same triangle (measured
  1.3e-6; relative to t alone the error grows as t -> 0, where o.n and
  v0.n cancel: 4.3e-5 measured at t = 0.0017, and JAX's own matmul form
  is 6.6e-5 from brute force there);
* u, v within 2e-5 there (measured 1.0e-5; test_mxu_trace.py's bar
  against brute force is 2e-4);
* coefficients (the port's build against JAX's) within one unit in the
  last place of the largest magnitude of their row (measured 0.76 of
  one: the cross products round with and without fused multiply-adds);
  the centre bit-equal.

Occlusion is compared lane for lane on >= 0.999 of the rays (measured:
all), and the port is also held to test_mxu_trace.py's own bars against
its brute force.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.ops import mxu_trace as jmx
from royaltracer_dx_tpu_torch import convert
from royaltracer_dx_tpu_torch.ops import mxu_trace as tmx
from royaltracer_dx_tpu_torch.ops.intersect import (
    INF,
    any_hit_brute,
    closest_hit_brute,
)
from test_mxu_trace import random_rays, random_soup
from test_torch_restir import one_torch_thread  # noqa: F401 (autouse)

T_TOL, UV_TOL, MIN_AGREE = 3e-6, 2e-5, 0.999


def t_(x):
    return torch.as_tensor(np.array(x))


def both(tris, o, d):
    """The same inputs for both packages: JAX arrays and CPU tensors."""
    return (jmx.build_mxu_tris(tris), tmx.build_mxu_tris(t_(tris)), t_(o),
            t_(d))


def assert_close_hits(hj, ht):
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    state = (tj < INF) == (tt < INF)
    same_tri = np.asarray(hj.tri) == ht.tri.numpy()
    assert state.mean() >= MIN_AGREE
    assert same_tri.mean() >= MIN_AGREE
    same = (tj < INF) & (tt < INF) & same_tri
    assert same.any()
    np.testing.assert_array_less(
        np.abs(tj[same] - tt[same]),
        T_TOL * np.maximum(1.0, np.abs(tj[same])) + 1e-30)
    np.testing.assert_allclose(ht.u.numpy()[same], np.asarray(hj.u)[same],
                               rtol=0, atol=UV_TOL)
    np.testing.assert_allclose(ht.v.numpy()[same], np.asarray(hj.v)[same],
                               rtol=0, atol=UV_TOL)


def assert_brute_bars(ht, hb, tol=1e-4, frac_min=0.999):
    """test_mxu_trace.py's bars: state and t on >= frac_min, the same
    triangle on >= 0.98 of the rays both hit, u / v within 2e-4."""
    mh, bh = ht.t < INF, hb.t < INF
    hit2 = mh & bh
    t_close = torch.ones_like(mh)
    t_close[hit2] = ((ht.t - hb.t).abs()[hit2]
                     <= tol * torch.clamp_min(hb.t.abs()[hit2], 1.0))
    assert float(((mh == bh) & t_close).float().mean()) > frac_min
    same = hit2 & (ht.tri == hb.tri)
    assert int(same.sum()) > 0.98 * int(hit2.sum())
    torch.testing.assert_close(ht.u[same], hb.u[same], rtol=0, atol=2e-4)
    torch.testing.assert_close(ht.v[same], hb.v[same], rtol=0, atol=2e-4)


@pytest.mark.parametrize("case", ["soup", "off_centre"])
def test_closest_matches_jax(case):
    if case == "soup":
        tris = random_soup(3000)
        o, d = random_rays(4097)
    else:
        tris = random_soup(1000, seed=3, scale=2.0, offset=50.0)
        o, d = random_rays(1500, seed=4, scale=2.0, offset=50.0)
    jt, tt, to, td = both(tris, o, d)
    ht = tmx.closest_hit_mxu(to, td, tt)
    assert ht.tri.dtype == torch.int64
    assert_close_hits(jmx.closest_hit_mxu(o, d, jt), ht)
    hb = closest_hit_brute(to, td, t_(tris))
    if case == "soup":
        assert_brute_bars(ht, hb)
    else:
        assert_brute_bars(ht, hb, tol=5e-4, frac_min=0.998)


def test_anyhit_matches_jax_and_masked_rays():
    tris = random_soup(2000, seed=5)
    o, d = random_rays(1024, seed=6)
    t_min = jnp.full((1024,), 1e-4)
    t_max = jnp.where(jnp.arange(1024) % 3 == 0, -1.0, 10.0)
    jt, tt, to, td = both(tris, o, d)
    occ = tmx.any_hit_mxu(to, td, tt, t_(t_min), t_(t_max))
    assert occ.dtype == torch.bool
    assert not occ[::3].any()
    oj = np.asarray(jmx.any_hit_mxu(o, d, jt, t_min, t_max))
    assert (occ.numpy() == oj).mean() >= MIN_AGREE
    ob = any_hit_brute(to, td, t_(tris), t_(t_min), t_(t_max))
    assert float((occ == ob).float().mean()) > 0.999
    # the tests the kernel's order needs: none for a masked lane, all
    # triangles for a live lane that misses, up to the first hit else
    _, tests = tmx.mxu_any(*tmx.prepare_rays(to, td, t_(t_min), t_(t_max)),
                           tt)
    assert (tests[::3] == 0).all()
    live = torch.arange(1024) % 3 != 0
    assert (tests[live & ~occ] == 2000).all()
    assert ((tests[occ] >= 1) & (tests[occ] <= 2000)).all()


def test_degenerate_and_padding_never_hit():
    tris = jnp.zeros((5, 3, 3), jnp.float32)
    o, d = random_rays(64, seed=7)
    jt, tt, to, td = both(tris, o, d)
    h = tmx.closest_hit_mxu(to, td, tt)
    hj = jmx.closest_hit_mxu(o, d, jt)
    assert not h.valid.any()
    assert (h.tri == 0).all()
    np.testing.assert_array_equal(h.t.numpy(), np.asarray(hj.t))
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(hj.tri))
    assert not tmx.any_hit_mxu(to, td, tt, 1e-4, 1e4).any()


def test_ray_chunking_matches_single_batch():
    tris = random_soup(500, seed=8)
    o, d = random_rays(tmx._RAY_CHUNK + 321, seed=9)
    jt, tt, to, td = both(tris, o, d)
    h1 = tmx.closest_hit_mxu(to, td, tt)
    parts = [tmx.closest_hit_mxu(to[s:s + 1000], td[s:s + 1000], tt)
             for s in range(0, to.shape[0], 1000)]
    for key in ("t", "tri", "u", "v"):
        torch.testing.assert_close(
            getattr(h1, key), torch.cat([getattr(p, key) for p in parts]),
            rtol=0, atol=0)
    assert_close_hits(jmx.closest_hit_mxu(o, d, jt), h1)


def test_mxu_tris_from_numpy_matches_build():
    tris = random_soup(1000, seed=3, scale=2.0, offset=50.0)
    jt = jmx.build_mxu_tris(tris)
    mt = convert.mxu_tris_from_numpy(
        {"coeff": np.asarray(jt.coeff), "center": np.asarray(jt.center),
         "num_tris": jt.num_tris}, device="cpu")
    assert mt.num_tris == 1000 and mt.padded == jt.padded == 1024
    np.testing.assert_array_equal(mt.coeff.numpy(), np.asarray(jt.coeff))
    own = tmx.build_mxu_tris(t_(tris))
    np.testing.assert_array_equal(own.center.numpy(), np.asarray(jt.center))
    a, b = own.coeff.numpy(), np.asarray(jt.coeff)
    tp = mt.padded
    for p in range(4):
        blk_a, blk_b = a[:, p * tp:(p + 1) * tp], b[:, p * tp:(p + 1) * tp]
        ulp = np.spacing(np.abs(blk_b).max(axis=1, keepdims=True))
        assert (np.abs(blk_a - blk_b) <= ulp).all(), p
    # the structural zeros are exact zeros in both
    zero = np.ones((10, 4), bool)
    for p, rows in enumerate(tmx.PLANE_ROWS):
        zero[list(rows), p] = False
    for p in range(4):
        for k in np.flatnonzero(zero[:, p]):
            assert not a[k, p * tp:(p + 1) * tp].any()
            assert not b[k, p * tp:(p + 1) * tp].any()
    # the port's trace on JAX's coefficients against JAX's trace
    o, d = random_rays(1500, seed=4, scale=2.0, offset=50.0)
    assert_close_hits(jmx.closest_hit_mxu(o, d, jt),
                      tmx.closest_hit_mxu(t_(o), t_(d), mt))


def test_miss_and_tie_semantics():
    """Misses answer t = INF, triangle 0 and triangle 0's u, v; exact-t
    ties go to the lower index; u and v fold -0.0 into +0.0 (the JAX
    one-hot sums do)."""
    rng = np.random.default_rng(21)
    soup = np.asarray(random_soup(200, seed=22))
    tris = np.concatenate([soup, soup])            # every triangle twice
    aim = soup[rng.integers(0, 200, 512)].mean(axis=1)
    o = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    # rays that leave the soup, and rays of signed-zero direction
    o_out = (o / np.linalg.norm(o, axis=1, keepdims=True) * 5.0)
    d_out = o_out / 5.0
    zsign = np.where(rng.random((512, 3)) < 0.5, -0.0, 0.0)
    o_all = np.concatenate([o, o_out, o]).astype(np.float32)
    d_all = np.concatenate([d, d_out, zsign]).astype(np.float32)
    jt = jmx.build_mxu_tris(jnp.asarray(tris))
    mt = convert.mxu_tris_from_numpy(
        {"coeff": np.asarray(jt.coeff), "center": np.asarray(jt.center),
         "num_tris": jt.num_tris}, device="cpu")
    h = tmx.closest_hit_mxu(t_(o_all), t_(d_all), mt)
    hj = jmx.closest_hit_mxu(jnp.asarray(o_all), jnp.asarray(d_all), jt)
    hit = h.valid
    assert int(hit[:512].sum()) > 400
    assert (h.tri[hit] < 200).all()                 # the lower twin
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(hj.tri))
    miss = ~hit
    assert (h.tri[miss] == 0).all() and (h.t[miss] == INF).all()
    np.testing.assert_array_equal(h.t.numpy()[miss.numpy()],
                                  np.asarray(hj.t)[miss.numpy()])
    # a miss still reads triangle 0's u, v
    f = tmx._features(t_(o_all), t_(d_all), mt.center)
    det, a, b, _ = tmx._products(f, mt.coeff)
    inv = 1.0 / torch.where(det[:, 0].abs() > 1e-12, det[:, 0], 1.0) + 0.0
    torch.testing.assert_close(h.u[miss], ((a[:, 0] + 0.0) * inv)[miss],
                               rtol=0, atol=0)
    # rays aimed at centroids from anywhere graze some triangles, and a
    # miss reads triangle 0 wherever the ray passes: both amplify the
    # summation-order difference.  Hits: test_mxu_trace.py's 2e-4
    # (measured 1.9e-4); misses, which no bar there covers: 1e-3
    # relative (measured 2.5e-4; |u| reaches 658)
    m = miss.numpy()
    for key in ("u", "v"):
        a_, b_ = getattr(h, key).numpy(), np.asarray(getattr(hj, key))
        np.testing.assert_allclose(a_[~m], b_[~m], rtol=0, atol=2e-4)
        np.testing.assert_allclose(a_[m], b_[m], rtol=1e-3, atol=1e-6)
    # signed-zero directions: some lanes' a is -0.0 at triangle 0; u is
    # +0.0 there, bit for bit as in JAX
    neg0 = (a[:, 0] == 0) & torch.signbit(a[:, 0])
    assert neg0.any()
    assert not torch.signbit(h.u[neg0]).any()
    np.testing.assert_array_equal(
        h.u[neg0].numpy().view(np.int32),
        np.asarray(hj.u)[neg0.numpy()].view(np.int32))


def test_no_triangles_raise():
    with pytest.raises(ValueError):
        tmx.build_mxu_tris(torch.zeros((0, 3, 3)))
    empty = tmx.MxuTris(coeff=torch.zeros((10, 0)), center=torch.zeros(3),
                        num_tris=0)
    with pytest.raises(ValueError):
        tmx.closest_hit_mxu(torch.zeros((4, 3)), torch.ones((4, 3)), empty)
