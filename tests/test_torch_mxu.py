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

tools/mxu_cases.py's adversarial inputs are held against the JAX package
too, on its coefficients carried across, with the bars of
``test_mxu_cases_match_jax``; and the kernels' tensor-core filter, in
torch ops (``_candidates_plain``), is held to its promise: it never
drops a pair that the plain decision accepts, and its margins cover the
difference between its TF32 sums and the plain ones.
"""

import os
import re


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
from royaltracer_dx_tpu_torch.tools.mxu_cases import MXU_CASES, mxu_case
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


# ------------------- the adversarial cases against JAX --------------------

TWINS = {"duplicates": 150}   # a triangle's twins: the same index modulo
# cases whose rays all aim at a vertex or an edge: their bars (hit state,
# the triangle up to a shared edge), just under the measured 0.8931 and
# 0.8661 of the rays
BOUNDARY_CASES = {"edges": (0.89, 0.86)}
U32 = 2.0 ** -24


def carried(jt):
    """JAX's coefficients on the CPU in the port's MxuTris."""
    return convert.mxu_tris_from_numpy(
        {"coeff": np.asarray(jt.coeff), "center": np.asarray(jt.center),
         "num_tris": jt.num_tris}, device="cpu")


def order_bounds(o, d, mt, tri, t, u, v):
    """How far the two packages' t, u, v may lie apart at triangle ``tri``
    from rounding alone: each sum of n products rounds within n u S in
    each (S = sum |f_k q_k|), the cross product o x d rounds with fused
    multiply-adds in XLA and without in the port (2 u G_k, G_k its two
    products' magnitudes), and both errors pass through the division by
    det.  Returns (bound_t, bound_u, bound_v) as numpy arrays."""
    f = tmx._features(o, d, mt.center)
    oc = [o[:, k] - mt.center[k] for k in range(3)]
    g = [(oc[(k + 1) % 3] * d[:, (k + 2) % 3]).abs()
         + (oc[(k + 2) % 3] * d[:, (k + 1) % 3]).abs() for k in range(3)]
    feats = torch.stack([*f, torch.ones_like(f[0])], dim=1).double()
    err = torch.zeros_like(feats)
    err[:, 3:6] = torch.stack(g, dim=1).double()
    tp, coeff = mt.padded, mt.coeff.double()
    bound, det = [], None
    for p, rows in enumerate(tmx.PLANE_ROWS):
        col = coeff[:, p * tp:(p + 1) * tp][:, tri].T[:, list(rows)]
        x = feats[:, list(rows)]
        bound.append(U32 * (2 * len(rows) * (x * col).abs().sum(dim=1)
                            + 2 * (err[:, list(rows)] * col.abs()).sum(dim=1)))
        if p == 0:
            det = (x * col).sum(dim=1).abs()
    bd, ba, bb, bc = (b.numpy() for b in bound)
    det = det.numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        return tuple((bx + np.abs(x) * bd) / det + 2 * U32 * np.abs(x)
                     for bx, x in ((bc, t), (ba, u), (bb, v)))


@pytest.mark.parametrize("case", MXU_CASES)
def test_mxu_cases_match_jax(case):
    """tools/mxu_cases.py's inputs through the port's plain versions and
    the JAX package's closest_hit_mxu / any_hit_mxu on the same
    coefficients.  Bars:

    * hit state and triangle equal on >= MIN_AGREE of the rays; on
      ``duplicates`` either twin counts (reversed twins tie in t to
      within rounding, and the two summation orders break the tie
      differently: 0.871 of the rays agree on the index itself); on
      ``edges``, where every ray aims at a vertex or an edge midpoint,
      whether it hits and which triangle of a shared edge it hits are
      decided by rounding: measured, the hit state agrees on 0.8931 of
      the rays, the triangle on 0.8591 and, counting triangles that
      share an edge as one, on 0.8661; the bars ``BOUNDARY_CASES`` lie
      just under those, and each disagreement must be a boundary hit:
      the nearer of the two answers has min(u, v, 1 - u - v) <= UV_TOL
      (measured <= 1.5e-6);
    * t within T_TOL max(1, |t|), u and v within UV_TOL where both hit
      the same triangle (t within T_TOL on twins) -- or, where the sums
      cancel (grazing rays, t -> 0: ROADMAP.md §C), within the two
      packages' rounding bound ``order_bounds`` (measured <= 0.27 of it;
      the fixed bars alone miss on up to 14 of a case's hits, by up to
      3.5e-3 in u on ``non_finite``);
    * each package's occlusion equal to its own closest hit state, so
      occlusion agrees wherever the hit state does."""
    tris, o, d, lo, hi = mxu_case(case, "cpu")
    jt = jmx.build_mxu_tris(jnp.asarray(tris.numpy()))
    mt = carried(jt)
    jx = [jnp.asarray(x.numpy()) for x in (o, d, lo, hi)]
    ht = tmx.closest_hit_mxu(o, d, mt, lo, hi)
    hj = jmx.closest_hit_mxu(jx[0], jx[1], jt, jx[2], jx[3])
    occ_t = tmx.any_hit_mxu(o, d, mt, lo, hi).numpy()
    occ_j = np.asarray(jmx.any_hit_mxu(jx[0], jx[1], jt, jx[2], jx[3]))
    tt, tj = ht.t.numpy(), np.asarray(hj.t)
    ut, vt = ht.u.numpy(), ht.v.numpy()
    uj, vj = np.asarray(hj.u), np.asarray(hj.v)
    kt, kj = ht.tri.numpy(), np.asarray(hj.tri)
    ht_, hj_ = tt < INF, tj < INF
    np.testing.assert_array_equal(occ_t, ht_)
    np.testing.assert_array_equal(occ_j, hj_)
    m = TWINS.get(case)
    same_key = (kt % m == kj % m) if m else kt == kj
    if case in BOUNDARY_CASES:   # triangles that share an edge count as one
        verts = tris.numpy()
        shared = (verts[kt][:, :, None, :] == verts[kj][:, None, :, :]).all(
            axis=3).any(axis=2).sum(axis=1) >= 2
        same_key = same_key | shared
    agree = (ht_ == hj_) & (~ht_ | same_key)
    if case in BOUNDARY_CASES:
        state_bar, tri_bar = BOUNDARY_CASES[case]
        near_t = ht_ & (~hj_ | (tt <= tj))
        with np.errstate(invalid="ignore"):
            bary = np.where(near_t,
                            np.minimum(np.minimum(ut, vt), 1 - ut - vt),
                            np.minimum(np.minimum(uj, vj), 1 - uj - vj))
        assert (np.abs(bary[~agree]) <= UV_TOL).all()
        assert (ht_ == hj_).mean() >= state_bar
        assert agree.mean() >= tri_bar
    else:
        assert agree.mean() >= MIN_AGREE
    both = ht_ & hj_ & same_key
    same = both & (kt == kj)
    bt, bu, bv = order_bounds(o, d, mt, ht.tri, tt, ut, vt)
    with np.errstate(invalid="ignore"):   # misses' u, v may be NaN
        t_bar = np.maximum(T_TOL * np.maximum(1.0, np.abs(tj)), bt)
        assert (np.abs(tt - tj)[both] <= t_bar[both]).all()
        assert (np.abs(ut - uj)[same] <= np.maximum(UV_TOL, bu)[same]).all()
        assert (np.abs(vt - vj)[same] <= np.maximum(UV_TOL, bv)[same]).all()


# -------------------- the kernels' filter, in torch ops -------------------


def filter_inputs(case):
    """(tri_verts, origins, dirs, t_min, t_max) of a filter case on the
    CPU: test_mxu_trace.py's soup (1,024 random rays), menger's
    triangles with 32x32 camera rays, or a tools/mxu_cases.py case."""
    if case == "soup":
        tris = t_(random_soup(3000))
        o, d = (t_(x) for x in random_rays(1024))
    elif case == "menger":
        from royaltracer_dx_tpu_torch import cli
        from royaltracer_dx_tpu_torch.camera import generate_rays

        scene, camera = cli.build_scene("menger")
        tris = scene.flatten(scene.build_materials(device="cpu"),
                             device="cpu").tri_verts
        cam = {k: torch.as_tensor(x) for k, x in camera.matrices(1.0).items()}
        o, d = generate_rays(cam, 32, 32)
    else:
        return mxu_case(case, "cpu")
    n = o.shape[0]
    return (tris, o.contiguous(), d.contiguous(), torch.full((n,), 1e-4),
            torch.full((n,), 1e4))


@pytest.mark.parametrize("case", ("soup", "menger") + MXU_CASES)
def test_filter_keeps_every_accepted_pair(case):
    """The filter of csrc/mxu_trace.cu (``_candidates_plain``, one TF32
    pass) keeps every pair that ``_decide`` accepts, and
    for every ray whose features are in its safe range its margin covers
    |TF32 sum - plain sum| in each plane it reads (det, a, b).  The
    simulation sums exact products in float64, so it checks the TF32
    rounding's share of the bound; the tensor core's own accumulation is
    held on the card, where the kernels must equal the plain versions bit
    for bit."""
    tris, o, d, lo, hi = filter_inputs(case)
    mt = tmx.build_mxu_tris(tris)
    kept = 0
    for s in range(0, o.shape[0], 256):
        sl = slice(s, s + 256)
        r = tmx._candidates_plain(o[sl], d[sl], lo[sl], hi[sl], mt.coeff,
                                  mt.center, mt.num_tris)
        f = tmx._features(o[sl], d[sl], mt.center)
        plain = tmx._products(f, mt.coeff)
        ok, _ = tmx._decide(*plain, lo[sl, None], hi[sl, None])
        assert not (ok[:, :mt.num_tris] & ~r["keep"]).any()
        safe = r["safe"]
        for x, y, margin in zip(r["approx"], plain, r["margin"]):
            diff = (x.double() - y[:, :mt.num_tris].double()).abs()
            assert (diff[safe] <= margin[safe]).all()
        kept += int(r["keep"].sum())
    if case == "menger":   # what the kernels confirm (measured ~0.3%)
        assert kept < 0.01 * o.shape[0] * mt.num_tris


def test_filter_constants_match_source():
    """The filter's constants in ops/mxu_trace.py are csrc/mxu_trace.cu's."""
    src = os.path.join(os.path.dirname(tmx.__file__), os.pardir, "csrc",
                       "mxu_trace.cu")
    with open(src) as fh:
        found = dict(re.findall(r"constexpr int (\w+) = (-?\d+);", fh.read()))
    assert int(found["KAPPA_LOG2"]) == tmx.KAPPA_LOG2
    assert int(found["MU_LOG2"]) == tmx.MU_LOG2
    assert int(found["SAFE_LOG2"]) == tmx.SAFE_LOG2
    assert int(found["STEP"]) == tmx.FILTER_STEP


def test_tf32_rounds_to_nearest_ties_away():
    """``_tf32`` keeps 10 stored mantissa bits, rounding to nearest with
    ties away from zero, as cvt.rna.tf32.f32 does."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      1 + 3 * 2.0 ** -11, 0.0, -0.0, 3.0], dtype=torch.float32)
    want = [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 1 + 2.0 ** -9, 0.0, -0.0,
            3.0]
    got = tmx._tf32(x)
    assert got.tolist() == want
    assert torch.signbit(got[5])
    assert not (got.view(torch.int32) & 0x1FFF).any()


def test_mxu_work_tensor_core_bound():
    """mxu_work's two yardsticks: 44 FP32 operations a pair in the plain
    order; on tensor cores the filter's det, a and b sums in one TF32 pass
    (30 operations a pair) at 495 TFLOP/s beside the decision's 11 FP32
    operations a pair, which bind."""
    mt = tmx.build_mxu_tris(t_(random_soup(200)))
    w = tmx.mxu_work(100_000, mt, live=60_000)
    pairs = 60_000 * 200
    assert w["pairs"] == pairs
    assert w["fp32_ops"] == pairs * 44 + 60_000 * (12 + 32)
    assert w["tf32_ops"] == pairs * 30
    assert w["decision_fp32_ops"] == pairs * 11 + 60_000 * (12 + 32)
    b = tmx.tc_bound_ms(w, 66.9e12, 3.35e12)
    # 1.64e-13 s a pair against 6.1e-14 (TF32) and 52 B a ray (bytes)
    assert b["tc_bound_by"] == "fp32"
    assert b["tc_tf32_ms"] == pytest.approx(pairs * 30 / 495e12 * 1e3)
    assert b["tc_bound_ms"] == b["tc_fp32_ms"] == pytest.approx(
        w["decision_fp32_ops"] / 66.9e12 * 1e3)
