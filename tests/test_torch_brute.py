"""Brute force and the stream entry points of the port against the JAX
package, on the CPU.

``brute_trace.brute_closest`` / ``brute_any`` run their plain versions
(``intersect.closest_hit_brute`` / ``any_hit_brute``) on CPU tensors: held
against JAX's ``closest_hit_brute`` / ``any_hit_brute`` on seeded rays with
generic directions, triangle ids and occlusion equal and t, u, v within
1e-5 (XLA-CPU contracts products into FMAs, so the two packages differ by
ulps; tests/test_stream.py's tolerance).  The premise of the kernels'
single pass, that the plain answer does not depend on the chunk size, is
held bit for bit, ties included.  ``stream_trace.closest_hit_stream_xla``
/ ``any_hit_stream_xla`` are held against JAX's on a windowed accel (a
70 x 70 grid, 9,800 triangles), with and without the presort (t within
1e-5; u and v within ``UV_TOL``, the grid's triangles being small).
Rays aimed at vertices or edges are left to the card tests, where kernel
and plain version round alike: there XLA's rounding picks other
triangles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.ops import intersect as jit_
from royaltracer_dx_tpu.ops import stream_trace as jst

from royaltracer_dx_tpu_torch import convert
from royaltracer_dx_tpu_torch.ops import brute_trace as tbt
from royaltracer_dx_tpu_torch.ops import intersect as tit
from royaltracer_dx_tpu_torch.ops import stream_trace as tst
from royaltracer_dx_tpu_torch.tools.brute_cases import (
    BRUTE_CASES,
    brute_case,
    grid_tris,
)

from test_torch_restir import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
# u and v on the 70 x 70 grid: its triangles are 0.029 across, so u and v,
# quotients by det (the squared edge), carry XLA's FMA ulps ~1000x larger
# than t does
UV_TOL = 1e-4


def soup(t, seed=7):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (t, 1, 3)).astype(np.float32)
    e = rng.uniform(-0.15, 0.15, (t, 3, 3)).astype(np.float32)
    return c + e


def rays(n, seed=3, spread=1.2):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def bounds(n, seed=5):
    """t_min / t_max: live segments, every seventh lane masked (t_max <
    t_min) and every eleventh a NaN t_min."""
    rng = np.random.default_rng(seed)
    lane = np.arange(n)
    t_min = np.where(lane % 11 == 0, np.nan, 1e-4).astype(np.float32)
    t_max = rng.uniform(0.5, 3.0, n).astype(np.float32)
    t_max = np.where(lane % 7 == 0, -1.0, t_max).astype(np.float32)
    return t_min, t_max


def t_(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b))


# ------------------------------ brute force -------------------------------


@pytest.mark.parametrize("t", [1, 700, 1100])
def test_brute_matches_jax(t):
    """Closest hit and occlusion against the JAX package on one chunk
    (T = 1), on 700 and on 1,100 triangles (not a multiple of 512)."""
    tris = soup(t)
    n = 2048
    o, d = rays(n)
    t_min, t_max = bounds(n)
    hj = jit_.closest_hit_brute(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tris), jnp.asarray(t_min),
                                jnp.asarray(t_max))
    tt, tri, u, v = tbt.brute_closest(t_(o), t_(d), t_(t_min), t_(t_max),
                                      t_(tris))
    hit = np.asarray(hj.t) < 1e29
    assert hit.sum() > (n // 20 if t > 1 else 0)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_array_equal(tt.numpy() < 1e29, hit)
    for a, b in ((tt, hj.t), (u, hj.u), (v, hj.v)):
        assert close(a.numpy(), b).all()
    oj = np.asarray(jit_.any_hit_brute(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(tris), jnp.asarray(t_min),
                                       jnp.asarray(t_max)))
    occ, tests = tbt.brute_any(t_(o), t_(d), t_(t_min), t_(t_max), t_(tris),
                               stats=True)
    np.testing.assert_array_equal(occ.numpy(), oj)
    live = t_min < t_max
    assert not occ.numpy()[~live].any()
    # tests: 0 for dead lanes, T where a live lane hits nothing, at most T
    tn = tests.numpy()
    assert (tn[~live] == 0).all() and (tn[live & ~oj] == t).all()
    assert ((tn[oj] >= 1) & (tn[oj] <= t)).all()


@pytest.mark.parametrize("chunk", [128, 512, 4096])
def test_chunk_size_does_not_change_the_answer(chunk):
    """The plain version's answer at any chunk size equals the one at 512
    bit for bit, on a soup with triangles duplicated across chunk
    boundaries (exact t ties): the premise of the kernels' single pass in
    index order."""
    base = soup(300, seed=9)
    tris = np.concatenate([base, base[::-1], base])       # 900, three ties
    o, d = rays(2048, seed=4)
    t_min, t_max = bounds(2048, seed=6)
    args = (t_(o), t_(d), t_(tris), t_(t_min), t_(t_max))
    ref = tit.closest_hit_brute(*args)
    got = tit.closest_hit_brute(*args, chunk=chunk)
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(tit.any_hit_brute(*args, chunk=chunk),
                       tit.any_hit_brute(*args))
    assert int((ref.t < 1e29).sum()) > 100


def test_ties_take_the_lowest_index():
    """Duplicated triangles: the lowest index among equal smallest t
    wins, in the port and in JAX."""
    base = soup(200, seed=2)
    tris = np.concatenate([base, base, base])
    o, d = rays(2048, seed=8)
    tt, tri, _, _ = tbt.brute_closest(t_(o), t_(d),
                                      t_(np.full(2048, 1e-4, np.float32)),
                                      t_(np.full(2048, 1e4, np.float32)),
                                      t_(tris))
    hj = jit_.closest_hit_brute(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tris))
    hit = tt.numpy() < 1e29
    assert hit.sum() > 100
    assert (tri.numpy()[hit] < 200).all()
    np.testing.assert_array_equal(tri.numpy(), np.asarray(hj.tri))


def test_no_triangles_miss_everywhere():
    """T = 0: every ray misses (t = INF, tri 0, u = v = 0), as in JAX
    (both pad to one chunk of degenerate triangles)."""
    o, d = rays(300)
    lo = np.full(300, 1e-4, np.float32)
    hi = np.full(300, 1e4, np.float32)
    empty = np.zeros((0, 3, 3), np.float32)
    tt, tri, u, v = tbt.brute_closest(t_(o), t_(d), t_(lo), t_(hi),
                                      t_(empty))
    hj = jit_.closest_hit_brute(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(empty))
    assert (tt.numpy() == np.float32(1e30)).all()
    assert (tri.numpy() == 0).all() and (u.numpy() == 0).all()
    assert (v.numpy() == 0).all()
    np.testing.assert_array_equal(tt.numpy(), np.asarray(hj.t))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(hj.tri))
    occ, tests = tbt.brute_any(t_(o), t_(d), t_(lo), t_(hi), t_(empty),
                               stats=True)
    assert not occ.any() and not tests.any()
    assert not np.asarray(jit_.any_hit_brute(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(empty), 1e-4,
        1e4)).any()


def test_first_hit_tests_scalar_model():
    """``first_hit_tests`` against a scalar walk in index order over the
    plain per-pair test (dead, NaN and live lanes)."""
    tris = soup(150, seed=3)
    o, d = rays(256, seed=12)
    t_min, t_max = bounds(256, seed=13)
    tests = tbt.first_hit_tests(t_(o), t_(d), t_(t_min), t_(t_max),
                                t_(tris), chunk=128).numpy()
    t, _, _ = tit._mt_chunk_planar(
        tuple(t_(o[:, c])[:, None] for c in range(3)),
        tuple(t_(d[:, c])[:, None] for c in range(3)),
        tuple(t_(tris[:, 0, c]) for c in range(3)),
        tuple(t_(tris[:, 1, c] - tris[:, 0, c]) for c in range(3)),
        tuple(t_(tris[:, 2, c] - tris[:, 0, c]) for c in range(3)),
        t_(t_min)[:, None], t_(t_max)[:, None])
    ok = t.numpy() < 1e30
    for i in range(256):
        want = 0
        if t_min[i] < t_max[i]:
            hits = np.flatnonzero(ok[i])
            want = hits[0] + 1 if hits.size else len(tris)
        assert tests[i] == want, i
    assert (tests > 0).sum() > 100 and (tests < len(tris)).sum() > 10


def test_traced_forms_equal_plain():
    """``closest_hit_brute_traced`` / ``any_hit_brute_traced`` (planar
    rays, scalar and [N] bounds) give the plain functions' answers."""
    tris = t_(soup(600, seed=1))
    o, d = rays(1000, seed=21)
    op = tuple(t_(o[:, c]) for c in range(3))
    dp = tuple(t_(d[:, c]) for c in range(3))
    t_min, t_max = bounds(1000)
    h = tbt.closest_hit_brute_traced(op, dp, tris, 1e-4, t_(t_max))
    ref = tit.closest_hit_brute(op, dp, tris, 1e-4, t_(t_max))
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(h, f), getattr(ref, f)), f
    assert torch.equal(
        tbt.any_hit_brute_traced(op, dp, tris, t_(t_min), t_(t_max)),
        tit.any_hit_brute(op, dp, tris, t_(t_min), t_(t_max)))
    assert tbt.LAUNCHES == {"brute_closest": 0, "brute_any": 0}


@pytest.mark.parametrize("case", BRUTE_CASES)
def test_brute_cases_consistent(case):
    """The card tests' adversarial inputs (tools/brute_cases.py) on the
    plain versions: occlusion is exactly a closest hit below INF (both
    take the same pairs), dead lanes test nothing, an occluded lane tests
    up to its first hit, an open live lane all T triangles."""
    tris, o, d, lo, hi = brute_case(case, "cpu", n=1001)
    t, tri, u, v = tbt.brute_closest(o, d, lo, hi, tris)
    occ, tests = tbt.brute_any(o, d, lo, hi, tris, stats=True)
    assert torch.equal(occ, t < 1e30)
    live = lo < hi
    assert not occ[~live].any() and not tests[~live].any()
    assert bool((tests[occ] >= 1).all() & (tests[occ] <= len(tris)).all())
    assert bool((tests[live & ~occ] == len(tris)).all())
    miss = t >= 1e30
    assert not tri[miss].any() and not u[miss].any() and not v[miss].any()
    if case not in ("no_tris", "beyond_inf"):
        assert int(occ.sum()) > 10


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_mt_stages_scalar_model(kind):
    """``mt_stages`` against a scalar walk over the pairs in float32, in
    the kernel's order: each live ray's triangles (for any hit up to its
    first ok one), leaving a pair at its first failed test; every tenth
    triangle degenerate (det = 0)."""
    tris = soup(150, seed=5)
    tris[::10, 2] = tris[::10, 0]
    o, d = rays(200, seed=14)
    t_min, t_max = bounds(200, seed=15)
    args = (t_(o), t_(d), t_(t_min), t_(t_max), t_(tris))
    tests = (tbt.first_hit_tests(*args, chunk=128) if kind == "any"
             else None)
    got = tbt.mt_stages(*args, tests=tests, chunk=128)
    f = np.float32
    e1 = (tris[:, 1] - tris[:, 0]).astype(f)
    e2 = (tris[:, 2] - tris[:, 0]).astype(f)
    want = dict(pairs=0, det=0, u=0, uv=0)
    for i in range(200):
        if not t_min[i] < t_max[i]:
            continue
        limit = len(tris) if tests is None else int(tests[i])
        (ox, oy, oz), (dx, dy, dz) = o[i], d[i]
        for j in range(limit):
            (v0x, v0y, v0z), (e1x, e1y, e1z) = tris[j, 0], e1[j]
            e2x, e2y, e2z = e2[j]
            want["pairs"] += 1
            px, py, pz = (dy * e2z - dz * e2y, dz * e2x - dx * e2z,
                          dx * e2y - dy * e2x)
            det = e1x * px + e1y * py + e1z * pz
            if not abs(det) > f(1e-12):
                continue
            want["det"] += 1
            inv = f(1.0) / det
            tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
            u = (tx * px + ty * py + tz * pz) * inv
            if not u >= 0.0:
                continue
            want["u"] += 1
            qx, qy, qz = (ty * e1z - tz * e1y, tz * e1x - tx * e1z,
                          tx * e1y - ty * e1x)
            v = (dx * qx + dy * qy + dz * qz) * inv
            if v >= 0.0 and u + v <= 1.0:
                want["uv"] += 1
    assert got == want
    assert want["pairs"] > want["det"] > want["u"] > want["uv"] > 0


def test_planes_built_once_per_triangles():
    """``planes_of`` lays a triangle tensor out once, again after an
    in-place write, and forgets it when the tensor goes."""
    tris = t_(soup(40))
    p = tbt.planes_of(tris)
    assert tbt.planes_of(tris) is p
    assert torch.equal(p, tbt.tri_planes(tris))
    tris[3, 1, 2] += 0.5
    q = tbt.planes_of(tris)
    assert q is not p and torch.equal(q, tbt.tri_planes(tris))
    key = id(tris)
    del tris
    assert key not in tbt._PLANES


def test_checks_refuse_bad_inputs():
    o, d = rays(8)
    lo = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="float32"):
        tbt.brute_closest(t_(o), t_(d), t_(lo), t_(lo.astype(np.float64)),
                          t_(soup(4)))
    with pytest.raises(ValueError, match="contiguous"):
        tbt.brute_any(t_(o), t_(d.T).T, t_(lo), t_(lo), t_(soup(4)))


def test_traced_forms_read_planes_and_scalars():
    """The brute entry points take [N, 3] rows, three [N] planes of any
    stride (the dispatch's), and bounds as [N] tensors of any stride,
    one-element tensors or Python numbers: the same answers."""
    tris = t_(soup(300, seed=4))
    o, d = rays(700, seed=22)
    rows = t_(np.concatenate([o, d], 1))          # planes with stride 6
    op = tuple(rows[:, c] for c in range(3))
    dp = tuple(rows[:, 3 + c] for c in range(3))
    hi = t_(np.full(1400, 2.5, np.float32))[::2]  # stride 2
    ref = tbt.brute_closest(t_(o), t_(d), t_(np.full(700, 1e-4, np.float32)),
                            t_(np.full(700, 2.5, np.float32)), tris)
    for args in ((op, dp, 1e-4, hi), (op, dp, torch.tensor(1e-4), 2.5),
                 (t_(o), t_(d), 1e-4, hi)):
        got = tbt.brute_closest(*args, tris)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert torch.equal(tbt.brute_any(*args, tris)[0],
                           tbt.brute_any(t_(o), t_(d), 1e-4, 2.5, tris)[0])
    assert int((ref[0] < 1e29).sum()) > 50
    with pytest.raises(ValueError, match="planes"):
        tbt.brute_closest(op[:2], dp, 1e-4, hi, tris)
    with pytest.raises(ValueError, match="float32"):
        tbt.brute_closest(op, dp, 1e-4, hi.double(), tris)


# ------------------- the kernels' merge across slices --------------------


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("slices", [1, 3, 7, 64])
@pytest.mark.parametrize("case", BRUTE_CASES)
def test_closest_slice_merge_model(case, slices):
    """The closest kernel's merge in torch ops (each slice's first
    minimum, the minimum of (order_key(t), index) over slices, t, u, v
    recomputed from the winner) equals closest_hit_brute bit for bit on
    every brute case: ties, signed zeros, negative t and t beyond INF
    included."""
    tris, o, d, lo, hi = brute_case(case, "cpu", n=1001)
    h = tit.closest_hit_brute(o, d, tris, lo, hi)
    got = tbt._closest_slices_plain(o, d, lo, hi, tris, slices)
    for a, b in zip(got, (h.t, h.tri, h.u, h.v)):
        assert a.dtype == b.dtype
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("slices", [1, 3, 7, 64])
@pytest.mark.parametrize("case", BRUTE_CASES)
def test_counted_any_slice_merge_model(case, slices):
    """The counted any-hit kernel's merge (each slice's first ok index,
    their minimum) gives first_hit_tests and any_hit_brute exactly."""
    tris, o, d, lo, hi = brute_case(case, "cpu", n=1001)
    occ, tests = tbt._first_hit_slices_plain(o, d, lo, hi, tris, slices)
    assert torch.equal(occ, tit.any_hit_brute(o, d, tris, lo, hi))
    assert torch.equal(tests, tbt.first_hit_tests(o, d, lo, hi, tris))


def test_order_key_orders_floats():
    """order_key on a sweep of floats (+-0, +-inf, subnormals, negatives,
    values about 1e30, float32's extremes): -0.0 and +0.0 share a key,
    and the keys order exactly as the floats do."""
    f = np.float32
    tiny = np.nextafter(f(0), f(1))
    vals = [0.0, -0.0, np.inf, -np.inf, tiny, -tiny, 2 * tiny, -2 * tiny,
            np.finfo(f).tiny, -np.finfo(f).tiny, 1.0, -1.0, 1e-30, -1e-30,
            np.finfo(f).max, -np.finfo(f).max, 1e-4, -2.0, 3.5]
    near = f(1e30)
    for k in range(-3, 4):
        x = near
        for _ in range(abs(k)):
            x = np.nextafter(x, f(np.inf) if k > 0 else f(0))
        vals += [x, -x]
    rng = np.random.default_rng(1)
    vals += list(rng.standard_normal(200).astype(f) * f(1e3))
    vals += list((rng.standard_normal(50) * 1e-42).astype(f))
    x = torch.tensor(np.array(vals, f))
    k = tbt.order_key(x)
    assert int(tbt.order_key(torch.tensor([-0.0]))) == \
        int(tbt.order_key(torch.tensor([0.0])))
    assert bool(((k >= 0) & (k < 2**32)).all())
    xs, ks = x.double(), k
    for i in range(len(vals)):
        assert torch.equal(xs[i] < xs, ks[i] < ks), vals[i]
        assert torch.equal(xs[i] == xs, ks[i] == ks), vals[i]


def test_signed_zero_case_holds_the_trap():
    """tools/brute_cases.py's signed_zero case: twin triangles give t =
    +0.0 at the lower index and -0.0 at the higher one for some rays (a
    key that kept -0.0 below +0.0 would pick the twin), and some hits
    have negative t."""
    tris, o, d, lo, hi = brute_case("signed_zero", "cpu", n=1001)
    k = tris.shape[0] // 2
    t, _, _ = tit._mt_chunk_planar(
        tuple(o[:, c][:, None] for c in range(3)),
        tuple(d[:, c][:, None] for c in range(3)),
        tuple(tris[:, 0, c] for c in range(3)),
        tuple(tris[:, 1, c] - tris[:, 0, c] for c in range(3)),
        tuple(tris[:, 2, c] - tris[:, 0, c] for c in range(3)),
        lo[:, None], hi[:, None])
    a, b = t[:, :k], t[:, k:]
    trap = (a == 0) & (b == 0) & ~torch.signbit(a) & torch.signbit(b)
    assert int(trap.sum()) > 20
    h = tit.closest_hit_brute(o, d, tris, lo, hi)
    assert int((h.t < 0).sum()) > 20
    assert int(((h.t == 0) & torch.signbit(h.t)).sum()) > 20


def test_signed_zero_matches_jax():
    """The signed_zero case against the JAX package: hits, t and
    occlusion; the triangle (the lowest index among equal t, signed zeros
    equal) on the rays that start on the plane, whose t is exactly 0.
    The other rays meet overlapping coplanar triangles at t within ulps
    of each other, where XLA's FMA rounding picks another of them."""
    tris, o, d, lo, hi = brute_case("signed_zero", "cpu", n=2001)
    hj = jit_.closest_hit_brute(*(jnp.asarray(x.numpy())
                                  for x in (o, d, tris, lo, hi)))
    tt, tri, u, v = tbt.brute_closest(o, d, lo, hi, tris)
    np.testing.assert_array_equal(tt.numpy() < 1e29, np.asarray(hj.t) < 1e29)
    assert close(tt.numpy(), hj.t).all()
    on_plane = tt.numpy() == 0
    assert on_plane.sum() > 500
    np.testing.assert_array_equal(tri.numpy()[on_plane],
                                  np.asarray(hj.tri)[on_plane])
    same = tri.numpy() == np.asarray(hj.tri)
    assert same.mean() > 0.9
    for a, b in ((u, hj.u), (v, hj.v)):
        assert close(a.numpy()[same], np.asarray(b)[same]).all()
    oj = np.asarray(jit_.any_hit_brute(*(jnp.asarray(x.numpy())
                                         for x in (o, d, tris, lo, hi))))
    np.testing.assert_array_equal(tbt.brute_any(o, d, lo, hi, tris)[0], oj)


def test_slice_plan_and_source_constants():
    """slice_plan's and any_rounds' constants are the package source's,
    a dense
    32-triangle batch takes one slice and a sparse one of 4,802
    triangles enough slices for ITEMS_PER_CTA items a CTA (at most
    MIN_SLICE triangles short of the triangle count)."""
    import re

    with open(tbt._SRC) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("THREADS") * const("RAYS") == tbt.RAYS_PER_ITEM
    for name in ("MIN_SLICE", "ITEMS_PER_CTA", "FIRST_ROUND",
                 "ROUND_GROWTH"):
        assert const(name) == getattr(tbt, name), name
    assert const("N_COUNTERS") == tbt._N_COUNTERS
    assert const("MAX_ROUNDS") == tbt._MAX_ROUNDS
    grid = 132 * 2
    assert tbt.slice_plan(262_144, 32, grid)["slices"] == 1
    sparse = tbt.slice_plan(48_608, 4_802, grid)
    assert sparse["groups"] == 48 and sparse["slices"] == 22
    assert sparse["items"] >= tbt.ITEMS_PER_CTA * grid
    assert sparse["slices"] * sparse["slice_len"] >= 4_802
    one = tbt.slice_plan(64, 4_802, grid)
    assert one["slices"] == -(-4_802 // tbt.MIN_SLICE)
    assert tbt.slice_plan(0, 4_802, grid)["items"] == 0
    assert tbt.slice_plan(10, 0, grid) == dict(groups=1, slices=1,
                                               slice_len=0, items=1)


@pytest.mark.parametrize("t_count", [0, 1, 32, 256, 300, 600, 1100, 4802,
                                     9800, 2**30])
def test_any_rounds_cover_the_triangles(t_count):
    """Any hit's rounds cover [0, T) in order without gaps, the first
    FIRST_ROUND triangles (or all), each later round at most
    ROUND_GROWTH times the triangles before it save the last, which is at
    least as long as the round before it."""
    rounds = tbt.any_rounds(t_count)
    if not t_count:
        assert rounds == []
        return
    assert [a for a, _ in rounds] == [0] + [b for _, b in rounds[:-1]]
    assert rounds[-1][1] == t_count
    assert all(b > a for a, b in rounds)
    assert rounds[0][1] == tbt.FIRST_ROUND or len(rounds) == 1
    for (a, b), (c, d) in zip(rounds, rounds[1:]):
        if (c, d) != rounds[-1]:
            assert d == c * tbt.ROUND_GROWTH
        else:
            assert d - c >= b - a
    assert len(rounds) <= tbt._MAX_ROUNDS


# ----------------------- the stream entry points -------------------------


@pytest.fixture(scope="module")
def grid_case():
    """The 70 x 70 grid (9,800 triangles; more than 128 clusters, so the
    JAX package takes its windowed path and presorts), its accel in both
    packages and 2,048 generic segments toward it (every ninth masked)."""
    tris = grid_tris(70)
    ja = jst.build_stream_accel(jnp.asarray(tris))
    ta = convert.stream_accel_from_numpy(
        {f: np.asarray(getattr(ja, f)) for f in
         ("blk_tris", "blk_boxes", "top_lo", "top_hi", "perm")},
        device="cpu")
    assert ta.num_blocks * tst.S > 128
    rng = np.random.default_rng(17)
    n = 2048
    o = np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)),
                        rng.uniform(0.3, 1.5, (n, 1))], 1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = rng.uniform(0.2, 3.0, n).astype(np.float32)
    t_max[::9] = -1.0
    return dict(ja=ja, ta=ta, o=o, d=d, t_min=t_min, t_max=t_max)


@pytest.mark.parametrize("presort", [False, True])
def test_closest_stream_xla_matches_jax(grid_case, presort):
    """t within 1e-5, u and v within UV_TOL, triangle ids equal; the
    presorted trace equal to the unsorted one bit for bit."""
    g = grid_case
    o, d = g["o"], g["d"]
    hj = jst.closest_hit_stream_xla(jnp.asarray(o), jnp.asarray(d), g["ja"],
                                    presort=presort)
    ht = tst.closest_hit_stream_xla(t_(o), t_(d), g["ta"], presort=presort)
    hit = np.asarray(hj.t) < 1e29
    assert hit.sum() > len(o) // 3
    np.testing.assert_array_equal(ht.t.numpy() < 1e29, hit)
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    assert close(ht.t.numpy(), hj.t).all()
    for a, b in ((ht.u, hj.u), (ht.v, hj.v)):
        assert close(a.numpy(), b, UV_TOL).all()
    if presort:
        ref = tst.closest_hit_stream_xla(t_(o), t_(d), g["ta"],
                                         presort=False)
        for f in ("t", "tri", "u", "v"):
            assert torch.equal(getattr(ht, f), getattr(ref, f)), f


@pytest.mark.parametrize("presort", [False, True])
def test_any_stream_xla_matches_jax(grid_case, presort):
    """Occlusion equal to JAX's; presorted equal to unsorted bit for bit;
    masked segments never occluded."""
    g = grid_case
    o, d, t_min, t_max = g["o"], g["d"], g["t_min"], g["t_max"]
    oj = np.asarray(jst.any_hit_stream_xla(
        jnp.asarray(o), jnp.asarray(d), g["ja"], jnp.asarray(t_min),
        jnp.asarray(t_max), presort=presort))
    ot = tst.any_hit_stream_xla(t_(o), t_(d), g["ta"], t_(t_min), t_(t_max),
                                presort=presort).numpy()
    assert ot.sum() > len(o) // 4
    assert not ot[t_max < t_min].any()
    np.testing.assert_array_equal(ot, oj)
    if presort:
        unsorted = tst.any_hit_stream_xla(t_(o), t_(d), g["ta"], t_(t_min),
                                          t_(t_max)).numpy()
        np.testing.assert_array_equal(ot, unsorted)
