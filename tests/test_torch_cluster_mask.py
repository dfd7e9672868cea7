"""The premises of the phase A cluster kernel's design (csrc/
cluster_traverse.cu, ``cluster_mask``: dead rays dropped before any test,
a thread per (tile, cluster) over its tile's listed live rays in any
order, the finite rays grouped by direction octant and tested against
their octant's near and far planes with fmaxf / fminf), held on the CPU
by the plain version (ops/cluster_traverse.py::_mask_plain, what the
kernel equals bit for bit on the card) and the JAX package, on
``cluster_cases.mask_case``'s adversarial tiles:

  (a) a ray with !(t_min <= t_max), NaN included, overlaps no box: the
      tables do not change when such rays become padding rows, while a ray
      with t_min == t_max can overlap;
  (b) the tables do not depend on the order of a tile's rays;
  (c) for a ray with finite origin and direction against a finite box,
      fmin / fmax (which drop a NaN) give the tables of the NaN-propagating
      minimum / maximum;
  (d) for such a ray against a box with lo <= hi, the slab's entry is the
      plane its inv's sign names (lo where inv > 0, hi where inv < 0) and
      its exit the other one: rounding is monotone, so min(t0, t1) and
      max(t0, t1) are known before the test;
  a non-finite ray or box, or an inverted one, can tell the forms apart,
  so those take the exact test; and a model of the kernel's loop (the
  octant lists, the least entry kept as NaN while no ray overlaps, -0.0
  folded at the store) gives the plain version's tables.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.ops import cluster_traverse as jct
from royaltracer_dx_tpu_torch.ops import cluster_traverse as tct
from royaltracer_dx_tpu_torch.ops.intersect import INF
from royaltracer_dx_tpu_torch.tools.cluster_cases import mask_case
from test_torch_restir import one_torch_thread  # noqa: F401 (autouse)

# (rays a tile, clusters): one box, menger's 38 and sponza's 2,073 (a
# thread takes several clusters there)
SHAPES = [(16, 38), (16, 1), (8, 2073)]
PAD = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, -1.0])


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    """Two (mask, entry) tables bit for bit."""
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def case(request):
    tile, c = request.param
    rows, cl, live = mask_case("cpu", tile, c)
    return tile, rows, cl, live, tct._mask_plain(rows, cl, tile)


def _slabs(rows, lo, hi, form):
    """tn, tf [N, C] of every ray against every box, in the kernels'
    order.  ``form``: "exact" (minimum / maximum), "fmin" (fmin / fmax in
    their place) or "octant" (fmax / fmin of the planes inv's sign names
    near and far, the kernel's fast test)."""
    o, d, t_min, t_max = rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7]
    inv = torch.where(d.abs() > 1e-12, 1.0 / d, torch.full_like(d, 3.0e38))
    mn, mx = ((torch.minimum, torch.maximum) if form == "exact"
              else (torch.fmin, torch.fmax))
    tn, tf = t_min[:, None], t_max[:, None]
    for a in range(3):
        neg = inv[:, a:a + 1] < 0.0
        planes = lo[None, :, a], hi[None, :, a]
        if form == "octant":
            planes = (torch.where(neg, planes[1], planes[0]),
                      torch.where(neg, planes[0], planes[1]))
        t0 = (planes[0] - o[:, a:a + 1]) * inv[:, a:a + 1]
        t1 = (planes[1] - o[:, a:a + 1]) * inv[:, a:a + 1]
        if form == "octant":
            tn, tf = mx(tn, t0), mn(tf, t1)
        else:
            tn, tf = mx(tn, mn(t0, t1)), mn(tf, mx(t0, t1))
    return tn, tf


def _fast_tables(rows, cl, tile, form="octant"):
    """The tables with the fast test ``form`` for every ray and box."""
    tn, tf = _slabs(rows, cl.aabb_lo, cl.aabb_hi, form)
    ov = (tn <= tf).reshape(-1, tile, tn.shape[1])
    entry = torch.where(ov, tn.reshape(ov.shape) + 0.0, INF)
    return ov.any(dim=1), entry.amin(dim=1)


def _finite_rays(rows):
    return torch.isfinite(rows[:, :6]).all(dim=1)


def _finite_boxes(cl):
    return (torch.isfinite(cl.aabb_lo).all(dim=1)
            & torch.isfinite(cl.aabb_hi).all(dim=1))


def _ordered_boxes(cl):
    """The boxes of the kernel's fast test: finite, lo <= hi."""
    return _finite_boxes(cl) & (cl.aabb_lo <= cl.aabb_hi).all(dim=1)


def test_mask_case_covers_the_kinds(case):
    """Tile k holds k live rays (t_min <= t_max), then whole live tiles;
    NaN, +inf and -inf stand in each of the 8 components, some live
    rays have t_min == t_max, -0.0 bounds, +-0.0 direction components or a
    non-finite component, and some boxes are non-finite."""
    tile, rows, cl, live, (mask, entry) = case
    more = len(live) - tile - 1
    assert live.tolist() == list(range(tile + 1)) + [tile] * more
    for j in range(8):
        col = rows[:, j]
        assert torch.isnan(col).any() and (col == np.inf).any()
        assert (col == -np.inf).any(), j
    lv = rows[:, 6] <= rows[:, 7]
    assert (lv & (rows[:, 6] == rows[:, 7])).any()
    assert (lv & (rows[:, 6].view(torch.int32) == -2**31)).any()
    assert (lv & (rows[:, 3:6].view(torch.int32) == -2**31).any(1)).any()
    assert (lv & ~_finite_rays(rows)).any()
    assert bool(mask.any()) and not bool(mask.all())
    assert bool(((entry == 0.0) & mask).any())
    if cl.num_clusters > 8:
        assert not bool(_finite_boxes(cl).all())


def test_dead_rays_overlap_no_box(case):
    """(a): the rays with !(t_min <= t_max) turned into padding rows leave
    both tables as they were, and alone they overlap nothing; the rays
    with t_min == t_max alone do overlap boxes (the test is <=)."""
    tile, rows, cl, _, want = case
    dead = ~(rows[:, 6] <= rows[:, 7])
    assert dead.any() and (~dead).any()
    only_live = torch.where(dead[:, None], PAD, rows)
    assert _same(tct._mask_plain(only_live, cl, tile), want)
    only_dead = torch.where(dead[:, None], rows, PAD)
    mask, entry = tct._mask_plain(only_dead, cl, tile)
    assert not bool(mask.any()) and bool((entry == INF).all())
    equal = rows[:, 6] == rows[:, 7]
    mask, _ = tct._mask_plain(torch.where(equal[:, None], rows, PAD), cl,
                              tile)
    assert bool(mask.any())


def test_ray_order_within_a_tile(case):
    """(b): any permutation of each tile's rays gives the same tables bit
    for bit, so the kernel may list a tile's live rays in any order."""
    tile, rows, cl, _, want = case
    gen = torch.Generator().manual_seed(3)
    n_t = rows.shape[0] // tile
    perm = torch.argsort(torch.rand(n_t, tile, generator=gen), dim=1)
    perm = (perm + torch.arange(n_t)[:, None] * tile).reshape(-1)
    assert not torch.equal(perm, torch.arange(rows.shape[0]))
    assert _same(tct._mask_plain(rows[perm], cl, tile), want)
    assert _same(tct._mask_plain(rows.flip(0).contiguous(), cl, tile),
                 tuple(t.flip(0) for t in want))


def test_fmin_fmax_on_finite_rays(case):
    """(c): on the live rays with finite origin and direction (the others
    padding), against the finite boxes, fmin / fmax give the plain
    version's tables bit for bit.  The rays there include +-0.0 and 1e-13
    direction components (inv 3e38), origins on box faces, origins at
    +-3e38 (lo - o overflows) and infinite bounds."""
    tile, rows, cl, _, _ = case
    fin = _finite_rays(rows) & (rows[:, 6] <= rows[:, 7])
    sub = torch.where(fin[:, None], rows, PAD)
    d = sub[fin, 3:6]
    assert (d == 0.0).any() and (d.abs() == np.float32(1e-13)).any()
    assert (sub[fin, 0:3].abs() == 3e38).any()
    assert torch.isinf(sub[fin, 6:8]).any()
    boxes = _finite_boxes(cl)
    want = tct._mask_plain(sub, cl, tile)
    got = _fast_tables(sub, cl, tile, "fmin")
    assert _same((want[0][:, boxes], want[1][:, boxes]),
                 (got[0][:, boxes], got[1][:, boxes]))


def test_octant_planes_on_finite_rays(case):
    """(d): on the same rays, against the finite boxes with lo <= hi,
    the octant's near and far planes give the plain version's tables bit
    for bit; rays of every octant are there, and rays whose inv is +3e38
    from a -0.0 or tiny negative direction component count as positive."""
    tile, rows, cl, _, _ = case
    fin = _finite_rays(rows) & (rows[:, 6] <= rows[:, 7])
    sub = torch.where(fin[:, None], rows, PAD)
    d = sub[fin, 3:6]
    assert (d.view(torch.int32) == -2**31).any()
    octants = ((d < -1e-12).long() * torch.tensor([1, 2, 4])).sum(dim=1)
    assert len(torch.unique(octants)) == 8
    boxes = _ordered_boxes(cl)
    want = tct._mask_plain(sub, cl, tile)
    got = _fast_tables(sub, cl, tile)
    assert _same((want[0][:, boxes], want[1][:, boxes]),
                 (got[0][:, boxes], got[1][:, boxes]))


def _one(o, d, t_min, t_max, lo, hi):
    rows = torch.tensor([[*o, *d, t_min, t_max]], dtype=torch.float32)
    cl = tct.Clusters(tri_planes=torch.zeros((1, 9, 1)),
                      tri_index=torch.zeros((1, 1), dtype=torch.int32),
                      aabb_lo=torch.tensor([lo], dtype=torch.float32),
                      aabb_hi=torch.tensor([hi], dtype=torch.float32))
    return rows, cl


@pytest.mark.parametrize("which", ["nan_origin", "inf_direction",
                                   "nan_box", "inverted_box"])
def test_exact_path_outside_the_premises(which):
    """The limits of (c) and (d), where the kernel keeps the exact test:
    a NaN origin component, an infinite direction against a box with an
    infinite side (inv 0 times an infinite lo - o is NaN) and a box with a
    NaN corner overlap nothing in the plain version, while the fast test,
    whose fmax / fmin drop the NaN, finds an overlap; a box with lo > hi
    on an axis overlaps in the plain version (min / max order its planes)
    and not in the fast test."""
    nan, inf = float("nan"), float("inf")
    rows, cl = {
        "nan_origin": _one((nan, 0.5, -1.0), (0.0, 0.0, 1.0), 0.0, 10.0,
                           (0, 0, 0), (1, 1, 1)),
        "inf_direction": _one((0.5, 0.5, 0.5), (inf, 0.0, 1.0), 0.0, 10.0,
                              (-inf, 0, 0), (1, 1, 1)),
        "nan_box": _one((0.5, 0.5, 0.5), (1.0, 0.0, 0.0), 0.0, 10.0,
                        (nan, 0, 0), (1, 1, 1)),
        "inverted_box": _one((-1.0, 0.5, 0.5), (1.0, 0.0, 0.0), 0.0, 10.0,
                             (1, 0, 0), (0, 1, 1)),
    }[which]
    mask, entry = tct._mask_plain(rows, cl, 1)
    fast, _ = _fast_tables(rows, cl, 1)
    overlaps = which == "inverted_box"
    assert bool(mask[0, 0]) == overlaps
    assert bool(entry[0, 0] == INF) != overlaps
    assert bool(fast[0, 0]) != overlaps


def _kernel_model(rows, cl, tile):
    """The kernel's arithmetic per (tile, cluster): the tile's live rays
    listed by bucket (the finite ones by the octant of inv's signs, the
    others after), each bucket in reverse order (any order may come); the
    least overlapping entry kept from NaN (fmin drops it), the octant test
    for a finite ray against a finite box with lo <= hi, the exact one
    otherwise; mask = the entry is not NaN, entry + 0.0 (INF if NaN)."""
    n_t, c = rows.shape[0] // tile, cl.num_clusters
    live = rows[:, 6] <= rows[:, 7]
    d = rows[:, 3:6]
    neg = torch.where(d.abs() > 1e-12, d, 1.0) < 0.0
    octant = (neg.long() * torch.tensor([1, 2, 4])).sum(dim=1)
    key = torch.where(live, torch.where(_finite_rays(rows), octant, 8), 9)
    key = key.reshape(n_t, tile)
    order = torch.argsort(key * tile - torch.arange(tile), dim=1,
                          stable=True)
    listed = rows.reshape(n_t, tile, 8).gather(
        1, order[..., None].expand(n_t, tile, 8))
    keyed = key.gather(1, order)
    boxes = _ordered_boxes(cl)
    m = torch.full((n_t, c), float("nan"))
    for r in range(tile):
        ray = listed[:, r]
        tn_f, tf_f = _slabs(ray, cl.aabb_lo, cl.aabb_hi, "octant")
        tn_e, tf_e = _slabs(ray, cl.aabb_lo, cl.aabb_hi, "exact")
        fast = (keyed[:, r] < 8)[:, None] & boxes[None, :]
        tn = torch.where(fast, tn_f, tn_e)
        tf = torch.where(fast, tf_f, tf_e)
        ov = (tn <= tf) & (keyed[:, r] < 9)[:, None]
        m = torch.where(ov, torch.fmin(m, tn), m)
    mask = ~torch.isnan(m)
    return mask, torch.where(mask, m + 0.0, INF)


def test_kernel_model_matches_plain(case):
    """The model of the kernel's loop equals the plain version bit for
    bit: the -0.0 entries (rays from inside a box with t_min -0.0) are
    stored as +0.0 by both."""
    tile, rows, cl, _, want = case
    assert _same(_kernel_model(rows, cl, tile), want)


def test_mask_case_matches_jax(case):
    """The adversarial rays and boxes through the JAX package's
    ``_tile_cluster_mask``: its mask equals the plain version's and its
    entries equal them as values (it may keep a -0.0 that the port stores
    as +0.0)."""
    tile, rows, cl, _, (mask, entry) = case
    c = cl.num_clusters
    jcl = jct.Clusters(tri_planes=jnp.zeros((c, 9, 1), jnp.float32),
                       tri_index=jnp.zeros((c, 1), jnp.int32),
                       aabb_lo=jnp.asarray(cl.aabb_lo.numpy()),
                       aabb_hi=jnp.asarray(cl.aabb_hi.numpy()))
    r = rows.numpy()
    jm, je = jct._tile_cluster_mask(jnp.asarray(r[:, 0:3]),
                                    jnp.asarray(r[:, 3:6]), jcl,
                                    jnp.asarray(r[:, 6]),
                                    jnp.asarray(r[:, 7]), tile)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(entry.numpy(), np.asarray(je))
