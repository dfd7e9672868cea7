"""Tile-clustered traversal: closest hit and any hit (port of
royaltracer_dx_tpu/ops/cluster_traverse.py).

Build (``build_clusters``, :63-106): triangles are ordered by the Morton
code of their centroid (a stable sort) and grouped into clusters of
``group`` triangles, each stored as a [9, G] record (v0, e1, e2,
component-major) with its AABB.  Padding triangles are all zeros (their
determinant is 0, so they never hit) with ``tri_index`` 0; an empty
cluster is boxed at the centroid minimum.

A query runs in two phases over tiles of ``tile`` consecutive rays of
the batch (the JAX package's tiles, so a tile's answer is JAX's):

  phase A  every ray slab-tests every cluster box; per (tile, cluster)
           the OR of the rays' overlaps and the least entry t
           (``_tile_cluster_mask``, :109-151; ``mask_mode="interval"``
           bounds each tile by interval arithmetic instead, :185-243).
           Each tile's clusters are then ordered by (entry, cluster id)
           with a stable sort, and ``count`` is the number it overlaps.
  phase B  a tile takes its clusters in that order and runs
           Moller-Trumbore of its rays against each cluster's G
           triangles (``_mt_tile``, :154-182).  Closest hit: within a
           cluster the first minimum lane wins, a later cluster only if
           strictly closer; before each step the tile retires unless
           ``k < count`` and the step's entry is below the largest
           min(best t, t_max) of its rays (:327-334; NaN propagates, so
           a NaN t_max retires the tile).  Any hit: the tile retires when
           its list ends or every ray is occluded.

The retire rule is part of the answer: a computed slab entry can exceed a
computed Moller-Trumbore t by an ulp (axis-aligned geometry), so which
clusters get tested can decide a hit.  The JAX package's busiest-first
tile permutation (:306) changes no tile's answer; the kernels take the
tiles in that order (``tile_order``) so that the longest walks start
first.  Its shrinking-prefix schedule (:259-264, :336-382) serves only the
TPU's lock step and is not ported.  The tie order of the JAX sort
(``lax.sort``, not stable) is replaced by cluster id.

``cluster_mask`` (exact phase A), ``cluster_closest`` and ``cluster_any``
(phase B) are the wrappers of the hand-written CUDA kernels in
``csrc/cluster_traverse.cu``: for CUDA tensors they launch the kernel (or
raise), for CPU tensors they run the plain versions here, which repeat
the JAX arithmetic in the kernels' operation order.  The interval mask
and the worklist sort are torch ops on both.

The phase A kernel gives ``_mask_plain``'s tables bit for bit while it
tests far less than every ray against every box, on four premises of the
semantics (tests/test_torch_cluster_mask.py holds them on the plain
version): (a) a ray with !(t_min <= t_max), NaN included, overlaps no
box, so it leaves before any test (a ray with t_min == t_max can
overlap); (b) the OR and the least entry do not depend on the order of
a tile's rays (no entry is NaN, -0.0 is folded), so the kernel lists a
tile's live rays in any order and a thread owns a (tile, cluster) pair,
running over them; (c) a ray with finite origin and direction against a
finite box makes no NaN slab value, so fminf / fmaxf give the tables of
the NaN-propagating min / max; (d) against a box with lo <= hi the
slab's entry plane is lo or hi by the sign of the ray's inv alone
(rounding is monotone), so the rays are listed by direction octant and
each octant's near and far planes are picked once.  Other rays and boxes
take the exact test.

Hit convention (intersect.Hit, as in JAX): t = INF, tri = 0 and u = v = 0
on a miss.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from royaltracer_dx_tpu_torch.ops.bvh import morton_codes
from royaltracer_dx_tpu_torch.ops.intersect import INF, Hit, as_planes3
from royaltracer_dx_tpu_torch.ops.traverse import _rays, pack_rays
from royaltracer_dx_tpu_torch.utils.cuda_build import build_library

_DET_EPS = 1e-12
_BIG = 3.0e38
# the kernels' limits: a tile's rays and two [9, G] records with their G
# ids staged in shared memory (up to 132 KB)
MAX_TILE = 1024
MAX_GROUP = 1024

# one launch count per kernel, bumped only where the kernel is launched
LAUNCHES = {"cluster_mask": 0, "cluster_closest": 0, "cluster_any": 0}


@dataclasses.dataclass
class Clusters:
    """Morton-clustered triangle soup (cluster_traverse.py:45-60)."""

    tri_planes: torch.Tensor  # [C, 9, G] v0/e1/e2 xyz, component-major
    tri_index: torch.Tensor   # [C, G] int32 original triangle id (pad: 0)
    aabb_lo: torch.Tensor     # [C, 3]
    aabb_hi: torch.Tensor     # [C, 3]

    @property
    def num_clusters(self) -> int:
        return self.tri_planes.shape[0]

    @property
    def group(self) -> int:
        return self.tri_planes.shape[2]


def _check_limits(tile: int, group: int) -> None:
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"cluster_tile={tile}: the cluster kernels take 1 "
                         f"to {MAX_TILE} rays a tile")
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"cluster_group={group}: the cluster kernels take "
                         f"1 to {MAX_GROUP} triangles a cluster")


# ------------------------------- build ----------------------------------


def build_clusters(tri_verts: torch.Tensor, group: int = 128) -> Clusters:
    """Cluster [T, 3, 3] triangles by centroid Morton order, on their
    device (cluster_traverse.py:63-106).  The centroid is ((v0 + v1) + v2)
    / 3 with a true division, as numpy's mean computes it (``Tensor.mean``
    and a division by a Python scalar multiply by 1/3 on CUDA, which can
    move a centroid by an ulp and with it the order)."""
    tv = tri_verts.to(torch.float32)
    dev = tv.device
    if dev.type == "cuda":
        _check_limits(1, group)
    t_count = tv.shape[0]
    three = torch.full((), 3.0, dtype=torch.float32, device=dev)
    centroid = torch.div(tv[:, 0] + tv[:, 1] + tv[:, 2], three)
    lo = torch.amin(centroid, dim=0)
    hi = torch.amax(centroid, dim=0)
    order = torch.argsort(morton_codes(centroid, lo, hi), stable=True)
    pad = (-t_count) % group
    c = (t_count + pad) // group
    order_p = torch.cat([order, torch.full((pad,), -1, dtype=order.dtype,
                                           device=dev)])
    real = order_p >= 0
    tv_sorted = torch.cat([tv[order], torch.zeros((pad, 3, 3),
                                                  dtype=tv.dtype,
                                                  device=dev)])
    tri_index = torch.where(real, order_p, 0).to(torch.int32).reshape(c,
                                                                      group)
    v0 = tv_sorted[:, 0]
    planes = torch.cat([v0, tv_sorted[:, 1] - v0, tv_sorted[:, 2] - v0],
                       dim=1)                                  # [T', 9]
    tri_planes = planes.reshape(c, group, 9).permute(0, 2, 1)  # [C, 9, G]
    tvc = tv_sorted.reshape(c, group, 3, 3)
    real_c = real.reshape(c, group)[..., None, None]
    big = torch.full((), _BIG, dtype=torch.float32, device=dev)
    aabb_lo = torch.where(real_c, tvc, big).amin(dim=(1, 2))
    aabb_hi = torch.where(real_c, tvc, -big).amax(dim=(1, 2))
    empty = ~real.reshape(c, group).any(dim=1)[:, None]
    aabb_lo = torch.where(empty, lo, aabb_lo)
    aabb_hi = torch.where(empty, lo, aabb_hi)
    return Clusters(tri_planes=tri_planes.contiguous(),
                    tri_index=tri_index.contiguous(),
                    aabb_lo=aabb_lo.contiguous(),
                    aabb_hi=aabb_hi.contiguous())


# ------------------------------ phase A ---------------------------------

# clusters per step of the plain exact mask: bounds its [N, block]
# temporaries (cluster_traverse.py:118 scans in blocks of 128 too)
_MASK_BLOCK = 128


def _mask_plain(rows: torch.Tensor, cl: Clusters, tile: int):
    """Exact phase A (cluster_traverse.py:109-151) in torch ops, in
    blocks of clusters.  rows [N_pad, 8].  Returns (mask [tiles, C] bool,
    entry [tiles, C] f32: the least slab entry over the tile's
    overlapping rays, INF where none; -0.0 reads as +0.0)."""
    o, d, t_min, t_max = _rays(rows)
    n = rows.shape[0]
    tiles = n // tile
    inv = torch.where(torch.abs(d) > 1e-12, 1.0 / d,
                      torch.full_like(d, _BIG))
    masks, entries = [], []
    for b0 in range(0, cl.num_clusters, _MASK_BLOCK):
        lo = cl.aabb_lo[b0:b0 + _MASK_BLOCK]
        hi = cl.aabb_hi[b0:b0 + _MASK_BLOCK]
        tn = t_min[:, None]
        tf = t_max[:, None]
        for c in range(3):
            t0 = (lo[None, :, c] - o[:, c:c + 1]) * inv[:, c:c + 1]
            t1 = (hi[None, :, c] - o[:, c:c + 1]) * inv[:, c:c + 1]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        overlap = (tn <= tf).reshape(tiles, tile, -1)
        entry = torch.where(overlap, tn.reshape(tiles, tile, -1) + 0.0, INF)
        masks.append(torch.any(overlap, dim=1))
        entries.append(torch.amin(entry, dim=1))
    return torch.cat(masks, dim=1), torch.cat(entries, dim=1)


def _mask_interval(rows: torch.Tensor, cl: Clusters, tile: int):
    """Interval phase A (cluster_traverse.py:185-243): per-tile bounds by
    interval arithmetic, a superset of the exact mask.  Torch ops on
    every device (O(tiles x C) work)."""
    o, d, t_min, t_max = _rays(rows)
    tiles = rows.shape[0] // tile

    def tile_minmax(a):
        a = a.reshape(tiles, tile)
        return (torch.amin(a, dim=1, keepdim=True),
                torch.amax(a, dim=1, keepdim=True))

    big = torch.full((), _BIG, dtype=torch.float32, device=rows.device)
    one = torch.ones((), dtype=torch.float32, device=rows.device)
    tn = tile_minmax(t_min)[0]
    tf = tile_minmax(t_max)[1]
    for c in range(3):
        o_lo, o_hi = tile_minmax(o[:, c])
        d_lo, d_hi = tile_minmax(d[:, c])
        lo = cl.aabb_lo[None, :, c]
        hi = cl.aabb_hi[None, :, c]
        unconstrained = (d_lo <= 0.0) & (d_hi >= 0.0)
        i1 = 1.0 / torch.where(unconstrained, one, d_hi)
        i2 = 1.0 / torch.where(unconstrained, one, d_lo)
        a1, a2 = lo - o_hi, lo - o_lo
        b1, b2 = hi - o_hi, hi - o_lo
        prods = [a1 * i1, a1 * i2, a2 * i1, a2 * i2,
                 b1 * i1, b1 * i2, b2 * i1, b2 * i2]
        p_min = prods[0]
        p_max = prods[0]
        for p in prods[1:]:
            p_min = torch.minimum(p_min, p)
            p_max = torch.maximum(p_max, p)
        tn = torch.maximum(tn, torch.where(unconstrained, -big, p_min))
        tf = torch.minimum(tf, torch.where(unconstrained, big, p_max))
    mask = tn <= tf
    return mask, torch.where(mask, tn, INF)


def tile_order(count: torch.Tensor) -> torch.Tensor:
    """The tiles busiest first: [tiles] int64 tile indices by count,
    descending, ties in tile order (a stable library sort; the JAX
    package's ``perm = argsort(-count)``, cluster_traverse.py:306)."""
    return torch.argsort(count, descending=True, stable=True)


def worklists(mask: torch.Tensor, entry: torch.Tensor):
    """Each tile's clusters near to far: (wl [tiles, C] int32 cluster
    ids, went [tiles, C] f32 their entries, count [tiles] int32 the
    overlapped ones), a stable sort by entry over ids in ascending order
    (-0.0 folded into +0.0, so the keys compare as floats do).  Library
    sorts carry it, as ``lax.sort`` does in the JAX package."""
    went, wl = torch.sort(entry + 0.0, dim=1, stable=True)
    count = mask.sum(dim=1, dtype=torch.int32)
    return wl.to(torch.int32).contiguous(), went.contiguous(), count


# ------------------------------ phase B ---------------------------------

# elements of the plain phase B's [tiles, R, G] temporaries per group of
# tiles: ~64 MB each, whatever the batch
_PLAIN_ELEMS = 1 << 24


def _mt_tile(o, d, planes, t_min, t_max):
    """Moller-Trumbore of [A, R] rays against [A, 9, G] records
    (cluster_traverse.py:154-182), in the kernels' operation order.
    o, d: [A, R, 3]; t_min, t_max: [A, R].  Returns (t [A, R, G] with
    misses at INF, u, v)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        planes[:, c, None, :] for c in range(9))
    ox, oy, oz = (o[..., c:c + 1] for c in range(3))
    dx, dy, dz = (d[..., c:c + 1] for c in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    okd = torch.abs(det) > _DET_EPS
    inv_det = torch.where(okd, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min[..., None]) & (t < t_max[..., None]))
    return torch.where(ok, t, INF), u, v


def _phase_b_plain(rows, cl: Clusters, wl, went, count, tile: int,
                   occlusion: bool):
    """Phase B in torch ops over groups of tiles (tiles are independent),
    each group in lock step over the steps of its tiles still walking.
    Returns (closest: tuv [N_pad, 3], tri [N_pad] int32; any: occ [N_pad]
    int32), stats [tiles, 2] int64: per tile the steps it took and the
    triangle tests its answer needs (a live ray, t_min < t_max, tests G
    triangles a step; for any hit only until its first hit and not once
    occluded)."""
    tiles = rows.shape[0] // tile
    step = max(1, _PLAIN_ELEMS // (tile * cl.group))
    parts = [_phase_b_group(rows[t0 * tile:(t0 + g) * tile], cl,
                            wl[t0:t0 + g],
                            None if occlusion else went[t0:t0 + g],
                            count[t0:t0 + g], tile, occlusion)
             for t0 in range(0, tiles, step)
             for g in [min(step, tiles - t0)]]
    return tuple(torch.cat(p) for p in zip(*parts))


def _phase_b_group(rows, cl: Clusters, wl, went, count, tile: int,
                   occlusion: bool):
    dev = rows.device
    tiles = rows.shape[0] // tile
    g = cl.group
    o, d, t_min, t_max = (x.reshape(tiles, tile, *x.shape[1:])
                          for x in _rays(rows))
    lane = torch.arange(g, device=dev)
    best = torch.full((tiles, tile), INF, dtype=torch.float32, device=dev)
    tri = torch.zeros((tiles, tile), dtype=torch.int32, device=dev)
    bu = torch.zeros((tiles, tile), dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    occ = torch.zeros((tiles, tile), dtype=torch.bool, device=dev)
    live = t_min < t_max
    steps = torch.zeros(tiles, dtype=torch.int64, device=dev)
    tests = torch.zeros(tiles, dtype=torch.int64, device=dev)
    count = count.long()
    walking = torch.ones(tiles, dtype=torch.bool, device=dev)
    for k in range(wl.shape[1]):
        if occlusion:
            more = ~torch.all(occ, dim=1)
        else:
            bound = torch.amax(torch.minimum(best, t_max), dim=1)
            more = went[:, k] < bound
        walking = walking & (k < count) & more
        ci = torch.nonzero(walking)[:, 0]
        if ci.numel() == 0:
            break
        cid = wl[ci, k].long()
        t, u, v = _mt_tile(o[ci], d[ci], cl.tri_planes[cid], t_min[ci],
                           t_max[ci])
        steps[ci] += 1
        if occlusion:
            hit = t < INF
            first = torch.amin(torch.where(hit, lane, g), dim=-1)
            need = torch.where(first < g, first + 1, g)
            tests[ci] += (need * (live[ci] & ~occ[ci])).sum(dim=1)
            occ[ci] |= torch.any(hit, dim=-1)
            continue
        tests[ci] += live[ci].sum(dim=1) * g
        t_c = torch.amin(t, dim=-1)
        # the first minimum lane, as argmin picks it (:355-356); its u, v
        # as the JAX package's masked sums give them (-0.0 reads as +0.0)
        idx = torch.amin(torch.where(t <= t_c[..., None], lane, g), dim=-1)
        better = t_c < best[ci]
        best[ci] = torch.where(better, t_c, best[ci])
        tri[ci] = torch.where(better, torch.gather(
            cl.tri_index[cid], 1, idx), tri[ci])
        bu[ci] = torch.where(better, torch.gather(u, -1, idx[..., None])[
            ..., 0] + 0.0, bu[ci])
        bv[ci] = torch.where(better, torch.gather(v, -1, idx[..., None])[
            ..., 0] + 0.0, bv[ci])
    stats = torch.stack([steps, tests], dim=1)
    if occlusion:
        return occ.reshape(-1).to(torch.int32), stats
    tuv = torch.stack([best, bu, bv], dim=-1).reshape(-1, 3)
    return tuv, tri.reshape(-1), stats


# ----------------------------- CUDA build --------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "cluster_traverse.cu")
_LIB = None
BUILD_INFO: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interface of csrc/cluster_traverse.cu: ctypes argument types by name
_SIGNATURES = {
    "cluster_mask": [_P] * 5 + [_I] * 3 + [_P],
    "cluster_closest": [_P] * 11 + [_I] * 4 + [_P],
    "cluster_any": [_P] * 8 + [_I] * 4 + [_P],
    "cluster_resources": [_I, _I, ctypes.POINTER(_I)],
    "cluster_mask_resources": [_I, _I, ctypes.POINTER(_I)],
}


def _resources(vals) -> dict:
    return dict(ctas_per_sm=vals[0], registers=vals[1], threads=vals[2],
                shared_bytes=vals[3], local_bytes=vals[4])


def build_kernels():
    """Build csrc/cluster_traverse.cu (cuda_build.build_library: nvcc
    for sm_90a, -fmad=false) and load it.  Called at the first launch;
    idempotent."""
    global _LIB
    if _LIB is None:
        lib, info = build_library(_SRC, signatures=_SIGNATURES)
        res = {}
        for which, name in enumerate(LAUNCHES):
            vals = (ctypes.c_int * 5)()
            # resources at the default 128 rays a tile and 128 triangles
            err = lib.cluster_resources(which, 128, vals)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err} querying "
                                   "resources")
            res[name] = _resources(vals)
        BUILD_INFO.update(info, resources=res)
        _LIB = lib
    return _LIB


def mask_resources(tile: int, c: int) -> dict:
    """What the CUDA runtime reports for ``cluster_mask``'s kernel at
    ``tile`` rays a tile and ``c`` clusters (its shared memory and so its
    resident CTAs depend on both): as ``BUILD_INFO["resources"]``."""
    vals = (ctypes.c_int * 5)()
    err = build_kernels().cluster_mask_resources(tile, c, vals)
    if err != 0:
        raise RuntimeError(f"cluster_mask: CUDA error {err} querying "
                           "resources")
    return _resources(vals)


# ---------------------------- kernel wrappers ----------------------------


def _check(rows: torch.Tensor, cl: Clusters, tile: int, *extra):
    dev = rows.device
    c, g = cl.num_clusters, cl.group
    n_pad = rows.shape[0]
    if tile < 1 or n_pad % tile:
        raise ValueError(f"rows: {n_pad} lanes is not a multiple of the "
                         f"tile ({tile})")
    want = [(rows, torch.float32, (n_pad, 8)),
            (cl.tri_planes, torch.float32, (c, 9, g)),
            (cl.tri_index, torch.int32, (c, g)),
            (cl.aabb_lo, torch.float32, (c, 3)),
            (cl.aabb_hi, torch.float32, (c, 3)), *extra]
    for t, dtype, shape in want:
        if t.device != dev:
            raise ValueError("cluster kernel inputs must share one device")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"cluster kernel input {tuple(t.shape)} "
                             f"{t.dtype}: expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError("cluster kernel inputs must be contiguous")
    if dev.type == "cuda":
        _check_limits(tile, g)
        if rows.data_ptr() % 16:
            raise ValueError("cluster kernel rows must be 16-byte aligned")


def _launch(name, rows, *args):
    """Launch kernel ``name`` on PyTorch's current stream of the inputs'
    device, made the current device for the launch."""
    lib = build_kernels()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = getattr(lib, name)(rows.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


def _schedule(count: torch.Tensor):
    """A phase B launch's tile order and its zeroed position counter."""
    return tile_order(count), torch.zeros(1, dtype=torch.int64,
                                          device=count.device)


def cluster_mask(rows: torch.Tensor, cl: Clusters, tile: int):
    """Exact phase A.  rows [N_pad, 8] f32 (origin, direction, t_min,
    t_max), N_pad a multiple of ``tile``.  Returns (mask [tiles, C]
    bool, entry [tiles, C] f32).  CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    _check(rows, cl, tile)
    if not rows.is_cuda:
        return _mask_plain(rows, cl, tile)
    tiles, c = rows.shape[0] // tile, cl.num_clusters
    mask = torch.empty((tiles, c), dtype=torch.bool, device=rows.device)
    entry = torch.empty((tiles, c), dtype=torch.float32, device=rows.device)
    if tiles and c:
        _launch("cluster_mask", rows, cl.aabb_lo.data_ptr(),
                cl.aabb_hi.data_ptr(), mask.data_ptr(), entry.data_ptr(),
                tiles, tile, c)
    return mask, entry


def cluster_closest(rows: torch.Tensor, cl: Clusters, wl, went, count,
                    tile: int, stats: bool = False):
    """Closest-hit phase B over the worklists of ``worklists``.  Returns
    (tuv [N_pad, 3] f32, tri [N_pad] int32, stats [tiles, 2] int64 or
    None): the Hit convention of the module docstring; stats as
    ``_phase_b_plain`` gives them.  CUDA tensors launch the kernel (its
    stats build with ``stats``); CPU tensors run the plain version (whose
    stats are always computed)."""
    tiles = rows.shape[0] // max(tile, 1)
    c = cl.num_clusters
    _check(rows, cl, tile, (wl, torch.int32, (tiles, c)),
           (went, torch.float32, (tiles, c)), (count, torch.int32, (tiles,)))
    if not rows.is_cuda:
        return _phase_b_plain(rows, cl, wl, went, count, tile, False)
    dev = rows.device
    n_pad = rows.shape[0]
    tuv = torch.empty((n_pad, 3), dtype=torch.float32, device=dev)
    tri = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    out_stats = (torch.empty((tiles, 2), dtype=torch.int64, device=dev)
                 if stats else None)
    if tiles:
        order, counter = _schedule(count)
        _launch("cluster_closest", rows, cl.tri_planes.data_ptr(),
                cl.tri_index.data_ptr(), wl.data_ptr(), went.data_ptr(),
                count.data_ptr(), order.data_ptr(), counter.data_ptr(),
                tuv.data_ptr(), tri.data_ptr(),
                out_stats.data_ptr() if stats else None, tiles, tile, c,
                cl.group)
    return tuv, tri, out_stats


def cluster_any(rows: torch.Tensor, cl: Clusters, wl, count, tile: int,
                stats: bool = False):
    """Any-hit phase B.  Returns (occluded [N_pad] int32, 1 = occluded;
    stats [tiles, 2] int64 or None, as ``cluster_closest``).  CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    tiles = rows.shape[0] // max(tile, 1)
    c = cl.num_clusters
    _check(rows, cl, tile, (wl, torch.int32, (tiles, c)),
           (count, torch.int32, (tiles,)))
    if not rows.is_cuda:
        return _phase_b_plain(rows, cl, wl, None, count, tile, True)
    dev = rows.device
    occ = torch.empty((rows.shape[0],), dtype=torch.int32, device=dev)
    out_stats = (torch.empty((tiles, 2), dtype=torch.int64, device=dev)
                 if stats else None)
    if tiles:
        order, counter = _schedule(count)
        _launch("cluster_any", rows, cl.tri_planes.data_ptr(),
                wl.data_ptr(), count.data_ptr(), order.data_ptr(),
                counter.data_ptr(), occ.data_ptr(),
                out_stats.data_ptr() if stats else None, tiles, tile, c,
                cl.group)
    return occ, out_stats


# ------------------------------- tracing --------------------------------


def prepare_rays(origins, dirs, t_min, t_max, tile: int) -> torch.Tensor:
    """[N_pad, 8] kernel rows, padded to whole tiles as ``_pad_rays``
    pads (cluster_traverse.py:248-256): origin 0, direction 1.0, t_min 0
    and t_max -1.0, so a padding lane never hits."""
    rows = pack_rays(origins, dirs, t_min, t_max)
    pad = (-rows.shape[0]) % tile
    if pad:
        fill = torch.tensor([0, 0, 0, 1, 1, 1, 0, -1], dtype=torch.float32,
                            device=rows.device)
        rows = torch.cat([rows, fill.expand(pad, 8)])
    return rows


def tile_worklists(rows: torch.Tensor, cl: Clusters, tile: int,
                   mask_mode: str = "exact"):
    """Phase A and the worklist sort: (wl, went, count)."""
    if mask_mode == "interval":
        mask, entry = _mask_interval(rows, cl, tile)
    elif mask_mode == "exact":
        mask, entry = cluster_mask(rows, cl, tile)
    else:
        raise ValueError(f"mask_mode={mask_mode!r}: 'exact' or 'interval'")
    return worklists(mask, entry)


def closest_hit_clustered(origins, dirs, cl: Clusters, t_min=1e-4,
                          t_max=1e4, tile: int = 128,
                          mask_mode: str = "exact") -> Hit:
    """Closest hit through the clusters (cluster_traverse.py:268-384).
    origins/dirs: [N, 3] or planar 3-tuples; t_min/t_max scalars or
    [N]."""
    rows = prepare_rays(origins, dirs, t_min, t_max, tile)
    n = as_planes3(origins)[0].shape[0]
    wl, went, count = tile_worklists(rows, cl, tile, mask_mode)
    tuv, tri, _ = cluster_closest(rows, cl, wl, went, count, tile)
    return Hit(t=tuv[:n, 0], tri=tri[:n].long(), u=tuv[:n, 1],
               v=tuv[:n, 2])


def any_hit_clustered(origins, dirs, cl: Clusters, t_min, t_max,
                      tile: int = 128, mask_mode: str = "exact"):
    """Boolean occlusion through the clusters (cluster_traverse.py:
    387-464)."""
    rows = prepare_rays(origins, dirs, t_min, t_max, tile)
    n = as_planes3(origins)[0].shape[0]
    wl, _, count = tile_worklists(rows, cl, tile, mask_mode)
    occ, _ = cluster_any(rows, cl, wl, count, tile)
    return occ[:n] > 0
