"""LBVH traversal: closest hit and any hit (port of
royaltracer_dx_tpu/ops/traverse.py).

The JAX package walks the LBVH (ops/bvh.py) in lock step over a batch
inside a ``lax.while_loop``: a dense slab test of every ray against the
S = min(256, P) subtree roots, ordered near to far by a stable argsort;
then per iteration one subtree transition (the next root, unless its
entry is beyond the running best t), up to 4 descend substeps along the
analytic skip links, and one Moller-Trumbore test of a leaf's
``leaf_size`` triangles (the first minimum lane; a later leaf wins only if
strictly closer), capped at 4P + 4S + 64 iterations.

``_closest_plain`` / ``_any_plain`` are that walk written as torch ops,
with a Python loop in place of the ``while_loop``: the CPU path, and what
the kernels are held against.  One deviation, which changes work and not
answers: an EMPTY box -- a node over padding leaves only, stored as
(1e30 | -1e30) -- is missed.  The JAX slab test reads such an inverted box
as an infinite slab, so its walk enters every padding subtree (a padding
root is keyed t_min, ahead of every real one) and tests padding triangles,
which never hit: on sponza, whose 66,321 real leaves pad to 131,072,
that is ~129,000 node and ~258,000 triangle tests a closest lane.  Skipping
them leaves t, u, v and tri unchanged (padding never moves t_best, and the
real subtrees keep their order); only the JAX walk's first-iteration
quirk for t_max > 1e30 (no caller traces with it) could pick another
slot.  ``bvh_closest`` / ``bvh_any`` are the
wrappers of the hand-written CUDA kernels in ``csrc/bvh_traverse.cu``:
for CUDA tensors they launch the kernel (or raise), for CPU tensors they
run the plain version.  A lane's answer depends on that lane alone, so
the kernels walk one ray per thread, on persistent warps that take rays
from a counter in the wrapper's zeroed scratch and walk only live lanes
(the kernel's header note has the design).  ``bvh_work`` turns a call's
per-lane walk counts into the bytes and FP32 operations it needs, for
``stream_trace.bound_ms``.

Hit convention (intersect.Hit, as in JAX): t = INF and tri = 0 on a miss;
tri = perm[slot] of the winning slot; u, v of the winning lane.
"""

from __future__ import annotations

import ctypes
import os

import torch

from royaltracer_dx_tpu_torch.ops.bvh import LBVH
from royaltracer_dx_tpu_torch.ops.intersect import INF, Hit, as_planes3

_DESCEND_SUBSTEPS = 4
_MAX_TOP = 256
_DET_EPS = 1e-12

# one launch count per kernel, bumped only where the kernel is launched
LAUNCHES = {"bvh_closest": 0, "bvh_any": 0}


# ------------------------------ helpers ---------------------------------


def _safe_inv(dirs: torch.Tensor) -> torch.Tensor:
    big = torch.where(dirs >= 0.0, 1e20, -1e20).to(dirs.dtype)
    return torch.where(torch.abs(dirs) > 1e-20, 1.0 / dirs, big)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int64 values in [0, 2^32) (torch has none)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Number of significant bits of x >= 0 (traverse.py:41-49)."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return _popcount32(x)


def _skip_link(node: torch.Tensor) -> torch.Tensor:
    """skip(k): the sibling of the lowest left-child ancestor, 0 past the
    root (traverse.py:52-57): strip the trailing ones of k, then step."""
    x = node + 1
    ctz = _popcount32((x & -x) - 1)
    anc = node >> ctz
    return torch.where(anc <= 1, 0, anc + 1)


def _in_subtree(node: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """True where heap node is root or one of its descendants
    (traverse.py:60-63)."""
    shift = torch.clamp_min(_bitlen(node) - _bitlen(root), 0)
    return (node > 0) & ((node >> shift) == root)


def _slab(bmin, bmax, origin, inv_dir, t_min, t_max):
    """(hit, t_enter) of the slab test (traverse.py:66-74); the max and
    min over the axes are written out, x then y then z, as the kernel
    does (both propagate NaN).  An empty box (min > max) is missed (see
    the module docstring)."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    t_enter = torch.maximum(torch.maximum(torch.maximum(
        lo[..., 0], lo[..., 1]), lo[..., 2]), t_min)
    t_exit = torch.minimum(torch.minimum(torch.minimum(
        hi[..., 0], hi[..., 1]), hi[..., 2]), t_max)
    return (t_enter <= t_exit) & (bmin[..., 0] <= bmax[..., 0]), t_enter


def _top_level(p: int) -> tuple[int, int]:
    """(S, root_base): the S subtree roots are heap ids [S, 2S)."""
    s = min(_MAX_TOP, p)
    return s, s


def max_iters_of(bvh: LBVH) -> int:
    """The walk's iteration cap, 4P + 4S + 64 (traverse.py:130-131)."""
    p = bvh.num_leaves
    return 4 * p + 4 * _top_level(p)[0] + 64


def _dense_top_order(bvh: LBVH, o, inv, t_min, t_max):
    """The S roots slab-tested against every ray and ordered near to far
    by a stable sort, missed roots keyed INF (traverse.py:83-99).
    Returns (order [N, S] root ids, keys [N, S])."""
    s, base = _top_level(bvh.num_leaves)
    roots = bvh.nodes[base:2 * base]
    hit, t_enter = _slab(roots[None, :, :3], roots[None, :, 3:],
                         o[:, None, :], inv[:, None, :], t_min[:, None],
                         t_max[:, None])
    # + 0.0 folds -0.0 into +0.0: the keys compare as XLA's sort does
    key = torch.where(hit, t_enter + 0.0, INF)
    skey, order = torch.sort(key, dim=-1, stable=True)
    return order + base, skey


def _leaf_mt(leaf_rows, leaf_idx, o, d, t_min, t_hi, lanes, ls):
    """Moller-Trumbore of every lane's ray against the ls triangles of
    leaf ``leaf_idx`` (traverse.py:183-205), in the kernel's operation
    order: edges, cross products, then 3-term sums left to right, then
    1/det and the multiplies.  Returns (t [N, ls] with misses at INF,
    u, v)."""
    block = leaf_rows[leaf_idx].reshape(-1, ls, 3, 3)
    v0 = block[..., 0, :]
    e1 = block[..., 1, :] - v0
    e2 = block[..., 2, :] - v0
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    okd = torch.abs(det) > _DET_EPS
    inv_det = torch.where(okd, 1.0 / det, 0.0)
    tx = o[:, 0:1] - v0[..., 0]
    ty = o[:, 1:2] - v0[..., 1]
    tz = o[:, 2:3] - v0[..., 2]
    uu = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (okd & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (t > t_min[:, None]) & (t < t_hi[:, None]) & lanes[:, None])
    return torch.where(ok, t, INF), uu, vv


def _descend(bvh, node, root, pending, o, inv, t_min, t_hi, live, stats):
    """The bounded descend substeps (traverse.py:169-180): a lane walks
    while it has a node and no parked leaf; a walk that leaves the current
    subtree ends it."""
    p = bvh.num_leaves
    for _ in range(_DESCEND_SUBSTEPS):
        walk = (node > 0) & (pending == 0) & live
        safe = torch.clamp_min(node, 1)
        box = bvh.nodes[safe]
        hit_box, _ = _slab(box[:, :3], box[:, 3:], o, inv, t_min, t_hi)
        hit_box = hit_box & walk
        is_leaf = safe >= p
        pending = torch.where(walk & is_leaf & hit_box, safe, pending)
        nxt = torch.where(hit_box & ~is_leaf, 2 * safe, _skip_link(safe))
        nxt = torch.where(_in_subtree(nxt, root), nxt, 0)
        node = torch.where(walk, nxt, node)
        stats[:, 0] += walk
    return node, pending


def _rays(rays: torch.Tensor):
    return rays[:, 0:3], rays[:, 3:6], rays[:, 6], rays[:, 7]


# --------------------------- the plain versions --------------------------


def _closest_plain(rays: torch.Tensor, bvh: LBVH):
    """Closest hit as the JAX lock-step walk (traverse.py:117-233) in torch
    ops.  rays [N, 8] f32 (origin, direction, t_min, t_max).  Returns (tuv
    [N, 3] f32 with t = INF on a miss, tri [N] int32 original ids, 0 on a
    miss, stats [N, 3] int32: walk node tests, triangle tests, root
    transitions)."""
    o, d, t_min, t_max0 = _rays(rays)
    n, dev = rays.shape[0], rays.device
    p, ls = bvh.num_leaves, bvh.leaf_size
    s, _ = _top_level(p)
    max_iters = max_iters_of(bvh)
    inv = _safe_inv(d)
    leaf_rows = bvh.sorted_tris.reshape(p, ls * 9)
    order, t_sorted = _dense_top_order(bvh, o, inv, t_min, t_max0)

    izero = torch.zeros(n, dtype=torch.int64, device=dev)
    slot, node, root, pending = izero, izero, izero + 1, izero
    t_best = t_max0.clone()
    tri = izero - 1
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    stats = torch.zeros((n, 3), dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    yes = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        alive = (node > 0) | (pending > 0) | (slot < s)
        if not bool(alive.any()):
            break
        # subtree transition: the next ordered root, unless its entry is
        # already beaten by t_best (ordered, so then all are)
        need = (node == 0) & (pending == 0) & (slot < s)
        slot_c = torch.clamp_max(slot, s - 1)[:, None]
        t_e = torch.gather(t_sorted, 1, slot_c)[:, 0]
        sub = torch.gather(order, 1, slot_c)[:, 0]
        viable = need & (t_e < t_best)
        exhausted = need & (t_e >= t_best)
        node = torch.where(viable, sub, node)
        root = torch.where(viable, sub, root)
        slot = torch.where(viable, slot + 1, torch.where(exhausted, s, slot))
        stats[:, 2] += need

        node, pending = _descend(bvh, node, root, pending, o, inv, t_min,
                                 t_best, yes, stats)

        lanes = pending > 0
        leaf_idx = torch.where(lanes, pending - p, 0)
        t, uu, vv = _leaf_mt(leaf_rows, leaf_idx, o, d, t_min, t_best,
                             lanes, ls)
        stats[:, 1] += lanes * ls
        best_l = torch.argmin(t, dim=-1)
        t_c = t[rows, best_l]
        better = t_c < t_best
        t_best = torch.where(better, t_c, t_best)
        tri = torch.where(better, leaf_idx * ls + best_l, tri)
        u = torch.where(better, uu[rows, best_l], u)
        v = torch.where(better, vv[rows, best_l], v)
        pending = torch.zeros_like(pending)

    found = tri >= 0
    orig = torch.where(found, bvh.perm[torch.clamp_min(tri, 0)].long(), 0)
    tuv = torch.stack([torch.where(found, t_best, INF), u, v], dim=1)
    return tuv, orig.to(torch.int32), stats.to(torch.int32)


def _any_plain(rays: torch.Tensor, bvh: LBVH):
    """Occlusion as the JAX lock-step walk (traverse.py:236-329) in torch
    ops: the first confirmed hit retires the lane.  Returns (occluded [N]
    int32, 1 = occluded; stats [N, 3] int32: walk node tests, triangle
    tests, root transitions)."""
    o, d, t_min, t_max = _rays(rays)
    n, dev = rays.shape[0], rays.device
    p, ls = bvh.num_leaves, bvh.leaf_size
    s, _ = _top_level(p)
    max_iters = max_iters_of(bvh)
    inv = _safe_inv(d)
    leaf_rows = bvh.sorted_tris.reshape(p, ls * 9)
    order, t_sorted = _dense_top_order(bvh, o, inv, t_min, t_max)

    izero = torch.zeros(n, dtype=torch.int64, device=dev)
    slot, node, root, pending = izero, izero, izero + 1, izero
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    stats = torch.zeros((n, 3), dtype=torch.int64, device=dev)
    for _ in range(max_iters):
        alive = ~occ & ((node > 0) | (pending > 0) | (slot < s))
        if not bool(alive.any()):
            break
        need = (node == 0) & (pending == 0) & (slot < s) & ~occ
        slot_c = torch.clamp_max(slot, s - 1)[:, None]
        t_e = torch.gather(t_sorted, 1, slot_c)[:, 0]
        sub = torch.gather(order, 1, slot_c)[:, 0]
        viable = need & (t_e < INF)
        exhausted = need & ~viable
        node = torch.where(viable, sub, node)
        root = torch.where(viable, sub, root)
        slot = torch.where(viable, slot + 1, torch.where(exhausted, s, slot))
        stats[:, 2] += need

        node, pending = _descend(bvh, node, root, pending, o, inv, t_min,
                                 t_max, ~occ, stats)

        lanes = (pending > 0) & ~occ
        leaf_idx = torch.where(lanes, pending - p, 0)
        t, _, _ = _leaf_mt(leaf_rows, leaf_idx, o, d, t_min, t_max, lanes,
                           ls)
        stats[:, 1] += lanes * ls
        occ = occ | torch.any(t < INF, dim=-1)
        pending = torch.zeros_like(pending)
    return occ.to(torch.int32), stats.to(torch.int32)


# -------------------------- the work of a call ---------------------------

# FP32 operations per slab test (3 x (2 subtracts, 2 multiplies, a min and
# a max) and the 3-way max and min with t_min / t_max) and per triangle
# test (2 edges, 2 cross products, 4 dot products, 1/det, 3 multiplies by
# it and u + v), counted from the code; compares and selects are not
# counted
SLAB_OPS = 24
MT_OPS = 52


def top_scan_tests(rays: torch.Tensor, bvh: LBVH,
                   chunk: int = 1 << 17) -> torch.Tensor:
    """Per lane [N] int64: the top-level slab tests that ordering the S
    subtree roots needs, one scan of them.  A live lane (t_max > t_min)
    with t_max <= 1e30 needs the fewer of S (a test of every root) and a
    left-first DFS of the top tree (heap ids [1, 2S)) that tests a box
    only when every box above it is hit within [t_min, t_max]: a root
    under a missed box cannot be entered before t_max.  Above 1e30 missed
    roots are taken too (keyed 1e30), so all S roots are tested.  Dead
    lanes need none.  The closest kernel's first scan of a lane makes the
    DFS's tests (all 2S - 1 above 1e30), so at least these; rescans come
    on top."""
    o, d, t_min, t_max = _rays(rays)
    s, _ = _top_level(bvh.num_leaves)
    live = t_max > t_min
    out = torch.where(live, s, 0).to(torch.int64)
    lanes = torch.nonzero(live & (t_max <= INF))[:, 0]
    inv = _safe_inv(d)
    for c in range(0, lanes.numel(), chunk):
        ln = lanes[c:c + chunk]
        reach = torch.ones((ln.numel(), 1), dtype=torch.bool,
                           device=rays.device)
        count = torch.ones(ln.numel(), dtype=torch.int64, device=rays.device)
        k = 1
        while k < s:                 # the internal boxes of level log2 k
            box = bvh.nodes[k:2 * k]
            hit, _ = _slab(box[None, :, :3], box[None, :, 3:],
                           o[ln, None, :], inv[ln, None, :],
                           t_min[ln, None], t_max[ln, None])
            reach = (reach & hit).repeat_interleave(2, dim=1)
            count += reach.sum(dim=1)
            k *= 2
        out[ln] = torch.clamp_max(count, s)
    return out


def bvh_work(rays: torch.Tensor, bvh: LBVH, stats: torch.Tensor,
             closest: bool) -> dict:
    """Bytes and FP32 operations one bvh_closest / bvh_any call needs,
    from its inputs and the per-lane stats the kernel wrote.

    Bytes: 32 B of ray read and 16 B (closest: t, u, v, tri) or 4 B (any:
    the flag) written per lane, plus the tree read once (node rows,
    triangles and, for closest, perm).  Operations: the walk's node slab
    tests and triangle tests from the stats and, for closest, the slab
    tests of one root scan (``top_scan_tests``); lanes that cannot hit
    need nothing.  ``dense_top_fp32_ops`` counts S root tests a live
    closest lane instead, the yardstick of the first LBVH kernels'
    measurements, kept to compare with them."""
    n = rays.shape[0]
    p, ls = bvh.num_leaves, bvh.leaf_size
    s, _ = _top_level(p)
    tree = bvh.nodes.numel() * 4 + bvh.sorted_tris.numel() * 4
    if closest:
        tree += bvh.perm.numel() * 4
    node_tests = int(stats[:, 0].sum())
    tri_tests = int(stats[:, 1].sum())
    live = int((rays[:, 7] > rays[:, 6]).sum())
    top = int(top_scan_tests(rays, bvh).sum()) if closest else 0
    dense = live * s if closest else 0
    return dict(bytes=n * 32 + n * (16 if closest else 4) + tree,
                fp32_ops=(top + node_tests) * SLAB_OPS + tri_tests * MT_OPS,
                dense_top_fp32_ops=((dense + node_tests) * SLAB_OPS
                                    + tri_tests * MT_OPS),
                lanes=n, live_lanes=live, top_tests=top,
                node_tests=node_tests, tri_tests=tri_tests,
                roots=int(stats[:, 2].sum()),
                nodes_per_lane=node_tests / max(n, 1),
                tris_per_lane=tri_tests / max(n, 1))


# ----------------------------- CUDA build --------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "bvh_traverse.cu")
_LIB = None
BUILD_INFO: dict = {}
# the C interface of csrc/bvh_traverse.cu: ctypes argument types by name
_SIGNATURES = {
    "bvh_closest": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "bvh_any": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "bvh_resources": [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int)],
}


def build_kernels():
    """Build csrc/bvh_traverse.cu (stream_trace.build_library: nvcc for
    sm_90a, -fmad=false) and load it.  Called at the first launch;
    idempotent."""
    global _LIB
    if _LIB is None:
        from royaltracer_dx_tpu_torch.ops.stream_trace import build_library

        lib, info = build_library(_SRC, signatures=_SIGNATURES)
        res = {}
        for name, occ in (("bvh_closest", 0), ("bvh_any", 1)):
            for stats in (0, 1):
                vals = (ctypes.c_int * 4)()
                err = lib.bvh_resources(occ, stats, vals)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err} querying "
                                       "resources")
                res[name + ("_stats" if stats else "")] = dict(
                    ctas_per_sm=vals[0], registers=vals[1], threads=vals[2],
                    shared_bytes=vals[3])
        BUILD_INFO.update(info, resources=res)
        _LIB = lib
    return _LIB


# ---------------------------- kernel wrappers ----------------------------


def _check(rays: torch.Tensor, bvh: LBVH):
    dev = rays.device
    want = [(rays, torch.float32, (rays.shape[0], 8)),
            (bvh.nodes, torch.float32, (2 * bvh.num_leaves, 6)),
            (bvh.sorted_tris, torch.float32,
             (bvh.num_leaves * bvh.leaf_size, 3, 3)),
            (bvh.perm, torch.int32, (bvh.num_leaves * bvh.leaf_size,))]
    for t, dtype, shape in want:
        if t.device != dev:
            raise ValueError("bvh kernel inputs must share one device")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"bvh kernel input {tuple(t.shape)} {t.dtype}:"
                             f" expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError("bvh kernel inputs must be contiguous")
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError("bvh kernel inputs must be 16-byte aligned")


def _launch(name, rays, bvh, outs, stats):
    """Launch kernel ``name`` with its scratch: two zeroed int64 counters,
    the next ray the persistent warps take and, with ``stats``, the slab
    tests of the closest kernel's root scans.  The inputs' device is the
    current device for the launch (its stream, its SM count).  Returns
    the scratch."""
    lib = build_kernels()
    n = rays.shape[0]
    p, ls = bvh.num_leaves, bvh.leaf_size
    s, _ = _top_level(p)
    counters = torch.zeros(2, dtype=torch.int64, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        st = stats.data_ptr() if stats is not None else None
        if name == "bvh_closest":
            err = lib.bvh_closest(
                rays.data_ptr(), bvh.nodes.data_ptr(),
                bvh.sorted_tris.data_ptr(), bvh.perm.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), st,
                counters.data_ptr(), n, p, ls, s, max_iters_of(bvh), stream)
        else:
            err = lib.bvh_any(
                rays.data_ptr(), bvh.nodes.data_ptr(),
                bvh.sorted_tris.data_ptr(), outs[0].data_ptr(), st,
                counters.data_ptr(), n, p, ls, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1
    return counters


def bvh_closest(rays: torch.Tensor, bvh: LBVH, stats: bool = False):
    """Closest hit of rays [N, 8] f32 (origin, direction, t_min, t_max)
    through the LBVH.  Returns (tuv [N, 3] f32, tri [N] int32, stats [N,
    3] int32 or None): the Hit convention of the module docstring.  CUDA
    tensors launch the kernel; CPU tensors run the plain version (whose
    stats are always computed)."""
    _check(rays, bvh)
    if not rays.is_cuda:
        return _closest_plain(rays, bvh)
    n = rays.shape[0]
    tuv = torch.empty((n, 3), dtype=torch.float32, device=rays.device)
    tri = torch.empty((n,), dtype=torch.int32, device=rays.device)
    st = (torch.empty((n, 3), dtype=torch.int32, device=rays.device)
          if stats else None)
    if n:
        _launch("bvh_closest", rays, bvh, (tuv, tri), st)
    return tuv, tri, st


def bvh_any(rays: torch.Tensor, bvh: LBVH, stats: bool = False):
    """Occlusion of rays [N, 8] through the LBVH.  Returns (occluded [N]
    int32, stats [N, 3] int32 or None).  Lanes with t_max <= t_min are
    never occluded.  CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check(rays, bvh)
    if not rays.is_cuda:
        return _any_plain(rays, bvh)
    n = rays.shape[0]
    occ = torch.empty((n,), dtype=torch.int32, device=rays.device)
    st = (torch.empty((n, 3), dtype=torch.int32, device=rays.device)
          if stats else None)
    if n:
        _launch("bvh_any", rays, bvh, (occ,), st)
    return occ, st


# ------------------------------- tracing --------------------------------


def pack_rays(origins, dirs, t_min, t_max) -> torch.Tensor:
    """[N, 8] f32 kernel rows from [N, 3] arrays or planar 3-tuples and
    scalar or [N] bounds."""
    o = torch.stack(as_planes3(origins), dim=1).to(torch.float32)
    d = torch.stack(as_planes3(dirs), dim=1).to(torch.float32)
    n, dev = o.shape[0], o.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    return torch.cat([o, d, t_min[:, None], t_max[:, None]], 1).contiguous()


def closest_hit_bvh(origins, dirs, bvh: LBVH, t_min=1e-4,
                    t_max=1e4) -> Hit:
    """Closest hit through the LBVH (traverse.py:117-233)."""
    tuv, tri, _ = bvh_closest(pack_rays(origins, dirs, t_min, t_max), bvh)
    return Hit(t=tuv[:, 0], tri=tri.long(), u=tuv[:, 1], v=tuv[:, 2])


def any_hit_bvh(origins, dirs, bvh: LBVH, t_min, t_max) -> torch.Tensor:
    """Boolean occlusion through the LBVH (traverse.py:236-329)."""
    occ, _ = bvh_any(pack_rays(origins, dirs, t_min, t_max), bvh)
    return occ > 0
