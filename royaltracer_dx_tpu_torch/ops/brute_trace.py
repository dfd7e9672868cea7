"""Brute-force tracing on the card (counterpart of
royaltracer_dx_tpu/ops/intersect.py:143-235).

``brute_closest`` / ``brute_any`` wrap the hand-written kernels in
``csrc/brute_trace.cu``: every ray against every triangle by
Moller-Trumbore.  A first kernel lists the live rays over the whole batch
(and answers the dead ones); a persistent kernel then takes items, a
group of listed rays times a slice of the triangles, the slice count
chosen on the device from the live count (``slice_plan`` is the same rule
in Python).  For CUDA tensors they launch the kernels (or raise); for CPU
tensors they run the plain versions, ``intersect.closest_hit_brute`` /
``any_hit_brute``, which stay plain tensor code on every device: they are
what the kernels (and the stream, LBVH and MXU kernels) are held against.
The kernels are built with ``-fmad=false`` and take the triangles' edge
planes from torch (``tri_planes``, the subtractions of
``intersect._chunk_planes``), so their t, u, v and triangle ids equal the
plain versions' bit for bit: the plain per-chunk first minimum with a
strict < across chunks is the lowest triangle index among equal smallest
t, which a strict < in index order within a slice and the 64-bit minimum
of ``order_key`` across slices give (``_closest_slices_plain`` is that
merge in torch ops, for the tests).

The rays go in as [N, 3] rows or as three [N] planes of any stride (the
dispatch's planes, read in place), the bounds as [N] tensors of any
stride, one-element tensors or Python numbers (passed by value).

The dispatch (ops/restir.py) sends here every batch for which the JAX
package picks brute force: scenes below ``STREAM_AUTO_MIN_TRIS`` under
"auto", ``traversal="brute"``, and scattered closest-hit batches of fewer
than 2^20 rays on flat-path scenes.
"""

from __future__ import annotations

import ctypes
import numbers
import os
import weakref

import torch

from royaltracer_dx_tpu_torch.ops.intersect import (
    INF,
    Hit,
    _chunk_planes,
    _mt_chunk_planar,
    _mt_terms,
    _ray_setup,
    any_hit_brute,
    as_planes3,
    closest_hit_brute,
)
from royaltracer_dx_tpu_torch.utils.cuda_build import build_library

# the package build's plan constants (csrc/brute_trace.cu THREADS x RAYS,
# MIN_SLICE, ITEMS_PER_CTA, FIRST_ROUND, ROUND_GROWTH): rays an item,
# fewest triangles a slice, items the slice count aims at per resident
# CTA; any hit's first round of triangles and the growth of the next
RAYS_PER_ITEM = 1024
MIN_SLICE = 128
ITEMS_PER_CTA = 4
FIRST_ROUND = 256
ROUND_GROWTH = 4
# counters a round at the head of a launch's scratch, and rounds at most
_N_COUNTERS, _MAX_ROUNDS = 8, 16
# one launch count per kernel, bumped only where the kernel is launched
LAUNCHES = {"brute_closest": 0, "brute_any": 0}
# what a launch's scratch holds first, a round: live rays, items taken
# (items + grid), then the plan the main kernel chose and (any hit) the
# end of the triangles its round took (csrc: C_LIVE ... C_HI)
PLAN_KEYS = ("live", "items_taken", "slices", "slice_len", "groups", "grid",
             "tri_hi")

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "brute_trace.cu")
_LIB = None
BUILD_INFO: dict = {}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the rays: a (pointer, stride) for each origin and direction component,
# then (pointer, stride, value) for t_min and t_max
_RAYS = [_P, _L] * 6 + [_P, _L, _F] * 2
# the C interface of csrc/brute_trace.cu: ctypes argument types by name
_SIGNATURES = {
    "brute_closest": _RAYS + [_P] * 6 + [_I, _I, _P],
    "brute_any": _RAYS + [_P] * 3 + [_I, _I, _P],
    "brute_any_counted": _RAYS + [_P] * 4 + [_I, _I, _P],
    "brute_scratch_bytes": [_I, _I, ctypes.POINTER(_L)],
    "brute_resources": [_I, ctypes.POINTER(_I)],
}
# kernel names of brute_resources' ``which``
_RESOURCE_KINDS = ("brute_closest", "brute_any", "brute_list")


def build_kernels():
    """Build csrc/brute_trace.cu (cuda_build.build_library: nvcc for
    sm_90a, -fmad=false) and load it.  Called at the first launch;
    idempotent."""
    global _LIB
    if _LIB is None:
        lib, info = build_library(_SRC, signatures=_SIGNATURES)
        BUILD_INFO.update(info, resources=kernel_resources(lib))
        _LIB = lib
    return _LIB


def kernel_resources(lib) -> dict:
    """Resident CTAs per SM, registers and spills per thread, threads and
    shared memory (static and dynamic) per CTA, and the persistent grid
    (0 for the list kernel) of each kernel of a built library."""
    out = {}
    for which, name in enumerate(_RESOURCE_KINDS):
        vals = (ctypes.c_int * 6)()
        err = lib.brute_resources(which, vals)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} querying resources")
        out[name] = dict(ctas_per_sm=vals[0], registers=vals[1],
                         threads=vals[2], shared_bytes=vals[3],
                         local_bytes=vals[4], grid=vals[5])
    return out


def slice_plan(live: int, num_tris: int, grid: int) -> dict:
    """The plan the main kernel chooses for ``live`` listed rays on a
    persistent grid of ``grid`` CTAs (csrc/brute_trace.cu plan_of, with
    the package build's constants): groups of RAYS_PER_ITEM rays, slices
    of at least MIN_SLICE triangles, enough items for ITEMS_PER_CTA a
    CTA."""
    groups = -(-live // RAYS_PER_ITEM)
    slices = 1
    if num_tris > 0 and groups > 0:
        most = -(-num_tris // MIN_SLICE)
        want = -(-(ITEMS_PER_CTA * grid) // groups)
        slices = max(1, min(most, want))
    slice_len = -(-num_tris // slices)
    slices = -(-num_tris // slice_len) if slice_len else 1
    return dict(groups=groups, slices=slices, slice_len=slice_len,
                items=groups * slices)


def any_rounds(num_tris: int) -> list:
    """Any hit's rounds of triangles, [start, end) each (csrc
    any_rounds): [0, FIRST_ROUND), then each round up to ROUND_GROWTH
    times the triangles before it, the last (or one whose rest would be
    smaller than it) taking the rest.  Between rounds the rays still
    open are listed again, so that a later round tests only those.  On
    the device the first round takes every triangle where its items
    could not fill the grid (few live rays); the later rounds then have
    no ray."""
    out, a = [], 0
    while a < num_tris:
        b = FIRST_ROUND if a == 0 else a * ROUND_GROWTH
        if b >= num_tris or num_tris - b < b - a or len(out) == \
                _MAX_ROUNDS - 1:
            b = num_tris
        out.append((a, b))
        a = b
    return out


def tri_planes(tri_verts: torch.Tensor) -> torch.Tensor:
    """[T, 12] float32 rows v0, e1 = v1 - v0, e2 = v2 - v0 and three
    zeros: the kernels' triangle layout, with the edges subtracted as
    ``intersect._chunk_planes`` does."""
    tv = tri_verts.to(torch.float32)
    zero = torch.zeros_like(tv[:, 0])
    return torch.cat([tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0],
                      zero], dim=1).contiguous()


# id(tri_verts) -> (a weak reference to it, its version, its planes)
_PLANES: dict = {}


def planes_of(tri_verts: torch.Tensor) -> torch.Tensor:
    """``tri_planes`` of ``tri_verts``, built once for as long as that
    tensor lives unchanged (its version counter moves on any in-place
    write): a scene's triangles are laid out once, not at every batch."""
    key = id(tri_verts)
    got = _PLANES.get(key)
    if (got is not None and got[0]() is tri_verts
            and got[1] == tri_verts._version):
        return got[2]
    planes = tri_planes(tri_verts)
    _PLANES[key] = (weakref.ref(tri_verts,
                                lambda _, k=key: _PLANES.pop(k, None)),
                    tri_verts._version, planes)
    return planes


def _f32(x, what, n, dev):
    if x.dtype != torch.float32:
        raise ValueError(f"brute kernel input {what} {tuple(x.shape)} "
                         f"{x.dtype}: expected float32")
    if x.device != dev:
        raise ValueError("brute kernel inputs must share one device")
    return x


def _components(x, what, n, dev) -> list:
    """(pointer, stride) of each component of [n, 3] contiguous rows or of
    three [n] planes of any stride."""
    if isinstance(x, (tuple, list)):
        if len(x) != 3:
            raise ValueError(f"brute kernel input {what}: 3 planes expected")
        out = []
        for p in x:
            _f32(p, what, n, dev)
            if tuple(p.shape) != (n,):
                raise ValueError(f"brute kernel input {what} plane "
                                 f"{tuple(p.shape)}: expected ({n},)")
            out.append((p.data_ptr(), p.stride(0)))
        return out
    _f32(x, what, n, dev)
    if tuple(x.shape) != (n, 3):
        raise ValueError(f"brute kernel input {what} {tuple(x.shape)}: "
                         f"expected ({n}, 3) float32")
    if not x.is_contiguous():
        raise ValueError("brute kernel inputs must be contiguous")
    return [(x.data_ptr() + 4 * c, 3) for c in range(3)]


def _bound(x, what, n, dev) -> tuple:
    """(pointer, stride, value) of a bound: an [n] tensor of any stride,
    a one-element tensor (stride 0), or a Python number (by value)."""
    if isinstance(x, numbers.Real) and not isinstance(x, bool):
        return None, 0, float(x)
    _f32(x, what, n, dev)
    if x.numel() == 1:
        return x.data_ptr(), 0, 0.0
    if tuple(x.shape) != (n,):
        raise ValueError(f"brute kernel input {what} {tuple(x.shape)}: "
                         f"expected ({n},) float32")
    return x.data_ptr(), x.stride(0), 0.0


def _count(origins) -> tuple:
    first = origins[0] if isinstance(origins, (tuple, list)) else origins
    return first.shape[0], first.device


def _check(origins, dirs, t_min, t_max, tri_verts) -> list:
    """Validate a call; returns the C interface's ray arguments."""
    n, dev = _count(origins)
    t = tri_verts.shape[0]
    _f32(tri_verts, "tri_verts", n, dev)
    if tuple(tri_verts.shape) != (t, 3, 3) or not tri_verts.is_contiguous():
        raise ValueError(f"brute kernel triangles {tuple(tri_verts.shape)}: "
                         "expected contiguous (T, 3, 3) float32")
    if n >= 2**31 or t >= 2**31:
        raise ValueError(f"brute kernels: {n} rays x {t} triangles exceed "
                         "the int32 counts of the C interface")
    args = []
    for x, what in ((origins, "origins"), (dirs, "dirs")):
        for ptr, stride in _components(x, what, n, dev):
            args += [ptr, stride]
    for x, what in ((t_min, "t_min"), (t_max, "t_max")):
        args += list(_bound(x, what, n, dev))
    return args


def _launch(name, dev, rays, *args, lib=None):
    """Launch kernel ``name`` on PyTorch's current stream of ``dev``, made
    the current device for the launch (``lib``: another build of the same
    source).  Returns the scratch, which holds the plan."""
    lib = lib or build_kernels()
    kind = ("brute_closest", "brute_any", "brute_any_counted").index(name)
    n = args[-2]
    nbytes = ctypes.c_longlong()
    lib.brute_scratch_bytes(kind, n, ctypes.byref(nbytes))
    scratch = torch.empty((max(nbytes.value, 8) + 7) // 8, dtype=torch.int64,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*rays, *args[:-2], scratch.data_ptr(),
                                 *args[-2:], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name.removesuffix("_counted")] += 1
    return scratch


def _closest_into(rays, n, dev, tri_verts, lib=None):
    t, u, v = torch.empty((3, n), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int64, device=dev)
    scratch = None
    if n:
        planes = planes_of(tri_verts)
        scratch = _launch("brute_closest", dev, rays, planes.data_ptr(),
                          t.data_ptr(), u.data_ptr(), v.data_ptr(),
                          tri.data_ptr(), n, tri_verts.shape[0], lib=lib)
    return (t, tri, u, v), scratch


def _any_into(rays, n, dev, tri_verts, stats, lib=None):
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    tests = (torch.empty((n,), dtype=torch.int32, device=dev) if stats
             else None)
    scratch = None
    if n:
        planes = planes_of(tri_verts)
        head = [planes.data_ptr(), occ.data_ptr()]
        if stats:
            scratch = _launch("brute_any_counted", dev, rays, *head,
                              tests.data_ptr(), n, tri_verts.shape[0],
                              lib=lib)
        else:
            scratch = _launch("brute_any", dev, rays, *head, n,
                              tri_verts.shape[0], lib=lib)
    return (occ, tests), scratch


def brute_closest(origins, dirs, t_min, t_max, tri_verts):
    """Closest hit of rays ([N, 3] rows or three [N] planes; t_min / t_max
    [N] or scalars) against [T, 3, 3] triangles.  Returns (t, tri int64,
    u, v), each [N]; a miss reads t = INF, tri 0, u = v = 0.  CUDA tensors
    launch the kernels; CPU tensors run ``intersect.closest_hit_brute``."""
    rays = _check(origins, dirs, t_min, t_max, tri_verts)
    n, dev = _count(origins)
    if dev.type != "cuda":
        hit = closest_hit_brute(origins, dirs, tri_verts, t_min, t_max)
        return hit.t, hit.tri, hit.u, hit.v
    return _closest_into(rays, n, dev, tri_verts)[0]


def brute_any(origins, dirs, t_min, t_max, tri_verts, stats: bool = False):
    """Occlusion of rays (as ``brute_closest``'s) against [T, 3, 3]
    triangles.  Returns (occluded bool [N], tests int32 [N] or None): with
    ``stats`` the pairs each ray needs in index order
    (``first_hit_tests``).  CUDA tensors launch the kernels (the counted
    build with ``stats``); CPU tensors run ``intersect.any_hit_brute``."""
    rays = _check(origins, dirs, t_min, t_max, tri_verts)
    n, dev = _count(origins)
    if dev.type != "cuda":
        occ = any_hit_brute(origins, dirs, tri_verts, t_min, t_max)
        tests = (first_hit_tests(origins, dirs, t_min, t_max, tri_verts)
                 if stats else None)
        return occ, tests
    return _any_into(rays, n, dev, tri_verts, stats)[0]


def launch_plan(kind, origins, dirs, t_min, t_max, tri_verts,
                lib=None) -> dict:
    """One launch of ``kind`` ("closest", "any" or "any_counted") on CUDA
    inputs, then the plan its main kernel chose, read back after a
    synchronisation (PLAN_KEYS; any hit's first round, with every round's
    under "rounds", each with its triangles): a diagnostic, not a path of
    the renderer."""
    rays = _check(origins, dirs, t_min, t_max, tri_verts)
    n, dev = _count(origins)
    if dev.type != "cuda":
        raise ValueError("launch_plan needs CUDA inputs")
    if not n:
        return dict(dict.fromkeys(PLAN_KEYS, 0), rounds=[])
    if kind == "closest":
        _, scratch = _closest_into(rays, n, dev, tri_verts, lib)
    else:
        _, scratch = _any_into(rays, n, dev, tri_verts,
                               kind == "any_counted", lib)
    got = scratch.view(torch.int32)[:_N_COUNTERS * _MAX_ROUNDS].view(
        _MAX_ROUNDS, _N_COUNTERS)[:, :len(PLAN_KEYS)].tolist()
    t_count = tri_verts.shape[0]
    spans = ([(0, t_count)] if kind == "closest" else any_rounds(t_count))
    rounds = [dict(zip(PLAN_KEYS, g), tri_lo=a) for g, (a, _) in
              zip(got, spans)]
    if kind == "closest":
        rounds[0]["tri_hi"] = t_count
    first = rounds[0] if rounds else dict.fromkeys(PLAN_KEYS, 0)
    return dict(first, rounds=rounds)


# --------------------- the merge in torch ops (tests) ---------------------


def order_key(t: torch.Tensor) -> torch.Tensor:
    """The kernels' 32-bit merge key of float32 t as int64 (csrc
    key_of's high word): t + 0.0 (-0.0 becomes +0.0), its bits flipped
    so that the keys order as the floats (negative: all bits; else the
    sign bit)."""
    b = (t.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
    b = b & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def _slices(t_count: int, slices: int):
    """[start, end) of each of ``slices`` slices, as the kernels cut
    them."""
    length = -(-t_count // slices) if t_count else 0
    count = -(-t_count // length) if length else 1
    return [(s * length, min(t_count, (s + 1) * length))
            for s in range(count)]


def _pair_terms(o, d, tri_verts, idx):
    """t, u, v of each ray with its own triangle ``idx`` (the finishing
    step's recomputation): [N] each."""
    tv = tri_verts[idx]
    big, u, v, t = _mt_terms(
        tuple(c[:, None] for c in o), tuple(c[:, None] for c in d),
        tuple(tv[:, 0, c][:, None] for c in range(3)),
        tuple((tv[:, 1, c] - tv[:, 0, c])[:, None] for c in range(3)),
        tuple((tv[:, 2, c] - tv[:, 0, c])[:, None] for c in range(3)))
    return t[:, 0], u[:, 0], v[:, 0]


def _closest_slices_plain(origins, dirs, t_min, t_max, tri_verts,
                          slices: int):
    """The closest kernel's merge in torch ops: each slice's running best
    (its own first minimum, a strict < in index order), then the minimum
    over slices of order_key(t) * 2^31 + index (the kernels' 64-bit key
    << 32 | index, in the same order), then t, u and v recomputed from
    the winning pair.  Returns (t, tri int64, u, v)."""
    o, d = as_planes3(origins), as_planes3(dirs)
    n, dev = o[0].shape[0], o[0].device
    lo = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    hi = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    miss = torch.full((n,), 2**63 - 1, dtype=torch.int64, device=dev)
    key = miss
    for a, b in _slices(tri_verts.shape[0], slices):
        h = closest_hit_brute(o, d, tri_verts[a:b], lo, hi)
        k = order_key(h.t) * 2**31 + (a + h.tri)
        key = torch.minimum(key, torch.where(h.t < INF, k, miss))
    hit = (key != miss) & (lo < hi)
    idx = torch.where(hit, key % 2**31, 0)
    # (with no triangle every ray misses: recompute against a zero one)
    t, u, v = _pair_terms(o, d, tri_verts if tri_verts.shape[0] else
                          torch.zeros((1, 3, 3), device=dev), idx)
    zero = torch.zeros_like(t)
    return (torch.where(hit, t, torch.full_like(t, INF)), idx,
            torch.where(hit, u, zero), torch.where(hit, v, zero))


def _first_hit_slices_plain(origins, dirs, t_min, t_max, tri_verts,
                            slices: int):
    """The counted any-hit kernel's merge in torch ops: each slice's
    first ok index, the minimum over slices (the kernels' atomicMin of
    index + 1), then T tests where none is ok and 0 for a dead ray.
    Returns (occluded bool, tests int32)."""
    o, d = as_planes3(origins), as_planes3(dirs)
    n, dev = o[0].shape[0], o[0].device
    t_count = tri_verts.shape[0]
    lo = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    hi = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    first = torch.full((n,), t_count, dtype=torch.int64, device=dev)
    for a, b in _slices(t_count, slices):
        if b == a:
            continue
        _, (v0, e1, e2) = _chunk_planes(tri_verts[a:b], b - a)
        t, _, _ = _mt_chunk_planar(
            tuple(c[:, None] for c in o), tuple(c[:, None] for c in d),
            tuple(p[0] for p in v0), tuple(p[0] for p in e1),
            tuple(p[0] for p in e2), lo[:, None], hi[:, None])
        lane = torch.arange(b - a, device=dev)
        idx = torch.amin(torch.where(t < INF, lane, b - a), dim=1)
        first = torch.minimum(first, torch.where(idx < b - a, a + idx,
                                                 t_count))
    live = lo < hi
    occ = live & (first < t_count)
    tests = torch.where(occ, first + 1, torch.where(live, t_count, 0))
    return occ, tests.to(torch.int32)


def first_hit_tests(origins, dirs, t_min, t_max, tri_verts,
                    chunk: int = 512) -> torch.Tensor:
    """The pairs each ray tests in the any-hit kernel's order, in tensor
    ops: its first ok triangle's index + 1, all T triangles where none is
    ok, 0 for a dead ray (!(t_min < t_max)).  int32 [N]."""
    t_count = tri_verts.shape[0]
    o, d, n, lo, hi, chunk = _ray_setup(origins, dirs, t_min, t_max, chunk,
                                        t_count)
    nc, (v0, e1, e2) = _chunk_planes(tri_verts, chunk)
    first = torch.full((n,), t_count, dtype=torch.int64, device=o[0].device)
    lane = torch.arange(chunk, device=o[0].device)
    for c in range(nc):
        t, _, _ = _mt_chunk_planar(
            o, d, tuple(p[c] for p in v0), tuple(p[c] for p in e1),
            tuple(p[c] for p in e2), lo, hi)
        idx = torch.amin(torch.where(t < INF, lane, chunk), dim=1)
        first = torch.where((idx < chunk) & (first == t_count),
                            c * chunk + idx + 1, first)
    return torch.where(lo[:, 0] < hi[:, 0], first, 0).to(torch.int32)


def mt_stages(origins, dirs, t_min, t_max, tri_verts, tests=None,
              chunk: int = 512) -> dict:
    """How far the pairs of one call get through Moller-Trumbore, in
    tensor ops.  The pairs are each live ray (t_min < t_max) against
    every triangle for closest hit, or, given ``tests`` (each ray's
    ``first_hit_tests``), against its first ``tests`` triangles for any
    hit.  Returns int counts: ``pairs``; ``det``, those with |det| >
    1e-12; ``u``, those also with u >= 0; ``uv``, those also with v >= 0
    and u + v <= 1, which compute t."""
    t_count = tri_verts.shape[0]
    o, d, n, lo, hi, chunk = _ray_setup(origins, dirs, t_min, t_max, chunk,
                                        t_count)
    nc, (v0, e1, e2) = _chunk_planes(tri_verts, chunk)
    dev = o[0].device
    live = (lo < hi)[:, 0]
    want = (torch.full((n,), t_count, dtype=torch.int64, device=dev)
            if tests is None else tests.to(torch.int64))
    limit = torch.where(live, want, 0)[:, None]
    lane = torch.arange(chunk, device=dev)[None, :]
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    for c in range(nc):
        big, u, v, _ = _mt_terms(o, d, tuple(p[c] for p in v0),
                                 tuple(p[c] for p in e1),
                                 tuple(p[c] for p in e2))
        tested = c * chunk + lane < limit
        det = tested & big
        u_ok = det & (u >= 0.0)
        uv = u_ok & (v >= 0.0) & (u + v <= 1.0)
        counts += torch.stack([m.sum() for m in (tested, det, u_ok, uv)])
    return dict(zip(("pairs", "det", "u", "uv"), counts.tolist()))


def _as_f32(x):
    if isinstance(x, (tuple, list)):
        return tuple(_as_f32(c) for c in x)
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return x


def _planes(x):
    """Rays as three float32 planes: views of [N, 3] rows of any
    layout, or the planes given."""
    return _as_f32(as_planes3(x))


def closest_hit_brute_traced(origins, dirs, tri_verts, t_min=1e-4,
                             t_max=1e4) -> Hit:
    """``closest_hit_brute`` through ``brute_closest``: [N, 3] rows of any
    layout or planes, scalar or [N] bounds, read where they are (no
    copies of float32 inputs)."""
    t, tri, u, v = brute_closest(_planes(origins), _planes(dirs),
                                 _as_f32(t_min), _as_f32(t_max),
                                 tri_verts.to(torch.float32).contiguous())
    return Hit(t=t, tri=tri, u=u, v=v)


def any_hit_brute_traced(origins, dirs, tri_verts, t_min,
                         t_max) -> torch.Tensor:
    """``any_hit_brute`` through ``brute_any``."""
    return brute_any(_planes(origins), _planes(dirs), _as_f32(t_min),
                     _as_f32(t_max),
                     tri_verts.to(torch.float32).contiguous())[0]
