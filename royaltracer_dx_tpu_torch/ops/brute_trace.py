"""Brute-force tracing on the card (counterpart of
royaltracer_dx_tpu/ops/intersect.py:143-235).

``brute_closest`` / ``brute_any`` wrap the hand-written kernels in
``csrc/brute_trace.cu``: every ray against every triangle by
Moller-Trumbore, one thread a live ray, the triangles staged through
shared memory.  For CUDA tensors they launch the kernels (or raise); for
CPU tensors they run the plain versions, ``intersect.closest_hit_brute`` /
``any_hit_brute``, which stay plain tensor code on every device: they are
what the kernels (and the stream, LBVH and MXU kernels) are held against.
The kernels are built with ``-fmad=false`` and take the triangles' edge
planes from torch (``tri_planes``, the subtractions of
``intersect._chunk_planes``), so their t, u, v and triangle ids equal the
plain versions' bit for bit: the plain per-chunk first minimum with a
strict < across chunks is the lowest triangle index among equal smallest
t, which the kernels' single pass in index order gives.

The dispatch (ops/restir.py) sends here every batch for which the JAX
package picks brute force: scenes below ``STREAM_AUTO_MIN_TRIS`` under
"auto", ``traversal="brute"``, and scattered closest-hit batches of fewer
than 2^20 rays on flat-path scenes.
"""

from __future__ import annotations

import ctypes
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
    closest_hit_brute,
)
from royaltracer_dx_tpu_torch.ops.mxu_trace import prepare_rays
from royaltracer_dx_tpu_torch.ops.stream_trace import MT_OPS, build_library

# rays a CTA of the kernels (csrc/brute_trace.cu THREADS)
RAYS_PER_CTA = 256
# one launch count per kernel, bumped only where the kernel is launched
LAUNCHES = {"brute_closest": 0, "brute_any": 0}
# FP32 operations of a pair by the stage it reaches in the kernels' (and
# the plain version's) order: p and det; 1 / det, o - v0 and u (|det| >
# 1e-12); q, v and u + v (u >= 0); t (v >= 0 and u + v <= 1).  Their sum
# is stream_trace.MT_OPS.
STAGE_OPS = {"pairs": 14, "det": 10, "u": 16, "uv": 6}

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "brute_trace.cu")
_LIB = None
BUILD_INFO: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interface of csrc/brute_trace.cu: ctypes argument types by name
_SIGNATURES = {
    "brute_closest": [_P] * 9 + [_I, _I, _P],
    "brute_any": [_P] * 6 + [_I, _I, _P],
    "brute_any_counted": [_P] * 7 + [_I, _I, _P],
    "brute_resources": [_I, ctypes.POINTER(_I)],
}


def build_kernels():
    """Build csrc/brute_trace.cu (stream_trace.build_library: nvcc for
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
    static shared memory per CTA of each kernel of a built library."""
    out = {}
    for which, name in enumerate(LAUNCHES):
        vals = (ctypes.c_int * 5)()
        err = lib.brute_resources(which, vals)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} querying resources")
        out[name] = dict(ctas_per_sm=vals[0], registers=vals[1],
                         threads=vals[2], shared_bytes=vals[3],
                         local_bytes=vals[4])
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


def _check(origins, dirs, t_min, t_max, tri_verts):
    n = origins.shape[0]
    dev = origins.device
    t = tri_verts.shape[0]
    for x, shape in ((origins, (n, 3)), (dirs, (n, 3)), (t_min, (n,)),
                     (t_max, (n,)), (tri_verts, (t, 3, 3))):
        if x.device != dev:
            raise ValueError("brute kernel inputs must share one device")
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"brute kernel input {tuple(x.shape)} "
                             f"{x.dtype}: expected {shape} float32")
        if not x.is_contiguous():
            raise ValueError("brute kernel inputs must be contiguous")
    if n >= 2**31 or t >= 2**31:
        raise ValueError(f"brute kernels: {n} rays x {t} triangles exceed "
                         "the int32 counts of the C interface")


def _launch(name, origins, *args):
    """Launch kernel ``name`` on PyTorch's current stream of the inputs'
    device, made the current device for the launch."""
    lib = build_kernels()
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = getattr(lib, name)(origins.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name.removesuffix("_counted")] += 1


def brute_closest(origins, dirs, t_min, t_max, tri_verts):
    """Closest hit of [N, 3] rays (t_min / t_max [N]) against [T, 3, 3]
    triangles.  Returns (t, tri int64, u, v), each [N]; a miss reads t =
    INF, tri 0, u = v = 0.  CUDA tensors launch the kernel; CPU tensors
    run ``intersect.closest_hit_brute``."""
    _check(origins, dirs, t_min, t_max, tri_verts)
    if not origins.is_cuda:
        hit = closest_hit_brute(origins, dirs, tri_verts, t_min, t_max)
        return hit.t, hit.tri, hit.u, hit.v
    n, dev = origins.shape[0], origins.device
    t, u, v = (torch.empty((n,), dtype=torch.float32, device=dev)
               for _ in range(3))
    tri = torch.empty((n,), dtype=torch.int64, device=dev)
    if n:
        planes = planes_of(tri_verts)
        _launch("brute_closest", origins, dirs.data_ptr(), t_min.data_ptr(),
                t_max.data_ptr(), planes.data_ptr(), t.data_ptr(),
                u.data_ptr(), v.data_ptr(), tri.data_ptr(), n,
                tri_verts.shape[0])
    return t, tri, u, v


def brute_any(origins, dirs, t_min, t_max, tri_verts, stats: bool = False):
    """Occlusion of [N, 3] rays against [T, 3, 3] triangles.  Returns
    (occluded bool [N], tests int32 [N] or None): with ``stats`` the pairs
    each ray tested in the kernel's order (``first_hit_tests``).  CUDA
    tensors launch the kernel (its counted build with ``stats``); CPU
    tensors run ``intersect.any_hit_brute``."""
    _check(origins, dirs, t_min, t_max, tri_verts)
    if not origins.is_cuda:
        occ = any_hit_brute(origins, dirs, tri_verts, t_min, t_max)
        tests = (first_hit_tests(origins, dirs, t_min, t_max, tri_verts)
                 if stats else None)
        return occ, tests
    n, dev = origins.shape[0], origins.device
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    tests = (torch.empty((n,), dtype=torch.int32, device=dev) if stats
             else None)
    if n:
        planes = planes_of(tri_verts)
        head = [dirs.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
                planes.data_ptr(), occ.data_ptr()]
        if stats:
            _launch("brute_any_counted", origins, *head, tests.data_ptr(), n,
                    tri_verts.shape[0])
        else:
            _launch("brute_any", origins, *head, n, tri_verts.shape[0])
    return occ, tests


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
    return dict(zip(STAGE_OPS, counts.tolist()))


def brute_work(stages: dict, num_tris: int, n_rays: int,
               closest: bool) -> dict:
    """Bytes and FP32 operations of one brute_closest or brute_any call:
    what the answer needs, whatever implements it.  Operations: each pair
    of ``stages`` (``mt_stages``) counted up to the stage it reaches
    (``STAGE_OPS``); ``all_stages_fp32_ops`` counts MT_OPS a pair.
    Bytes: each of the ``n_rays`` rays read once (origin, direction,
    t_min, t_max: 32 B), the triangles' nine planes once, and the outputs
    written once (t, u, v and an int64 id; a byte of occlusion).
    ``staged_bytes`` is what the kernels read from L2: the planes once a
    CTA."""
    ctas = -(-n_rays // RAYS_PER_CTA)
    nbytes = n_rays * 32 + num_tris * 36 + n_rays * (20 if closest else 1)
    ops = sum(STAGE_OPS[k] * stages[k] for k in STAGE_OPS)
    return dict(bytes=nbytes, fp32_ops=ops,
                all_stages_fp32_ops=stages["pairs"] * MT_OPS, **stages,
                lanes=n_rays, staged_bytes=ctas * num_tris * 36)


def closest_hit_brute_traced(origins, dirs, tri_verts, t_min=1e-4,
                             t_max=1e4) -> Hit:
    """``closest_hit_brute`` through ``brute_closest``: AoS or planar rays,
    scalar or [N] bounds."""
    t, tri, u, v = brute_closest(*prepare_rays(origins, dirs, t_min, t_max),
                                 tri_verts.to(torch.float32).contiguous())
    return Hit(t=t, tri=tri, u=u, v=v)


def any_hit_brute_traced(origins, dirs, tri_verts, t_min,
                         t_max) -> torch.Tensor:
    """``any_hit_brute`` through ``brute_any``."""
    return brute_any(*prepare_rays(origins, dirs, t_min, t_max),
                     tri_verts.to(torch.float32).contiguous())[0]
