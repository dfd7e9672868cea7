"""The matmul form of Moller-Trumbore (port of
royaltracer_dx_tpu/ops/mxu_trace.py).

Every Moller-Trumbore decision value is a scalar triple product, hence
bilinear in ray features f = [d, o x d, o, 1] (o re-centred about the
scene's AABB midpoint) and a per-triangle [10, 4] coefficient block:

    det   = -d.n                       (n = e1 x e2)
    u*det = (o x d).e2 - d.(e2 x v0)
    v*det = -(o x d).e1 - d.(v0 x e1)
    t*det = o.n - v0.n

The JAX package computes all four for every (ray, triangle) pair as one
[R, 10] @ [10, 4Tp] product per 4096-ray chunk and decides the hit in the
products domain (mxu_trace.py:101-139).  Only 19 of a triangle's 40
coefficients are not structurally zero: det reads rows 0-2, u*det and
v*det rows 0-5, t*det rows 6-9.

``_closest_plain`` / ``_any_plain`` are that function in torch ops with a
fixed summation order: per pair, the nonzero rows k in increasing order,
each an explicit multiply and add (row 9's feature is 1, so its term is
the coefficient itself), the cross product by components.  They are the
CPU path and what the kernels are held against.  ``mxu_closest`` /
``mxu_any`` wrap the hand-written kernels in ``csrc/mxu_trace.cu``, built
with ``-fmad=false`` so that they equal the plain version bit for bit:
for CUDA tensors the public functions launch them (or raise), for CPU
tensors they run the plain version.  Against the JAX package's
``jnp.dot`` the sums run in another order, so the two agree to a
tolerance, not to bits.

The kernels compute det, u*det and v*det on tensor cores in TF32 only
as a conservative filter and confirm every pair it keeps in the plain
order (the source's note derives the margins).  ``_candidates_plain`` is that
filter in torch ops, with the operands rounded as ``cvt.rna.tf32`` does:
the tests hold its margins against the plain products.

Hit convention (JAX's one-hot epilogue): ``tri`` is the FIRST argmin of
t over the padded triangles, so a ray that misses everything returns
t = INF, tri 0 and triangle 0's u, v; u = (a + 0.0) * inv and v = (b +
0.0) * inv with inv = 1 / (det if |det| > 1e-12 else 1) + 0.0 (the
one-hot sums fold -0.0 into +0.0).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from royaltracer_dx_tpu_torch.ops.intersect import INF, Hit, as_planes3
from royaltracer_dx_tpu_torch.utils.cuda_build import build_library

_LANE = 128          # triangle-axis padding (mxu_trace.py:41)
_RAY_CHUNK = 4096    # rays per plain-version step (bounds [R, Tp] temps)
_DET_EPS = 1e-12

# the nonzero coefficient rows of each decision plane: det, u*det, v*det,
# t*det (row 9, the constant feature, is added last where present)
PLANE_ROWS = ((0, 1, 2), (0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5),
              (6, 7, 8, 9))

# one launch count per kernel, bumped only where the kernel is launched
LAUNCHES = {"mxu_closest": 0, "mxu_any": 0}


@dataclasses.dataclass
class MxuTris:
    """Triangle coefficient matrix (mxu_trace.py:48-66): ``coeff`` [10,
    4*Tp] f32 with the planes det, u*det, v*det, t*det blocked along the
    columns; padded triangles are all-zero columns (det = 0: they never
    hit).  ``center`` [3] is subtracted from ray origins at trace time."""

    coeff: torch.Tensor
    center: torch.Tensor
    num_tris: int

    @property
    def padded(self) -> int:
        return self.coeff.shape[1] // 4


def _cross(a, b):
    """Component-wise cross product of two 3-tuples (jnp.cross's order)."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _build_coeff(tri_verts: torch.Tensor, center: torch.Tensor):
    """[10, 4Tp] coefficients (mxu_trace.py:69-88)."""
    t = tri_verts.shape[0]
    tp = -(-t // _LANE) * _LANE
    tv = torch.nn.functional.pad(tri_verts.to(torch.float32),
                                 (0, 0, 0, 0, 0, tp - t))
    v0 = tuple(tv[:, 0, c] - center[c] for c in range(3))
    e1 = tuple(tv[:, 1, c] - tv[:, 0, c] for c in range(3))
    e2 = tuple(tv[:, 2, c] - tv[:, 0, c] for c in range(3))
    n = _cross(e1, e2)
    e2xv0 = _cross(e2, v0)
    v0xe1 = _cross(v0, e1)
    z = torch.zeros_like(n[0])
    vn = v0[0] * n[0] + v0[1] * n[1] + v0[2] * n[2]
    det_col = [-n[0], -n[1], -n[2], z, z, z, z, z, z, z]
    a_col = [-e2xv0[0], -e2xv0[1], -e2xv0[2], *e2, z, z, z, z]
    b_col = [-v0xe1[0], -v0xe1[1], -v0xe1[2], -e1[0], -e1[1], -e1[2],
             z, z, z, z]
    c_col = [z, z, z, z, z, z, *n, -vn]
    return torch.cat([torch.stack(col) for col in (det_col, a_col, b_col,
                                                   c_col)], dim=1)


def build_mxu_tris(tri_verts: torch.Tensor) -> MxuTris:
    """Coefficients of [T, 3, 3] triangles, on their device, centred at
    the triangles' AABB midpoint (mxu_trace.py:91-98).  Refit = rebuild."""
    if tri_verts.shape[0] < 1:
        raise ValueError("build_mxu_tris: no triangles")
    flat = tri_verts.reshape(-1, 3).to(torch.float32)
    center = 0.5 * (flat.amin(dim=0) + flat.amax(dim=0))
    return MxuTris(coeff=_build_coeff(tri_verts, center).contiguous(),
                   center=center.contiguous(),
                   num_tris=int(tri_verts.shape[0]))


# ---------------------------- plain versions -----------------------------


def _features(origins, dirs, center):
    """The 9 non-constant ray features [d, o x d, o] as [R] planes."""
    o = tuple(origins[:, c] - center[c] for c in range(3))
    d = tuple(dirs[:, c] for c in range(3))
    return (*d, *_cross(o, d), *o)


def _products(f, coeff):
    """det, a = u*det, b = v*det, c = t*det as [R, Tp] planes, each a sum
    over its nonzero rows in increasing order (the kernels' order)."""
    tp = coeff.shape[1] // 4
    out = []
    for p, rows in enumerate(PLANE_ROWS):
        col = coeff[:, p * tp:(p + 1) * tp]
        acc = None
        for k in rows:
            term = (col[k][None, :] if k == 9
                    else f[k][:, None] * col[k][None, :])
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _decide(det, a, b, c, t_min, t_max):
    """Hit test in the products domain and t (mxu_trace.py:113-124);
    t_min / t_max [R, 1]."""
    dok = torch.abs(det) > _DET_EPS
    ok = (dok & (a * det >= 0.0) & (b * det >= 0.0)
          & ((a + b - det) * det <= 0.0)
          & ((c - t_min * det) * det > 0.0)
          & ((c - t_max * det) * det < 0.0))
    one = torch.ones((), dtype=det.dtype, device=det.device)
    t = torch.where(ok, c / torch.where(dok, det, one),
                    torch.full((), INF, dtype=det.dtype, device=det.device))
    return ok, t


def _closest_plain(origins, dirs, t_min, t_max, coeff, center):
    """Closest hit (mxu_trace.py:127-174): origins / dirs [N, 3], t_min /
    t_max [N].  Returns (t, tri int64, u, v)."""
    ts, tris, us, vs = [], [], [], []
    for s in range(0, origins.shape[0], _RAY_CHUNK):
        sl = slice(s, s + _RAY_CHUNK)
        f = _features(origins[sl], dirs[sl], center)
        det, a, b, c = _products(f, coeff)
        _, t = _decide(det, a, b, c, t_min[sl, None], t_max[sl, None])
        t_c, idx = torch.min(t, dim=1)      # the first minimum, as argmin
        at = idx[:, None]
        d_i = det.gather(1, at)[:, 0]
        one = torch.ones((), dtype=d_i.dtype, device=d_i.device)
        inv = 1.0 / torch.where(torch.abs(d_i) > _DET_EPS, d_i, one) + 0.0
        ts.append(t_c)
        tris.append(idx)
        us.append((a.gather(1, at)[:, 0] + 0.0) * inv)
        vs.append((b.gather(1, at)[:, 0] + 0.0) * inv)
    return tuple(torch.cat(x) for x in (ts, tris, us, vs))


def _any_plain(origins, dirs, t_min, t_max, coeff, center, num_tris):
    """Occlusion (mxu_trace.py:177-204) and the triangle tests the
    kernel's order needs: a ray with t_min < t_max tests triangles 0, 1,
    ... up to its first accepted one (all ``num_tris`` if none); other
    rays never hit (t_max <= t_min leaves no t in between, even rounded)
    and test nothing.  Returns (occluded bool [N], tests int32 [N])."""
    occ, tests = [], []
    for s in range(0, origins.shape[0], _RAY_CHUNK):
        sl = slice(s, s + _RAY_CHUNK)
        f = _features(origins[sl], dirs[sl], center)
        det, a, b, c = _products(f, coeff)
        ok, _ = _decide(det, a, b, c, t_min[sl, None], t_max[sl, None])
        hit = torch.any(ok, dim=1)
        first = torch.argmax(ok.to(torch.uint8), dim=1) + 1
        live = t_min[sl] < t_max[sl]
        n_t = torch.where(hit, first, torch.full_like(first, num_tris))
        occ.append(hit)
        tests.append(torch.where(live, n_t, torch.zeros_like(n_t))
                     .to(torch.int32))
    return torch.cat(occ), torch.cat(tests)


# --------------------- the kernels' filter, in torch ops -------------------

# the filter's constants, as csrc/mxu_trace.cu states them (a test holds
# the two together): the margin factor's log2, the absolute term's, the
# features' and coefficient sums' safe range, and the triangles of a step
# (Q's maximum)
KAPPA_LOG2 = -8
MU_LOG2 = -59
SAFE_LOG2 = 40
FILTER_STEP = 16


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 as ``cvt.rna.tf32.f32`` does: to
    nearest, ties away from zero, on the bit pattern (10 stored mantissa
    bits; the low 13 bits cleared)."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (b + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(
        torch.float32)


def _approx_plane(feats, rows, col):
    """One plane's sum over ``rows`` on TF32 operands, the products and
    their sum in float64 (exact products, a sum far finer than the tensor
    core's), rounded to float32."""
    acc = None
    for k in rows:
        term = (_tf32(feats[k]).double()[:, None]
                * _tf32(col[k]).double()[None, :])
        acc = term if acc is None else acc + term
    return acc.to(torch.float32)


def _candidates_plain(origins, dirs, t_min, t_max, coeff, center, num_tris):
    """The kernels' filter (csrc/mxu_trace.cu) on [R] rays against every
    real triangle: which pairs it keeps for confirmation, and the
    approximate det, a, b it sees with its margin for each.  A dead ray
    keeps nothing; a live ray with a feature that is not finite or beyond
    2^SAFE_LOG2 keeps every pair (the kernels' exact scan).  Returns a
    dict: keep [R, T] bool, approx (3 x [R, T] float32), margin (3 x
    [R, T] float64), safe and live [R] bool.  Only the tests use it."""
    tp = coeff.shape[1] // 4
    f = _features(origins, dirs, center)
    fa = torch.stack([x.abs() for x in f], dim=1)
    safe = (fa <= 2.0 ** SAFE_LOG2).all(dim=1)
    live = t_min < t_max
    approx, qsum = [], []
    for p, rows in enumerate(PLANE_ROWS[:3]):
        col = coeff[:, p * tp:(p + 1) * tp]
        approx.append(_approx_plane(f, rows, col)[:, :num_tris])
        qsum.append(torch.stack([col[k].double().abs() for k in rows])
                    .sum(dim=0))
    q = torch.stack([qsum[0], torch.maximum(qsum[1], qsum[2])])
    ok = ((qsum[0] <= 2.0 ** SAFE_LOG2) & (qsum[1] <= 2.0 ** SAFE_LOG2)
          & (qsum[2] <= 2.0 ** SAFE_LOG2))
    q = torch.where(ok, q, torch.inf)
    q = q.reshape(2, -1, FILTER_STEP).amax(dim=2).repeat_interleave(
        FILTER_STEP, dim=1)[:, :num_tris]
    kappa, mu = 2.0 ** KAPPA_LOG2, 2.0 ** MU_LOG2
    fd = fa[:, :3].amax(dim=1).double()
    fab = fa[:, :6].amax(dim=1).double()
    md = kappa * fd[:, None] * q[0][None, :] + mu
    mab = kappa * fab[:, None] * q[1][None, :] + mu
    det, a, b = (x.double() for x in approx)
    sgn = torch.where(torch.signbit(det), -1.0, 1.0)
    aa, bb, dd = a * sgn, b * sgn, det.abs()
    fails = (aa < -mab) | (bb < -mab) | (aa + bb - dd > md + 2.0 * mab)
    far = (a.abs() > dd + md + mab) | (b.abs() > dd + md + mab)
    keep = ~((dd > md) & fails) & ~far
    keep = torch.where(safe[:, None], keep, True) & live[:, None]
    return dict(keep=keep, approx=tuple(approx), margin=(md, mab, mab),
                safe=safe, live=live)


# ----------------------------- CUDA build --------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "mxu_trace.cu")
_LIB = None
BUILD_INFO: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interface of csrc/mxu_trace.cu: ctypes argument types by name
_SIGNATURES = {
    "mxu_closest": [_P] * 10 + [_I] * 3 + [_P],
    "mxu_any": [_P] * 8 + [_I] * 3 + [_P],
    "mxu_closest_counted": [_P] * 11 + [_I] * 3 + [_P],
    "mxu_any_counted": [_P] * 9 + [_I] * 3 + [_P],
    "mxu_resources": [_I, ctypes.POINTER(_I)],
    "mxu_filter_params": [ctypes.POINTER(_I)],
}
# what the counted builds add up, in order
COUNT_KEYS = ("pairs", "candidates", "accepted", "exact_rays",
              "packed_rays")


def build_kernels():
    """Build csrc/mxu_trace.cu (cuda_build.build_library: nvcc for
    sm_90a, -fmad=false) and load it.  Called at the first launch;
    idempotent."""
    global _LIB
    if _LIB is None:
        lib, info = build_library(_SRC, signatures=_SIGNATURES)
        res = {}
        for which, name in enumerate(LAUNCHES):
            vals = (ctypes.c_int * 5)()
            err = lib.mxu_resources(which, vals)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err} querying "
                                   "resources")
            res[name] = dict(ctas_per_sm=vals[0], registers=vals[1],
                             threads=vals[2], shared_bytes=vals[3],
                             local_bytes=vals[4])
        vals = (ctypes.c_int * 5)()
        lib.mxu_filter_params(vals)
        BUILD_INFO.update(info, resources=res, filter=dict(
            zip(("kappa_log2", "mu_log2", "safe_log2", "step",
                 "rays_per_cta"), vals)))
        _LIB = lib
    return _LIB


# ---------------------------- kernel wrappers ----------------------------


def _check(origins, dirs, t_min, t_max, tris: MxuTris):
    n = origins.shape[0]
    dev = origins.device
    tp = tris.padded
    if tris.num_tris < 1:
        raise ValueError("mxu trace: no triangles (JAX's argmin over an "
                         "empty axis fails)")
    if tris.num_tris > tp or tp % _LANE:
        raise ValueError(f"mxu trace: {tris.num_tris} triangles in {tp} "
                         "padded columns")
    for x, shape in ((origins, (n, 3)), (dirs, (n, 3)), (t_min, (n,)),
                     (t_max, (n,)), (tris.coeff, (10, 4 * tp)),
                     (tris.center, (3,))):
        if x.device != dev:
            raise ValueError("mxu kernel inputs must share one device")
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"mxu kernel input {tuple(x.shape)} {x.dtype}:"
                             f" expected {shape} float32")
        if not x.is_contiguous():
            raise ValueError("mxu kernel inputs must be contiguous")


def _launch(name, origins, *args, lib=None):
    """Launch kernel ``name`` (its counted build: ``name`` + "_counted")
    on PyTorch's current stream of the inputs' device, made the current
    device for the launch; ``lib`` another build of the same source."""
    lib = lib or build_kernels()
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = getattr(lib, name)(origins.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name.removesuffix("_counted")] += 1


def mxu_closest(origins, dirs, t_min, t_max, tris: MxuTris):
    """Closest hit of [N, 3] rays (t_min / t_max [N]) against ``tris``.
    Returns (t, tri int64, u, v), each [N].  CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check(origins, dirs, t_min, t_max, tris)
    if not origins.is_cuda:
        return _closest_plain(origins, dirs, t_min, t_max, tris.coeff,
                              tris.center)
    n, dev = origins.shape[0], origins.device
    t, u, v = (torch.empty((n,), dtype=torch.float32, device=dev)
               for _ in range(3))
    tri = torch.empty((n,), dtype=torch.int64, device=dev)
    if n:
        _launch("mxu_closest", origins, dirs.data_ptr(), t_min.data_ptr(),
                t_max.data_ptr(), tris.coeff.data_ptr(),
                tris.center.data_ptr(), t.data_ptr(), u.data_ptr(),
                v.data_ptr(), tri.data_ptr(), n, tris.num_tris, tris.padded)
    return t, tri, u, v


def mxu_any(origins, dirs, t_min, t_max, tris: MxuTris, stats: bool = False):
    """Occlusion of [N, 3] rays against ``tris``.  Returns (occluded bool
    [N], tests int32 [N] or None): with ``stats`` the triangle tests each
    ray made (``_any_plain``'s count).  CUDA tensors launch the kernel;
    CPU tensors run the plain version (whose tests are always counted)."""
    _check(origins, dirs, t_min, t_max, tris)
    if not origins.is_cuda:
        return _any_plain(origins, dirs, t_min, t_max, tris.coeff,
                          tris.center, tris.num_tris)
    n, dev = origins.shape[0], origins.device
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    tests = (torch.empty((n,), dtype=torch.int32, device=dev) if stats
             else None)
    if n:
        _launch("mxu_any", origins, dirs.data_ptr(), t_min.data_ptr(),
                t_max.data_ptr(), tris.coeff.data_ptr(),
                tris.center.data_ptr(), occ.data_ptr(),
                tests.data_ptr() if stats else None, n, tris.num_tris,
                tris.padded)
    return occ, tests


def filter_counts(origins, dirs, t_min, t_max, tris: MxuTris,
                  closest: bool = True) -> dict:
    """What the kernels' filter did on one call: the counted build of
    mxu_closest (or mxu_any) on CUDA tensors, its answers discarded.
    Returns {COUNT_KEYS: int}: pairs filtered on the tensor cores, pairs
    kept for confirmation, pairs accepted there, rays of the exact scan,
    rays packed."""
    _check(origins, dirs, t_min, t_max, tris)
    if not origins.is_cuda:
        raise ValueError("filter_counts: the filter runs in the kernels "
                         "(CUDA tensors)")
    n, dev = origins.shape[0], origins.device
    counts = torch.zeros((len(COUNT_KEYS),), dtype=torch.int64, device=dev)
    head = [dirs.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            tris.coeff.data_ptr(), tris.center.data_ptr()]
    if closest:
        outs = [torch.empty((n,), dtype=torch.float32, device=dev)
                for _ in range(3)]
        outs.append(torch.empty((n,), dtype=torch.int64, device=dev))
    else:
        outs = [torch.empty((n,), dtype=torch.bool, device=dev),
                torch.empty((n,), dtype=torch.int32, device=dev)]
    if n:
        _launch("mxu_closest_counted" if closest else "mxu_any_counted",
                origins, *head, *(x.data_ptr() for x in outs),
                counts.data_ptr(), n, tris.num_tris, tris.padded)
    return dict(zip(COUNT_KEYS, counts.tolist()))


# ------------------------------- tracing --------------------------------


def prepare_rays(origins, dirs, t_min, t_max):
    """[N, 3] contiguous float32 origins and directions (AoS or planar
    3-tuples in) and [N] bounds from scalars or [N]."""
    o = torch.stack(as_planes3(origins), dim=1).to(torch.float32)
    d = torch.stack(as_planes3(dirs), dim=1).to(torch.float32)
    n = o.shape[0]

    def bound(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=o.device).expand(n).contiguous()

    return o.contiguous(), d.contiguous(), bound(t_min), bound(t_max)


def closest_hit_mxu(origins, dirs, tris: MxuTris, t_min=1e-4,
                    t_max=1e4) -> Hit:
    """Closest hit of each ray against all triangles by the matmul form
    (mxu_trace.py:142-174)."""
    t, tri, u, v = mxu_closest(*prepare_rays(origins, dirs, t_min, t_max),
                               tris)
    return Hit(t=t, tri=tri, u=u, v=v)


def any_hit_mxu(origins, dirs, tris: MxuTris, t_min, t_max) -> torch.Tensor:
    """Occlusion (ShadowRay.hlsl semantics) by the matmul form
    (mxu_trace.py:177-204): no division, every test in the products
    domain."""
    return mxu_any(*prepare_rays(origins, dirs, t_min, t_max), tris)[0]
