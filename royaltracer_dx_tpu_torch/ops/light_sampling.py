"""Emissive-triangle sampling (port of
royaltracer_dx_tpu/ops/light_sampling.py): the AoS pick ``select_light``
(a searchsorted, as the AoS NEE batch uses it) and the planar path the
ReSTIR passes use: the lights' packed record table, a CDF count-pick and
a row fetch of the picked records.

For CUDA tensors ``select_light_records`` launches one hand-written kernel
a call (``csrc/light_pick.cu`` ``light_pick``, built at first use by
``utils.cuda_build.build_library``): it counts the CDF and writes the
picked records as 16 contiguous planes, bit for bit with the plain form.
CPU tensors take the plain form below, which the kernel is held against;
a CUDA tensor never does (``_pick`` launches or raises).  Every pick
counts ``light_pick.calls`` and ``light_pick.lanes`` into the open
frame's telemetry record."""

from __future__ import annotations

import ctypes
import os

import torch

from royaltracer_dx_tpu_torch.config import EPSILON
from royaltracer_dx_tpu_torch.scene.types import LightTriangles
from royaltracer_dx_tpu_torch.utils import telemetry
from royaltracer_dx_tpu_torch.utils.cuda_build import build_library

RECORD = 16
# one launch count, bumped only where the kernel is launched
LAUNCHES = {"light_pick": 0}
_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "light_pick.cu")
_LIB = None
BUILD_INFO: dict = {}
# the C interface of csrc/light_pick.cu: u, lanes, cols, row stride, col
# stride, cdf, L, table, out, stream
_SIGNATURES = {"light_pick": [ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p]}


def build_kernels():
    """Build csrc/light_pick.cu (nvcc for sm_90a, the package's flags) and
    load it.  Called at the first launch; idempotent."""
    global _LIB
    if _LIB is None:
        lib, info = build_library(_SRC, signatures=_SIGNATURES)
        BUILD_INFO.update(info)
        _LIB = lib
    return _LIB


def select_light(lights: LightTriangles, u):
    """First index with u < cdf[i], clipped to [0, L - 1] -- the HLSL
    binary search (light_sampling.py:17-20).  Returns int32."""
    idx = torch.searchsorted(lights.cdf, u.contiguous(), right=True)
    return torch.clamp(idx, 0, lights.count - 1).to(torch.int32)


def light_world_verts(lights: LightTriangles, object_to_world, idx):
    """World-space vertices of light ``idx`` under the current instance
    transforms (light_sampling.py:23-34).  Returns [..., 3, 3]."""
    verts = lights.verts[idx]
    m = object_to_world[lights.instance[idx].long()]
    rot = m[..., None, :3, :3]
    trn = m[..., None, :3, 3]
    return torch.sum(rot * verts[..., None, :], dim=-1) + trn


def fold_barycentric(xi1, xi2):
    """Uniform triangle barycentrics by the fold trick
    (light_sampling.py:37-43)."""
    flip = xi1 + xi2 > 1.0
    xi1 = torch.where(flip, 1.0 - xi1, xi1)
    xi2 = torch.where(flip, 1.0 - xi2, xi2)
    return 1.0 - xi1 - xi2, xi1, xi2


def light_tables(lights: LightTriangles, object_to_world) -> list:
    """16 [L] world-space light record columns: verts (9), unit normal (3),
    pdf = weight / area (1), emission (3) (light_sampling.py:52-73)."""
    l_count = lights.count
    idx = torch.arange(l_count, device=lights.verts.device)
    wv = light_world_verts(lights, object_to_world, idx)
    e1 = wv[:, 1] - wv[:, 0]
    e2 = wv[:, 2] - wv[:, 0]
    cr = torch.linalg.cross(e1, e2, dim=-1)
    ln2 = torch.sum(cr * cr, dim=-1)
    area = torch.abs(0.5 * torch.sqrt(torch.clamp_min(ln2, 0.0)))
    nl = cr * torch.rsqrt(torch.clamp_min(ln2, 1e-20))[:, None]
    pdf = lights.weight / torch.clamp_min(area, EPSILON)
    cols = [wv[:, k, c] for k in range(3) for c in range(3)]
    cols += [nl[:, 0], nl[:, 1], nl[:, 2], pdf,
             lights.emission[:, 0], lights.emission[:, 1],
             lights.emission[:, 2]]
    return cols


def light_table(lights: LightTriangles, object_to_world) -> torch.Tensor:
    """``light_tables``' columns packed as one contiguous float32 [L, 16],
    a row a light: the table ``select_light_records`` picks from.  A
    scene's is built at its first read (``SceneArrays.light_table``)."""
    return torch.stack(light_tables(lights, object_to_world), dim=1)


def _takes_kernel(u: torch.Tensor) -> bool:
    """Whether a pick of ``u`` launches the kernel: CUDA tensors do, CPU
    tensors run the plain form."""
    return u.is_cuda


def _fold(u: torch.Tensor):
    """(rows, cols, row stride, col stride) addressing ``u``'s elements in
    row-major order as lane r * cols + c, or None where its strides do not
    fold to two dimensions."""
    dims = []
    for size, stride in zip(u.shape, u.stride()):
        if size == 1:
            continue
        if dims and dims[-1][1] == stride * size:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    if len(dims) > 2:
        return None
    dims = [(1, 0)] * (2 - len(dims)) + dims
    return dims[0][0], dims[1][0], dims[0][1], dims[1][1]


def _pick(table: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor) -> list:
    """One ``light_pick`` launch on PyTorch's current stream: the records
    of the lights ``u`` picks on ``cdf``, as 16 contiguous planes of
    ``u``'s shape (views of one [16, *u.shape] tensor)."""
    l_count = cdf.shape[0] if cdf.dim() == 1 else 0
    if (u.dtype, cdf.dtype, table.dtype) != (torch.float32,) * 3:
        raise ValueError(f"light pick: u {u.dtype}, cdf {cdf.dtype}, table "
                         f"{table.dtype}: expected float32")
    if l_count == 0 or tuple(table.shape) != (l_count, RECORD):
        raise ValueError(f"light pick: cdf {tuple(cdf.shape)}, table "
                         f"{tuple(table.shape)}: expected [L] and "
                         f"[L, {RECORD}], L >= 1")
    dev = u.device
    if cdf.device != dev or table.device != dev:
        raise ValueError(f"light pick: u on {dev}, cdf on {cdf.device}, "
                         f"table on {table.device}")
    out = torch.empty((RECORD, *u.shape), dtype=torch.float32, device=dev)
    lanes = u.numel()
    if lanes:
        folded = _fold(u)
        if folded is None:
            u = u.contiguous()
            folded = (1, lanes, 0, 1)
        _, cols, row_stride, col_stride = folded
        cdf = cdf.contiguous()
        if not table.is_contiguous() or table.data_ptr() % 16:
            table = table.clone(memory_format=torch.contiguous_format)
        lib = _LIB or build_kernels()
        with torch.cuda.device(dev):
            err = lib.light_pick(u.data_ptr(), lanes, cols, row_stride,
                                 col_stride, cdf.data_ptr(), l_count,
                                 table.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"light_pick: CUDA error {err} at launch")
        LAUNCHES["light_pick"] += 1
    return list(out.unbind(0))


def select_light_records(table: torch.Tensor, cdf, u_sel) -> list:
    """CDF-pick a light per candidate (first index with u < cdf, clipped
    to L-1: a count of cdf[l] <= u over l < L-1, light_sampling.py:76-98)
    and return its record planes, rows of ``table`` ([L, 16],
    ``light_table``)."""
    telemetry.count("light_pick.calls", 1)
    telemetry.count("light_pick.lanes", u_sel.numel())
    if _takes_kernel(u_sel):
        return _pick(table, cdf, u_sel)
    l_count = cdf.shape[0]
    idx = torch.zeros(u_sel.shape, dtype=torch.int64, device=u_sel.device)
    for l in range(l_count - 1):
        idx = idx + (cdf[l] <= u_sel).to(torch.int64)
    rows = table[idx.reshape(-1)]
    return [rows[:, k].reshape(u_sel.shape) for k in range(RECORD)]
