"""Frozen copy for the benchmark's plain reference: Emissive-triangle sampling (port of
royaltracer_dx_tpu/ops/light_sampling.py): the AoS pick ``select_light``
(a searchsorted, as the AoS NEE batch uses it) and the planar path the
ReSTIR passes use: per-pass light record columns, a CDF count-pick and a
row gather of the picked records."""

from __future__ import annotations

import torch

from reference.config import EPSILON
from reference.scene import LightTriangles


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


def select_light_records(cols: list, cdf, u_sel) -> list:
    """CDF-pick a light per candidate (first index with u < cdf, clipped
    to L-1: a count of cdf[l] <= u over l < L-1, light_sampling.py:76-98)
    and return its record planes."""
    l_count = cdf.shape[0]
    idx = torch.zeros(u_sel.shape, dtype=torch.int64, device=u_sel.device)
    for l in range(l_count - 1):
        idx = idx + (cdf[l] <= u_sel).to(torch.int64)
    packed = torch.stack(cols, dim=1)          # [L, 16]
    rows = packed[idx.reshape(-1)]
    return [rows[:, k].reshape(u_sel.shape) for k in range(len(cols))]
