"""Frozen copy for the benchmark's plain reference: Small-vector math over [..., 3] tensors (port of
royaltracer_dx_tpu/utils/math3d.py).  The renderer itself runs planar
(utils/pvec.py); these serve the AoS forms (ops/bsdf.py, ops/restir.py,
ops/reservoir.py) and image output."""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp_min(dot(v, v), eps))[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def srgb_gamma(c: torch.Tensor) -> torch.Tensor:
    """Per-channel sRGB OETF (math3d.py:77-81)."""
    lo = 12.92 * c
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-12), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """HLSL reflect: i - 2 dot(n, i) n (math3d.py:29-31)."""
    return i - 2.0 * dot(n, i)[..., None] * n


def coordinate_system(n: torch.Tensor):
    """Orthonormal (T1, T2) for normal ``n`` (math3d.py:34-47,
    GGX_v6.hlsl:65-76): T1 = normalize(cross(z or x, N)), T2 = cross(N,
    T1)."""
    use_z = torch.abs(n[..., 2]) < 0.999
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    axis = torch.where(use_z[..., None], z_axis, x_axis)
    t1 = normalize(cross(axis, n))
    return t1, cross(n, t1)


