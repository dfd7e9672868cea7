"""Small-vector math over [..., 3] tensors (port of
royaltracer_dx_tpu/utils/math3d.py).  The renderer itself runs planar
(utils/pvec.py); these serve the AoS boundaries and image output."""

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
