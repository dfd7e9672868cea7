"""Frozen copy for the benchmark's plain reference: Planar 3-vector helpers (port of royaltracer_dx_tpu/utils/pvec.py).

A planar vec is a tuple ``(x, y, z)`` of same-shape (or broadcastable)
tensors, so the port's functions keep the JAX package's planar signatures
and the parity tests compare like with like.
"""

from __future__ import annotations

import torch

Vec = tuple


def from_aos(a: torch.Tensor, axis: int = -1) -> Vec:
    return tuple(a.select(axis, c) for c in range(3))


def to_aos(v: Vec, axis: int = -1) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(*v), dim=axis)


def splat(s) -> Vec:
    return (s, s, s)


def add(a: Vec, b: Vec) -> Vec:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a: Vec, b: Vec) -> Vec:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a: Vec, b: Vec) -> Vec:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a: Vec, s) -> Vec:
    return (a[0] * s, a[1] * s, a[2] * s)


def neg(a: Vec) -> Vec:
    return (-a[0], -a[1], -a[2])


def dot(a: Vec, b: Vec):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: Vec, b: Vec) -> Vec:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length(a: Vec):
    return torch.sqrt(torch.clamp_min(dot(a, a), 0.0))


def normalize(a: Vec, eps: float = 1e-20) -> Vec:
    inv = torch.rsqrt(torch.clamp_min(dot(a, a), eps))
    return scale(a, inv)


def where(mask, a: Vec, b: Vec) -> Vec:
    return tuple(torch.where(mask, a[c], b[c]) for c in range(3))


def reflect(i: Vec, n: Vec) -> Vec:
    """HLSL reflect: i - 2*dot(n, i)*n."""
    return sub(i, scale(n, 2.0 * dot(n, i)))


def avg(a: Vec):
    """The reference's scalar "luminance": channel average."""
    return (a[0] + a[1] + a[2]) / 3.0


def coordinate_system(n: Vec) -> tuple[Vec, Vec]:
    """Planar orthonormal (T1, T2) for unit n (pvec.py:95-102)."""
    use_z = torch.abs(n[2]) < 0.999
    zero = torch.zeros_like(n[2])
    one = torch.ones_like(n[2])
    axis = (torch.where(use_z, zero, one), zero, torch.where(use_z, one, zero))
    t1 = normalize(cross(axis, n))
    t2 = cross(n, t1)
    return t1, t2
