"""Frozen copy for the benchmark's plain reference: GGX multiscatter directional-albedo (E_ss) LUT (port of
royaltracer_dx_tpu/scene/lut.py:29-115).

The same estimator (16 cosTheta bins x 16000 VNDF samples, the D-cancelled
host form of ObjLoader.h:256-286).  The JAX LUT draws its uniforms from
threefry (lut.py:86-88), which PyTorch cannot reproduce, so this one draws
from a seeded ``torch.Generator``: the two agree within Monte Carlo error
(tested), and frame-parity tests feed the JAX LUT into the port.
"""

from __future__ import annotations

import math

import torch

from reference.config import LUT_SIZE_THETA

_NUM_SAMPLES_MC = 16000
_EPS_BIN = 0.04   # cosTheta floor (ObjLoader.h:352,360)


def _sample_ggx_vndf_local(v, alpha, u1, u2):
    """Heitz VNDF half-vector sample, local frame N = +z (lut.py:29-58).
    v: [B, 1, 3]; alpha: scalar; u1/u2: [S].  Returns [B, S, 3]."""
    scale = torch.tensor([alpha, alpha, 1.0], dtype=v.dtype, device=v.device)
    vh = v * scale
    vh = vh / torch.linalg.norm(vh, dim=-1, keepdim=True)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = torch.rsqrt(torch.clamp_min(lensq, 1e-20))
    ok = lensq > 0.0
    zero = torch.zeros_like(inv)
    t1 = torch.stack([torch.where(ok, -vh[..., 1] * inv, zero + 1.0),
                      torch.where(ok, vh[..., 0] * inv, zero),
                      zero], dim=-1)
    t2 = torch.linalg.cross(vh, t1, dim=-1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, 0.0, 1.0)) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, 0.0, 1.0))[..., None]
          * vh)
    ne = torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                      torch.clamp_min(nh[..., 2], 0.0)], dim=-1)
    return ne / torch.clamp_min(torch.linalg.norm(ne, dim=-1, keepdim=True),
                                1e-20)


def _g1(ndotv, alpha):
    a2 = alpha * alpha
    return 2.0 * ndotv / torch.clamp_min(
        torch.sqrt(a2 + (1 - a2) * ndotv ** 2) + ndotv, 1e-7)


def _g2(ndotv, ndotl, alpha):
    a2 = alpha * alpha
    da = ndotv * torch.sqrt(a2 + (1 - a2) * ndotl ** 2)
    db = ndotl * torch.sqrt(a2 + (1 - a2) * ndotv ** 2)
    return 2.0 * ndotl * ndotv / torch.clamp_min(da + db, 1e-20)


def compute_ess_lut(roughness, generator: torch.Generator | None = None,
                    num_samples: int = _NUM_SAMPLES_MC,
                    device="cpu") -> torch.Tensor:
    """E_ss LUT [M, 16] in (0, 1] for roughness values [M] (lut.py:73-115).

    The uniforms come from ``generator`` (a CPU generator seeded 0 when
    None), so a LUT is reproducible across devices."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    rough = torch.as_tensor(roughness, dtype=torch.float32).reshape(-1)
    u = torch.rand((num_samples, 2), generator=generator,
                   dtype=torch.float32).to(device)
    idx = torch.arange(LUT_SIZE_THETA, dtype=torch.float32, device=device)
    cos_t = _EPS_BIN + idx / (LUT_SIZE_THETA - 1) * (1.0 - _EPS_BIN)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, _EPS_BIN))
    v = torch.stack([sin_t, torch.zeros_like(cos_t), cos_t], dim=-1)  # [B, 3]
    rows = []
    for rv in rough.tolist():
        alpha = rv * rv
        h = _sample_ggx_vndf_local(v[:, None, :], alpha, u[:, 0], u[:, 1])
        vb = v[:, None, :]
        l_dir = 2.0 * torch.sum(vb * h, dim=-1, keepdim=True) * h - vb
        ndotl = l_dir[..., 2]
        ndotv = torch.clamp_min(v[:, 2], 0.0)[:, None]
        g2 = _g2(ndotv, torch.clamp_min(ndotl, 0.0), alpha)
        g1 = _g1(ndotv, alpha)
        contrib = torch.where(ndotl > 0.0, g2 / torch.clamp_min(g1, 1e-7),
                              torch.zeros_like(g2))
        rows.append(contrib.mean(dim=1))
    lut = torch.stack(rows, dim=0)
    # clamp away zeros so kms = (1-E)/E stays finite (GGX_v6.hlsl:197-199)
    return torch.clamp(lut, 1e-4, 1.0)
