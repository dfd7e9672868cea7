"""Frozen copy for the benchmark's plain reference: BSDF library (port of royaltracer_dx_tpu/ops/bsdf.py).

Lambertian + GGX with multiscatter compensation and the two-lobe
blend (GGX_v6.hlsl, Lambertian_v6.hlsl, BRDF_v6.hlsl), in two forms as
in the JAX package:

* AoS (bsdf.py:44-260, :462-480): vectors [..., 3], ``outgoing`` toward
  the viewer, ``incoming`` INTO the surface (the light direction is
  -incoming), material parameters per lane (kd [..., 4] or [..., 3], ks
  [..., 3], roughness [...], lut_row [..., 16]); the reference-shaped API
  that the AoS ReSTIR helpers (ops/restir.py) call;
* planar ``_p`` (:274-459): n / l / v planar unit vectors, l toward the
  light, what the ReSTIR passes call.

PI is the reference's 3.1415.
"""

from __future__ import annotations

import torch

from reference.config import EPSILON, REF_PI
from reference import math3d as m3
from reference import pvec as pv
from reference.rng import tea_random

_PI_F32 = 3.14159265358979323846


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _pow5(x):
    """|x|^5 as a multiply chain (bsdf.py:33-41)."""
    a = torch.abs(x)
    a2 = a * a
    return a2 * a2 * a


def d_ggx(ndoth, roughness):
    alpha = roughness * roughness
    a2 = alpha * alpha
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (REF_PI * denom * denom)


def g1_smith(ndotv, alpha):
    a2 = alpha * alpha
    return 2.0 * ndotv / (torch.sqrt(a2 + (1.0 - a2) * ndotv * ndotv) + ndotv)


def g2_smith(ndotv, ndotl, alpha):
    a2 = alpha * alpha
    da = ndotv * torch.sqrt(a2 + (1.0 - a2) * ndotl * ndotl)
    db = ndotl * torch.sqrt(a2 + (1.0 - a2) * ndotv * ndotv)
    return 2.0 * ndotl * ndotv / (da + db)


def schlick_fresnel_p(f0, cos_theta):
    """Planar Schlick Fresnel (bsdf.py:274-277)."""
    p = _pow5(1.0 - cos_theta)
    return tuple(torch.clamp(c + (1.0 - c) * p, 0.0, 1.0) for c in f0)


def ess_lookup_hat(lut_planes, ndotv):
    """Gather-free E_ss LUT interpolation as a hat-basis sum
    (bsdf.py:280-294)."""
    size = len(lut_planes)
    x = torch.clamp(ndotv, 0.0, 1.0) * (size - 1)
    acc = 0.0
    for k, col in enumerate(lut_planes):
        w = torch.clamp_min(1.0 - torch.abs(x - k), 0.0)
        acc = acc + col * w
    return acc


def eval_ggx_p(ks, roughness, lut_planes, n, l, v):
    """Planar GGX eval with multiscatter LUT (bsdf.py:297-317)."""
    h = pv.normalize(pv.add(v, l))
    ndotv = pv.dot(n, v)
    ndotl = pv.dot(n, l)
    ndoth = pv.dot(n, h)
    vdoth = pv.dot(v, h)
    f = schlick_fresnel_p(ks, vdoth)
    d = d_ggx(ndoth, roughness)
    g = g2_smith(ndotv, ndotl, roughness * roughness)
    denom = 4.0 * ndotv * ndotl
    dg = d * g / denom
    ess = ess_lookup_hat(lut_planes, ndotv)
    kms = (1.0 - ess) / ess
    ok = (denom >= EPSILON) & (ndotv > 0.0) & (ndotl > 0.0)
    z = _zero(ndotv)
    out = []
    for fc, kc in zip(f, ks):
        s = fc * dg * (1.0 + kc * kms)
        out.append(torch.where(ok & torch.isfinite(s), s, z))
    return tuple(out)


def pdf_ggx_p(roughness, n, l, v):
    """Planar VNDF pdf = G1 * D / (4 NdotV) (bsdf.py:320-327)."""
    h = pv.normalize(pv.add(v, l))
    ndoth = pv.dot(n, h)
    ndotv = pv.dot(n, v)
    alpha = roughness * roughness
    pdf = g1_smith(ndotv, alpha) * d_ggx(ndoth, roughness) / (ndotv * 4.0)
    return torch.where(ndotv > 0.0, pdf, _zero(pdf))


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, _zero(x))


def eval_bsdf_blend_p(kd, ks, metallic, roughness, lut_planes, n, l, v):
    """Probability-blended two-lobe eval (bsdf.py:350-364)."""
    cos_theta = pv.dot(n, v)
    fres = schlick_fresnel_p(ks, cos_theta)
    p_s = torch.clamp_max(pv.avg(fres) + metallic, 1.0)
    p_d = 1.0 - p_s
    gx = eval_ggx_p(ks, roughness, lut_planes, n, l, v)
    out = []
    for g, k in zip(gx, kd):
        r0 = _finite_or_zero(p_d * (k / REF_PI))
        r1 = _finite_or_zero(p_s * g)
        out.append(r0 + r1)
    return tuple(out)


def pdf_bsdf_blend_p(ks, metallic, roughness, n, l, v):
    """Probability-blended two-lobe pdf (bsdf.py:367-379)."""
    cos_theta = pv.dot(n, v)
    fres = schlick_fresnel_p(ks, cos_theta)
    p_s = torch.clamp_max(pv.avg(fres) + metallic, 1.0)
    p_d = 1.0 - p_s
    p0 = torch.clamp_min(pv.dot(n, l), EPSILON) / REF_PI
    p1 = pdf_ggx_p(roughness, n, l, v)
    return _finite_or_zero(p_d * p0) + _finite_or_zero(p_s * p1)


def sample_lambertian_p(n, seed):
    """Cosine-weighted hemisphere sample (bsdf.py:382-403)."""
    u1, seed = tea_random(seed)
    u2, seed = tea_random(seed)
    r = torch.sqrt(u1)
    theta = 2.0 * _PI_F32 * u2
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = torch.sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0))
    zero = torch.zeros_like(n[2])
    one = torch.ones_like(n[2])
    use_z = torch.abs(n[2]) < 0.999
    up = (torch.where(use_z, zero, one), zero, torch.where(use_z, one, zero))
    right = pv.normalize(pv.cross(up, n))
    forward = pv.cross(n, right)
    d = pv.add(pv.add(pv.scale(right, x), pv.scale(forward, y)),
               pv.scale(n, z))
    d = pv.normalize(d)
    d = pv.where(pv.dot(d, n) < 0.0, pv.neg(d), d)
    return d, seed


def sample_ggx_p(roughness, v, n, seed):
    """Heitz VNDF sample -> reflected direction (bsdf.py:406-441)."""
    alpha = roughness * roughness
    n = pv.normalize(n)
    v = pv.normalize(v)
    t1w, t2w = pv.coordinate_system(n)
    vl = (pv.dot(t1w, v), pv.dot(t2w, v), pv.dot(n, v))
    ve = pv.normalize((alpha * vl[0], alpha * vl[1], vl[2]))
    lensq = ve[0] * ve[0] + ve[1] * ve[1]
    inv = torch.rsqrt(torch.clamp_min(lensq, 1e-20))
    ok = lensq > 0.0
    zero = torch.zeros_like(inv)
    t1h = (torch.where(ok, -ve[1] * inv, zero + 1.0),
           torch.where(ok, ve[0] * inv, zero),
           zero)
    t2h = pv.cross(ve, t1h)
    u1, seed = tea_random(seed)
    u2, seed = tea_random(seed)
    r = torch.sqrt(u1)
    phi = 2.0 * REF_PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + ve[2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, 0.0, 1.0)) + s * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, 0.0, 1.0))
    nh = pv.add(pv.add(pv.scale(t1h, p1), pv.scale(t2h, p2)), pv.scale(ve, pz))
    ne = pv.normalize((alpha * nh[0], alpha * nh[1],
                       torch.clamp_min(nh[2], 0.0)))
    h = pv.add(pv.add(pv.scale(t1w, ne[0]), pv.scale(t2w, ne[1])),
               pv.scale(n, ne[2]))
    d = pv.reflect(pv.neg(v), h)
    d = pv.where(pv.dot(d, n) < 0.0, pv.neg(d), d)
    return d, seed


def select_strategy_p(ks, metallic, roughness, n, v, seed):
    """Lobe pick: 0 = diffuse, 1 = GGX (bsdf.py:444-451).  Returns
    (strategy int32, p_specular, seed)."""
    r, seed = tea_random(seed)
    cos_theta = pv.dot(n, v)
    fres = schlick_fresnel_p(ks, cos_theta)
    p_s = torch.clamp_max(pv.avg(fres) + metallic, 1.0)
    spec = (r <= p_s) & (roughness >= 0.04)
    return spec.to(torch.int32), p_s, seed


def sample_bsdf_p(strategy, ks, roughness, v, n, seed):
    """Sample the selected lobe; both lobes consume the same 2 draws
    (bsdf.py:454-459)."""
    d_lam, _ = sample_lambertian_p(n, seed)
    d_spec, seed_out = sample_ggx_p(roughness, v, n, seed)
    return pv.where(strategy == 1, d_spec, d_lam), seed_out


# ------------------------------ AoS forms -------------------------------


def pdf_lambertian(normal, incoming):
    """max(dot(n, -incoming), EPS) / pi (bsdf.py:124-126)."""
    return torch.clamp_min(m3.dot(normal, -incoming), EPSILON) / REF_PI


def pdf_ggx(roughness, normal, incoming, outgoing):
    """VNDF pdf = G1 D / (4 NdotV), zero for a backside view
    (bsdf.py:209-224)."""
    n = m3.normalize(normal)
    v = m3.normalize(outgoing)
    l = m3.normalize(-incoming)
    h = m3.normalize(v + l)
    ndoth = m3.dot(n, h)
    ndotv = m3.dot(n, v)
    alpha = roughness * roughness
    pdf = g1_smith(ndotv, alpha) * d_ggx(ndoth, roughness) / (ndotv * 4.0)
    return torch.where(ndotv > 0.0, pdf, 0.0)


def pdf_bsdf(strategy, roughness, normal, incoming, outgoing):
    """BRDF_PDF of the selected strategy (bsdf.py:270-274)."""
    lam = pdf_lambertian(normal, incoming)
    gx = pdf_ggx(roughness, normal, incoming, outgoing)
    return torch.where(strategy == 1, gx, lam)


