"""The v5 "megakernel" path tracer, the correctness oracle (port of
royaltracer_dx_tpu/render/megakernel.py).

The reference's first-generation renderer: the bounce loop of its raygen
(RayGen.hlsl:80-137), shading with RIS over ``ris_m`` NEE light candidates,
one shadow ray and balance-heuristic MIS against the BSDF continuation
(Hit.hlsl:126-381), russian roulette after ``rr_threshold`` bounces
(RayGen.hlsl:118-130).  One bounce is tensor code over [N] planes; the RIS
candidate batch is candidate-major [M, N].  Every lane is traced every
bounce, dead lanes included, as in the JAX package: a lane's answer is
discarded where it is not shaded.

Both traces of a bounce go through ops/restir.py's dispatch, so on the card
they launch the stream kernels of csrc/stream_trace.cu.  A lane whose
primary or continuation ray missed casts its shadow ray from ~1e30 with
``t_min`` NaN (inf * 0 at :181); the dispatch keeps such lanes out of the
chunk bounds (``stream_trace._build_worklists``).

Behaviour-parity quirks (``cfg.reference_mis_quirk``): the emissive-hit MIS
pdf omits the 1/area factor (Hit.hlsl:160-165); the RIS weights take the
RED channel of the float3 brdf expression (Hit.hlsl:280-281).
"""

from __future__ import annotations

import torch

from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import bsdf, restir
from royaltracer_dx_tpu_torch.ops.intersect import interpolate_hit_p
from royaltracer_dx_tpu_torch.ops.light_sampling import (
    fold_barycentric,
    select_light_records,
)
from royaltracer_dx_tpu_torch.utils import pvec as pv
from royaltracer_dx_tpu_torch.utils.rng import tea_batch_major, tea_random

# v5 numeric constants (Common.hlsl:1-3)
_EPS = 1e-4
_BIAS = 1e-5
_T_MIN = 1e-4
_T_MAX = 1e4


def _fetch_material(scene, mat_id) -> dict:
    """Per-lane material record as planar fields (:59-97): one packed
    [count, 27] row gather (the JAX package's one-hot select loop for small
    tables gives the same values)."""
    m = scene.materials
    packed = torch.cat([m.kd[:, :3], m.ks, m.ke, m.pr_pm_ps_pc[:, :2], m.lut],
                       dim=1)
    row = packed[mat_id.long()]
    return dict(
        kd=tuple(row[:, c] for c in range(3)),
        ks=tuple(row[:, 3 + c] for c in range(3)),
        ke=tuple(row[:, 6 + c] for c in range(3)),
        rough=row[:, 9],
        metal=row[:, 10],
        lut=tuple(row[:, 11 + k] for k in range(16)),
    )


def _ris_nee(scene, mat, pos, normal, flat, outgoing, strategy, seed,
             ris_m: int, cfg: RenderConfig):
    """RIS over ris_m NEE candidates + one shadow ray (:100-189).  Inputs
    are [N] planes; the candidates are a candidate-major [M, N] batch drawn
    with ``tea_batch_major``.  Returns (direct planar vec, not yet
    multiplied by the throughput; seed)."""
    us, seed = tea_batch_major(seed, 3 * ris_m)         # [3M, N]
    u_sel, xi1, xi2 = us[0::3], us[1::3], us[2::3]

    shade_origin = pv.add(pos, pv.scale(flat, _BIAS))
    rec = select_light_records(scene.light_table, scene.lights.cdf, u_sel)
    lv0, lv1, lv2 = tuple(rec[0:3]), tuple(rec[3:6]), tuple(rec[6:9])
    nl = tuple(rec[9:12])
    pdf_l = rec[12]
    emission = tuple(rec[13:16])

    bu, bv, bw = fold_barycentric(xi1, xi2)
    point = tuple(bu * a + bv * b + bw * c for a, b, c in zip(lv0, lv1, lv2))

    l_vec = pv.sub(point, shade_origin)                 # [M, N]
    dist2 = torch.clamp_min(pv.dot(l_vec, l_vec), _EPS)
    dist = torch.clamp_min(torch.sqrt(dist2), _EPS)
    l_norm = pv.scale(l_vec, 1.0 / dist)

    # v5 does not flip the light normal toward the shading point
    cosx = torch.clamp_min(pv.dot(normal, l_norm), _EPS)
    cosy = torch.clamp_min(pv.dot(nl, pv.neg(l_norm)), _EPS)
    g = torch.clamp_min(cosx * cosy / dist2, _EPS)

    brdf = bsdf.eval_bsdf_p(strategy, mat["kd"], mat["ks"], mat["rough"],
                            mat["lut"], normal, l_norm, outgoing)
    pdf_b = torch.clamp_min(
        bsdf.pdf_bsdf_p(strategy, mat["rough"], normal, l_norm, outgoing),
        _EPS)

    f = pv.mul(emission, pv.scale(brdf, g))
    # the HLSL truncation quirk: the scalar weight takes channel 0 of
    # avg(Ke) * brdf * G (Hit.hlsl:280-281)
    lum = pv.avg(emission) * brdf[0] * g
    wi = (1.0 / ris_m) * lum / pdf_l

    cdf = torch.cumsum(wi, dim=0)
    total = cdf[-1]
    u_ris, seed = tea_random(seed)                      # Hit.hlsl:300
    thr = u_ris * total
    # the first candidate with thr < cdf, else 0 (argmax takes no bools)
    sel = torch.argmax((thr < cdf).to(torch.uint8), dim=0)
    hot = sel[None, :] == torch.arange(ris_m, device=sel.device)[:, None]

    def pick(x):
        # a sum over the one-hot column, as the JAX package does: exact,
        # and a picked -0.0 reads +0.0 there too
        return torch.sum(torch.where(hot, x, 0.0), dim=0)

    f_sel = tuple(pick(c) for c in f)
    lum_sel = pick(lum)
    wx = torch.clamp_min(1.0 / torch.clamp_min(lum_sel, _EPS) * total, _EPS)
    ldir_sel = tuple(pick(c) for c in l_norm)
    dist_sel = pick(dist)
    cosy_sel = pick(cosy)
    pdfb_sel = pick(pdf_b)
    pdfl_sel = pick(pdf_l)

    # a lane whose ray missed has dist_sel = inf: t_min is NaN and the
    # lane can never read as occluded (its answer is discarded anyway)
    occluded = restir._any_dispatch(scene, shade_origin, ldir_sel, cfg,
                                    dist_sel * 0.0 + _BIAS,
                                    dist_sel - _BIAS)
    visible = torch.where(occluded, 0.0, 1.0)

    direct = pv.scale(f_sel, visible * wx)
    pdf_l_sa = torch.clamp_min(pdfl_sel * dist_sel * dist_sel / cosy_sel,
                               _EPS)
    weight_light = pdf_l_sa / (pdf_l_sa + pdfb_sel)
    return pv.scale(direct, weight_light), seed


def bounce_step(scene, st: dict, bounce: int, cfg: RenderConfig) -> dict:
    """One bounce of the megakernel over the lane state dict (:192-314).
    ``st``: origin / direction / throughput / emission / prev_normal
    [N, 3], pdf_prev [N], seed [N, 2] int64, alive [N] bool, rays (a 0-d
    float32 tensor: closest-hit rays of the lanes entering the bounce plus
    one shadow ray per shaded lane)."""
    hit = restir._closest_dispatch(scene, st["origin"], st["direction"], cfg,
                                   _T_MIN, _T_MAX)
    origin = pv.from_aos(st["origin"], axis=1)
    direction = pv.from_aos(st["direction"], axis=1)
    throughput = pv.from_aos(st["throughput"], axis=1)

    valid = st["alive"] & hit.valid
    pos = pv.add(origin, pv.scale(direction, hit.t))
    _, normal, flat, area = interpolate_hit_p(hit, scene.tri_verts,
                                              scene.tri_normals)
    mat_id = scene.tri_material[hit.tri]
    # flip both normals toward the ray origin (Hit.hlsl:108-111)
    to_viewer = pv.neg(direction)
    normal = pv.where(pv.dot(normal, to_viewer) < 0.0, pv.neg(normal), normal)
    flat = pv.where(pv.dot(flat, to_viewer) < 0.0, pv.neg(flat), flat)

    mat = _fetch_material(scene, mat_id)
    is_emissive = pv.length(mat["ke"]) > 0.0

    # ---- emissive hit: MIS-weighted termination (Hit.hlsl:126-174); the
    # weight is 1 at bounce 0
    l_vec = pv.sub(pos, origin)
    dist2 = torch.clamp_min(pv.dot(l_vec, l_vec), _EPS)
    l_norm = pv.scale(l_vec, torch.rsqrt(dist2))
    cos_emissive = torch.clamp_min(pv.dot(normal, pv.neg(l_norm)), _EPS)
    avg_ke = pv.avg(mat["ke"])
    weight_tri = area * avg_ke / torch.clamp_min(scene.lights.total_weight,
                                                 _EPS)
    if cfg.reference_mis_quirk:
        pdf_l = torch.clamp_min(weight_tri * dist2 / cos_emissive, _EPS)
    else:
        pdf_l = torch.clamp_min(
            weight_tri / torch.clamp_min(area, _EPS) * dist2 / cos_emissive,
            _EPS)
    if bounce == 0:
        w_mis = torch.ones_like(pdf_l)
    else:
        w_mis = st["pdf_prev"] / (st["pdf_prev"] + pdf_l)
    emissive_contrib = pv.scale(pv.mul(mat["ke"], throughput), w_mis)

    # ---- non-emissive: strategy pick, RIS NEE, BSDF continuation
    outgoing = to_viewer
    strategy, _, seed = bsdf.select_strategy_p(
        mat["ks"], mat["metal"], mat["rough"], normal, outgoing, st["seed"])
    direct, seed = _ris_nee(scene, mat, pos, normal, flat, outgoing,
                            strategy, seed, cfg.ris_m, cfg)
    direct = pv.mul(direct, throughput)

    new_dir, seed = bsdf.sample_bsdf_p(strategy, mat["ks"], mat["rough"],
                                       outgoing, normal, seed)
    pdf_sample = torch.clamp_min(
        bsdf.pdf_bsdf_p(strategy, mat["rough"], normal, new_dir, outgoing),
        1e-4)
    brdf_sample = bsdf.eval_bsdf_p(strategy, mat["kd"], mat["ks"],
                                   mat["rough"], mat["lut"], normal, new_dir,
                                   outgoing)
    cos_new = pv.dot(normal, new_dir)
    new_throughput = pv.mul(throughput,
                            pv.scale(brdf_sample, cos_new / pdf_sample))

    shade_mask = valid & ~is_emissive
    emis_mask = valid & is_emissive
    contrib = tuple(torch.where(shade_mask, torch.abs(d), 0.0)
                    + torch.where(emis_mask, torch.abs(e), 0.0)
                    for d, e in zip(direct, emissive_contrib))

    alive = shade_mask
    throughput = pv.where(shade_mask, new_throughput, throughput)
    seed = torch.where(shade_mask[:, None], seed, st["seed"])

    # ---- russian roulette (RayGen.hlsl:118-130) past rr_threshold; at
    # earlier bounces the JAX package's masked step changes nothing
    if bounce > cfg.rr_threshold:
        u_rr, seed_rr = tea_random(seed)
        q = torch.clamp(torch.maximum(torch.maximum(throughput[0],
                                                    throughput[1]),
                                      throughput[2]), 0.05, 1.0)
        rr_on = alive
        kill = rr_on & (u_rr > q)
        alive = alive & ~kill
        rr_scale = torch.where(rr_on & alive, 1.0 / q, 1.0)
        throughput = pv.scale(throughput, rr_scale)
        seed = torch.where(rr_on[:, None], seed_rr, seed)

    new_origin = pv.where(shade_mask, pv.add(pos, pv.scale(flat, _BIAS)),
                          origin)
    new_direction = pv.where(shade_mask, new_dir, direction)
    prev_n = pv.where(shade_mask, normal,
                      pv.from_aos(st["prev_normal"], axis=1))
    return dict(
        origin=pv.to_aos(new_origin, axis=1),
        direction=pv.to_aos(new_direction, axis=1),
        throughput=pv.to_aos(throughput, axis=1),
        pdf_prev=torch.where(shade_mask, pdf_sample, st["pdf_prev"]),
        seed=seed,
        emission=st["emission"] + pv.to_aos(contrib, axis=1),
        alive=alive,
        prev_normal=pv.to_aos(prev_n, axis=1),
        rays=(st["rays"] + torch.sum(st["alive"].to(torch.float32))
              + torch.sum(shade_mask.to(torch.float32))),
    )


def init_path_state(origins, directions, seeds) -> dict:
    """Fresh lane state (:317-335)."""
    zero3 = origins * 0.0
    zero = zero3[:, 0]
    return dict(
        origin=origins,
        direction=directions,
        throughput=zero3 + 1.0,
        pdf_prev=zero + 1.0,
        seed=seeds,
        emission=zero3,
        alive=zero > -1.0,
        prev_normal=zero3,
        rays=torch.sum(zero),
    )


def trace_paths(scene, origins, directions, seeds, cfg: RenderConfig):
    """One path per lane, ``cfg.max_bounces`` bounce steps (:338-367).
    Seeds must already include the caller's jitter draws.  Returns
    (radiance [N, 3], rays traced as a 0-d tensor)."""
    st = init_path_state(origins, directions, seeds)
    for b in range(cfg.max_bounces):
        st = bounce_step(scene, st, b, cfg)
    return st["emission"], st["rays"]
