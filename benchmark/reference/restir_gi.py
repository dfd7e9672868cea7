"""Frozen copy for the benchmark's plain reference: ReSTIR GI path sampling in step form (port of
royaltracer_dx_tpu/ops/restir_gi.py:41-271, Path_Sampler_v6.hlsl:3-286).

  gi_init     — initial BSDF bounce to the reconnection vertex
  gi_bounce   — nee_samples MIS-weighted NEE + one BSDF continuation
  gi_finalize — deferred shadow validation of the winning NEE sample

Dead-lane retirement (restir.py:641-642): inactive lanes trace dead
segments.  (Frozen copy of the port's ``ops/restir_gi.py``, the
benchmark's plain reference.)

Deviation kept from the JAX package: a continuation ray that escapes the
scene terminates the lane.
"""

from __future__ import annotations

import torch

from reference.config import EPSILON, RenderConfig, S_BIAS
from reference import bsdf, restir
from reference.reservoir import update_reservoir_p
from reference import pvec as pv
from reference.rng import tea_random

_GI_KEYS = ("xn", "nn", "e3")


def _zero_reservoir(like) -> dict:
    z = like * 0.0
    zv = (z, z, z)
    return dict(xn=zv, nn=zv, e3=zv, w_sum=z, w=z, m=z)


def gi_init(scene, cfg: RenderConfig, x1, n1, outgoing, mid, seed,
            live=None) -> dict:
    """Initial BSDF bounce -> reconnection vertex (restir_gi.py:47-93)."""
    mat = restir.fetch_material_p(scene, mid)
    outgoing = pv.normalize(outgoing)
    strategy, _, seed = bsdf.select_strategy_p(
        mat["ks"], mat["metal"], mat["rough"], n1, outgoing, seed)
    sample, seed = bsdf.sample_bsdf_p(strategy, mat["ks"], mat["rough"],
                                      outgoing, n1, seed)
    hit = restir.trace_closest_p(scene, x1, sample, cfg, t_min=S_BIAS,
                                 coherent=False, live=live)
    hmat = restir.fetch_material_p(scene, hit["mid"])
    hit_light = pv.length(hmat["ke"]) > 0.0
    active = hit["valid"] & ~hit_light
    f = bsdf.eval_bsdf_blend_p(mat["kd"], mat["ks"], mat["metal"],
                               mat["rough"], mat["lut"], n1, sample, outgoing)
    p = bsdf.pdf_bsdf_blend_p(mat["ks"], mat["metal"], mat["rough"], n1,
                              sample, outgoing)
    ndotl = pv.dot(n1, sample)
    zero = x1[0] * 0.0
    one = zero + 1.0
    zv = (zero, zero, zero)
    return dict(
        active=active,
        acc_f=pv.where(active, pv.scale(f, ndotl), (one, one, one)),
        acc_f_recon=(one, one, one),
        acc_pdf=torch.where(active, p, one),
        acc_l=zv,
        origin=hit["pos"],
        normal=hit["normal"],
        outgoing=pv.neg(sample),
        mid=hit["mid"],
        xn=hit["pos"],
        nn=pv.normalize(hit["normal"]),
        x1_shadow=zv,
        x2_shadow=zv,
        reservoir=_zero_reservoir(zero),
        seed=seed,
    )


def gi_bounce(scene, cfg: RenderConfig, st: dict, bounce: int = 0) -> dict:
    """One GI bounce: nee_samples NEE + one BSDF continuation
    (restir_gi.py:96-251)."""
    seed = st["seed"]
    active = st["active"]
    mat = restir.fetch_material_p(scene, st["mid"])
    outgoing = pv.normalize(st["outgoing"])
    normal = st["normal"]
    origin = st["origin"]
    reservoir = st["reservoir"]
    zero = active.to(torch.float32) * 0.0

    _, _, seed = bsdf.select_strategy_p(mat["ks"], mat["metal"],
                                        mat["rough"], normal, outgoing, seed)

    # ---- NEE samples (SampleLightNEE_GI, solid-angle MIS, shadow deferred)
    nee = cfg.nee_samples
    seed_c = seed
    _, seed = tea_random(seed)
    acc_l = st["acc_l"]
    x1_shadow = st["x1_shadow"]
    x2_shadow = st["x2_shadow"]
    shadow_o = pv.add(origin, pv.scale(pv.normalize(normal), S_BIAS))
    for j in range(nee):
        c = restir.nee_candidate_at_p(scene, origin, normal, outgoing, mat,
                                      seed_c, j)
        cos_x = torch.abs(pv.dot(normal, c["l_norm"]))
        cos_y = torch.clamp_min(pv.dot(c["n2"], pv.neg(c["l_norm"])), 0.0)
        dist2 = c["dist"] ** 2
        pdf_light_sa = torch.where(
            cos_y > 0.0,
            c["pdf_light"] * dist2 / torch.clamp_min(cos_y, EPSILON), zero)
        brdf = bsdf.eval_bsdf_blend_p(mat["kd"], mat["ks"], mat["metal"],
                                      mat["rough"], mat["lut"], normal,
                                      c["l_norm"], outgoing)
        pdf_b_sa = bsdf.pdf_bsdf_blend_p(mat["ks"], mat["metal"],
                                         mat["rough"], normal, c["l_norm"],
                                         outgoing)
        pdf_b_sa = torch.where(torch.isfinite(pdf_b_sa), pdf_b_sa, zero)
        throughput_nee = pv.scale(brdf, cos_x)
        denom = st["acc_pdf"] * pdf_light_sa
        contrib = pv.where(
            denom > 0.0,
            pv.scale(pv.mul(pv.mul(c["emission"], st["acc_f"]),
                            throughput_nee),
                     1.0 / torch.clamp_min(denom, 1e-20)),
            pv.splat(zero))
        mi = pdf_light_sa / torch.clamp_min(nee * pdf_light_sa + pdf_b_sa,
                                            1e-20)
        e_path = pv.scale(contrib, mi)
        wi = pv.length(e_path)
        wi = torch.where(torch.isfinite(wi), wi, zero)
        e_recon = pv.mul(pv.scale(st["acc_f_recon"], mi),
                         pv.mul(c["emission"], throughput_nee))
        reservoir, took, seed = update_reservoir_p(
            reservoir, _GI_KEYS, active & (wi >= 0.0), wi, zero,
            (st["xn"], pv.normalize(st["nn"]), e_recon), seed)
        acc_l = pv.add(acc_l, pv.where(active, e_path, pv.splat(zero)))
        x1_shadow = pv.where(took, shadow_o, x1_shadow)
        x2_shadow = pv.where(took, c["x2"], x2_shadow)

    # ---- BSDF continuation (SampleLightBSDF_GI)
    strategy, _, seed = bsdf.select_strategy_p(
        mat["ks"], mat["metal"], mat["rough"], normal, outgoing, seed)
    sample, seed = bsdf.sample_bsdf_p(strategy, mat["ks"], mat["rough"],
                                      outgoing, normal, seed)
    hit = restir.trace_closest_p(scene, origin, sample, cfg, t_min=S_BIAS,
                                 coherent=False, live=active)
    hmat = restir.fetch_material_p(scene, hit["mid"])
    hit_light = (pv.length(hmat["ke"]) > 0.0) & hit["valid"]
    f = bsdf.eval_bsdf_blend_p(mat["kd"], mat["ks"], mat["metal"],
                               mat["rough"], mat["lut"], normal, sample,
                               outgoing)
    p = bsdf.pdf_bsdf_blend_p(mat["ks"], mat["metal"], mat["rough"], normal,
                              sample, outgoing)
    ndotl = pv.dot(normal, sample)
    throughput_b = pv.scale(f, ndotl)
    l_vec = pv.sub(hit["pos"], origin)
    dist2_b = torch.clamp_min(pv.dot(l_vec, l_vec), EPSILON)
    cos_t = pv.dot(hit["normal"], pv.neg(sample))
    # backside light hits get a zero light pdf (restir_gi.py:193-203)
    pdf_light_b = torch.where(
        hit_light & (cos_t > 0.0),
        (pv.avg(hmat["ke"]) / torch.clamp_min(scene.lights.total_weight,
                                              EPSILON))
        * dist2_b / torch.clamp_min(cos_t, EPSILON),
        zero)
    valid_pdf = p > 1e-7
    acc_pdf_new = st["acc_pdf"] * p
    acc_f_new = pv.mul(st["acc_f"], throughput_b)
    acc_f_recon_new = pv.mul(st["acc_f_recon"], throughput_b)
    contrib_b = pv.where(
        hit_light & valid_pdf & (acc_pdf_new > 1e-20),
        pv.scale(pv.mul(hmat["ke"], acc_f_new),
                 1.0 / torch.clamp_min(acc_pdf_new, 1e-20)),
        pv.splat(zero))
    has_contrib = pv.length(contrib_b) > 0.0
    mi_b = p / torch.clamp_min(nee * pdf_light_b + p, 1e-20)
    e_recon_b = pv.mul(pv.scale(acc_f_recon_new, mi_b), hmat["ke"])
    e_path_b = pv.scale(contrib_b, mi_b)
    wi_b = pv.length(e_path_b)
    wi_b = torch.where(torch.isfinite(wi_b), wi_b, zero)
    update_mask = active & has_contrib
    reservoir, _, seed = update_reservoir_p(
        reservoir, _GI_KEYS, update_mask, wi_b, zero,
        (st["xn"], pv.normalize(st["nn"]), e_recon_b), seed)
    acc_l = pv.add(acc_l, pv.where(update_mask, e_path_b, pv.splat(zero)))
    still = active & ~has_contrib & hit["valid"] & valid_pdf
    return dict(
        active=still,
        acc_f=pv.where(active, acc_f_new, st["acc_f"]),
        acc_f_recon=pv.where(active, acc_f_recon_new, st["acc_f_recon"]),
        acc_pdf=torch.where(active, acc_pdf_new, st["acc_pdf"]),
        acc_l=acc_l,
        origin=pv.where(active, hit["pos"], st["origin"]),
        normal=pv.where(active, hit["normal"], st["normal"]),
        outgoing=pv.where(active, pv.neg(sample), st["outgoing"]),
        mid=torch.where(active, hit["mid"], st["mid"]),
        xn=st["xn"],
        nn=st["nn"],
        x1_shadow=x1_shadow,
        x2_shadow=x2_shadow,
        reservoir=reservoir,
        seed=seed,
    )


def gi_finalize(scene, cfg: RenderConfig, st: dict):
    """Deferred shadow validation of the winning NEE sample
    (restir_gi.py:254-271).  Returns (reservoir, acc_l, seed)."""
    d = pv.sub(st["x2_shadow"], st["x1_shadow"])
    dist = pv.length(d)
    needs = (cfg.nee_samples > 0) & (dist > EPSILON)
    t_min = dist * 0.0 + 0.5 * S_BIAS
    # lanes with no winning NEE sample trace a dead segment
    t_max = torch.where(needs, torch.clamp_min(dist - S_BIAS * 5.0, S_BIAS),
                        dist * 0.0)
    occ = restir.trace_occluded(scene, st["x1_shadow"], pv.normalize(d),
                                t_min, t_max, cfg)
    kill = needs & occ
    reservoir = dict(st["reservoir"])
    reservoir["w_sum"] = torch.where(kill, 0.0, reservoir["w_sum"])
    return reservoir, st["acc_l"], st["seed"]
