"""ReSTIR DI building blocks: a frozen copy of the port's
``ops/restir.py`` (planar and AoS forms) as the benchmark's plain
reference.  Its dispatch is replaced: every closest-hit and occlusion
batch is answered by brute force against every triangle
(``reference/trace.py``), whatever route the program takes.
"""

from __future__ import annotations

import torch

from reference.config import (
    EPSILON,
    MISS_MATERIAL_ID,
    S_BIAS,
    RenderConfig,
)
from reference import bsdf, light_sampling, trace
from reference.intersect import (
    as_planes3,
    hit_attributes_p,
    interpolate_hit,
)
from reference.scene import SceneArrays
from reference import pvec as pv
from reference.rng import tea_batch_at

_T_MAX = 1e4
# the miss sentinel as the int32 the passes carry (uint32 4294967294 -> -2)
MISS_ID_I32 = MISS_MATERIAL_ID - (1 << 32)


# ------------------------------ dispatch --------------------------------


def _closest_dispatch(scene: SceneArrays, origins, dirs, cfg: RenderConfig,
                      t_min, t_max, coherent: bool = True):
    """Every closest-hit batch: brute force against every triangle
    (``trace.closest_hit``), whatever route the program takes."""
    return trace.closest_hit(as_planes3(origins), as_planes3(dirs),
                             scene.tri_verts, t_min, t_max,
                             dtype=scene.trace_dtype)


def _any_dispatch(scene: SceneArrays, origins, dirs, cfg: RenderConfig,
                  t_min, t_max):
    """Every occlusion batch: brute force (``trace.any_hit``)."""
    return trace.any_hit(as_planes3(origins), as_planes3(dirs),
                         scene.tri_verts, t_min, t_max,
                         dtype=scene.trace_dtype)


def trace_closest(scene: SceneArrays, origins, dirs, cfg: RenderConfig,
                  t_min=1e-4) -> dict:
    """AoS TraceRay + ClosestHit/Miss (:251-273): dict(pos [N, 3],
    normal [N, 3], area, mid, obj, valid); v6 smooth normals, no flip
    toward the ray; misses get the sentinel material id and zeros."""
    hit = _closest_dispatch(scene, origins, dirs, cfg, t_min, _T_MAX)
    pos = origins + hit.t[:, None] * dirs
    _, normal, _, area = interpolate_hit(hit, scene.tri_verts,
                                         scene.tri_normals)
    valid = hit.valid
    v3 = valid[:, None]
    zero = _z(area)
    return dict(
        pos=torch.where(v3, pos, zero),
        normal=torch.where(v3, normal, zero),
        area=torch.where(valid, area, zero),
        mid=torch.where(valid, scene.tri_material[hit.tri],
                        torch.full_like(scene.tri_material[hit.tri],
                                        MISS_ID_I32)),
        obj=torch.where(valid, scene.tri_instance[hit.tri],
                        torch.zeros_like(scene.tri_instance[hit.tri])),
        valid=valid,
    )


def trace_occluded(scene, origins, dirs, t_min, t_max, cfg):
    """Shadow TraceRay (ShadowRay.hlsl, :276-278)."""
    return _any_dispatch(scene, origins, dirs, cfg, t_min, t_max)


# --------------------------- planar core ---------------------------------


def _z(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def fetch_material_p(scene: SceneArrays, mid) -> dict:
    """Planar MaterialOptimized fetch; the sentinel id maps to the miss
    material: zeros, LUT = 1 (:583-620).  One packed row gather."""
    sentinel = mid == MISS_ID_I32
    mats = scene.materials
    packed = torch.cat([mats.kd[:, :3], mats.ks, mats.ke,
                        mats.pr_pm_ps_pc[:, :2], mats.lut], dim=1)  # [M, 27]
    safe = torch.where(sentinel, torch.zeros_like(mid), mid).long()
    row = packed[safe]
    zero = _z(row)
    one = zero + 1.0

    def col(k, miss):
        return torch.where(sentinel, miss, row[:, k])

    return dict(
        kd=tuple(col(c, zero) for c in range(3)),
        ks=tuple(col(3 + c, zero) for c in range(3)),
        ke=tuple(col(6 + c, zero) for c in range(3)),
        rough=col(9, zero),
        metal=col(10, zero),
        lut=tuple(col(11 + k, one) for k in range(16)),
    )


def trace_closest_p(scene: SceneArrays, origins, dirs, cfg: RenderConfig,
                    t_min=1e-4, coherent: bool = True, live=None) -> dict:
    """Planar trace_closest (:623-657): planar hit record, v6 semantics (no
    normal flip toward the ray).  ``live``: lanes whose hit some consumer
    reads; the rest trace dead segments (t_max < t_min) and return the miss
    record."""
    o = as_planes3(origins)
    d = as_planes3(dirs)
    t_max = _T_MAX
    if live is not None and cfg.retire_dead_lanes:
        t_max = torch.where(live, _T_MAX, -1.0)
    hit = _closest_dispatch(scene, o, d, cfg, t_min, t_max,
                            coherent=coherent)
    pos = pv.add(o, pv.scale(d, hit.t))
    normal, _, area, mid, obj = hit_attributes_p(hit, scene.tri_table)
    valid = hit.valid
    zero = _z(area)
    zv = pv.splat(zero)
    return dict(
        pos=pv.where(valid, pos, zv),
        normal=pv.where(valid, normal, zv),
        area=torch.where(valid, area, zero),
        mid=torch.where(valid, mid, torch.full_like(mid, MISS_ID_I32)),
        obj=torch.where(valid, obj, torch.zeros_like(obj)),
        valid=valid,
    )


def visibility_check_p(scene, x1, n1, direction, dist, cfg):
    """Planar V in {0, 1} (:660-671, Sampler_v6.hlsl:86-104); a negative
    dist marks a masked lane (dead segment, V = 1)."""
    o = pv.add(x1, pv.scale(pv.normalize(n1), S_BIAS))
    t_max = torch.where(dist < 0.0, -1.0,
                        torch.clamp_min(dist - 10.0 * S_BIAS, 2.0 * S_BIAS))
    occ = trace_occluded(scene, o, direction, torch.zeros_like(dist), t_max,
                         cfg)
    return torch.where(occ, 0.0, 1.0)


def visibility_batch_p(scene, queries, cfg) -> list:
    """ONE shadow trace for several planar visibility queries (:674-726).

    queries: list of (x1, n1, x_to[, mask]) planar tuples over [N] lanes;
    masked lanes trace dead segments and read V = 1.  The per-query math is
    visibility_check_p's and the trace is per-ray exact, so results equal k
    separate checks.  The whole batch is one trace (see the module note on
    ``_chunked_rays``)."""
    kq = len(queries)
    n = queries[0][0][0].shape[0]

    def dist_of(q):
        d = pv.sub(q[2], q[0])
        dist = pv.length(d)
        if len(q) > 3 and q[3] is not None:
            dist = torch.where(q[3], dist, -1.0)
        return d, dist

    if kq == 1:
        d, dist = dist_of(queries[0])
        return [visibility_check_p(scene, queries[0][0], queries[0][1],
                                   pv.normalize(d), dist, cfg)]

    def cat(ps):
        return tuple(torch.cat([p[c] for p in ps]) for c in range(3))

    x1 = cat([q[0] for q in queries])
    n1 = cat([q[1] for q in queries])
    dd = [dist_of(q) for q in queries]
    d = cat([d_ for d_, _ in dd])
    dist = torch.cat([ds for _, ds in dd])
    v = visibility_check_p(scene, x1, n1, pv.normalize(d), dist, cfg)
    return [v[i * n:(i + 1) * n] for i in range(kq)]


def reconnect_di_p(x1, n1, x2, n2, l2, outgoing, mat):
    """Planar ReconnectDI (:729-742, Sampler_v6.hlsl:106-131)."""
    d = pv.sub(x2, x1)
    dist2 = pv.dot(d, d)
    dn = pv.normalize(d)
    cos1 = torch.clamp_min(pv.dot(n1, dn), 0.0)
    n2f = pv.where(pv.dot(n2, pv.neg(dn)) < 0.0, pv.neg(n2), n2)
    cos2 = torch.clamp_min(pv.dot(n2f, pv.neg(dn)), 0.0)
    f = bsdf.eval_bsdf_blend_p(mat["kd"], mat["ks"], mat["metal"],
                               mat["rough"], mat["lut"], n1, dn,
                               pv.normalize(outgoing))
    g = cos1 * cos2 / torch.clamp_min(dist2, 1e-20)
    return pv.scale(pv.mul(f, l2), g)


def reconnect_gi_p(x1, n1, xn, e3, outgoing, mat):
    """Planar GI reconnection; non-finite zeroed (:745-758)."""
    d = pv.sub(xn, x1)
    dn = pv.normalize(d)
    cos1 = torch.abs(pv.dot(n1, dn))
    f = bsdf.eval_bsdf_blend_p(mat["kd"], mat["ks"], mat["metal"],
                               mat["rough"], mat["lut"], n1, dn,
                               pv.normalize(outgoing))
    fr = pv.mul(pv.scale(f, cos1), e3)
    finite = (torch.isfinite(fr[0]) & torch.isfinite(fr[1])
              & torch.isfinite(fr[2]))
    return pv.where(finite, fr, pv.splat(_z(fr[0])))


def get_p_hat_di_p(scene, x1, n1, x2, n2, l2, outgoing, mat, use_visibility,
                   cfg, vis_mask=None):
    """Planar p-hat = |ReconnectDI| (x V) (:761-775)."""
    f = pv.length(reconnect_di_p(x1, n1, x2, n2, l2, outgoing, mat))
    if use_visibility:
        d = pv.sub(x2, x1)
        dist = pv.length(d)
        if vis_mask is not None:
            dist = torch.where(vis_mask, dist, -1.0)
        f = f * visibility_check_p(scene, x1, n1, pv.normalize(d), dist, cfg)
    return f


def get_p_hat_gi_p(scene, x1, n1, xn, e3, outgoing, mat, use_visibility,
                   cfg, vis_mask=None):
    """Planar float3 p-hat for GI (:778-789)."""
    f = reconnect_gi_p(x1, n1, xn, e3, outgoing, mat)
    if use_visibility:
        d = pv.sub(xn, x1)
        dist = pv.length(d)
        if vis_mask is not None:
            dist = torch.where(vis_mask, dist, -1.0)
        v = visibility_check_p(scene, x1, n1, pv.normalize(d), dist, cfg)
        f = pv.scale(f, v)
    return f


def nee_candidate_at_p(scene, x1, normal, outgoing, mat, seed, i):
    """NEE candidate #i as flat [N] planes; counters 3i..3i+2 of
    ``tea_batch_at`` (:792-805).  The caller advances the seed once."""
    u_sel = tea_batch_at(seed, 3 * i)
    xi1 = tea_batch_at(seed, 3 * i + 1)
    xi2 = tea_batch_at(seed, 3 * i + 2)
    return _nee_one(scene, x1, normal, outgoing, mat, u_sel, xi1, xi2)


def _nee_one(scene, x1, normal, outgoing, mat, u_sel, xi1, xi2):
    """Shared SampleLightNEE body (:823-870, Sampler_v6.hlsl:273-396,
    visibility off as in SampleRIS)."""
    lights = scene.lights
    rec = light_sampling.select_light_records(
        light_sampling.light_tables(lights, scene.object_to_world),
        lights.cdf, u_sel)
    lv0, lv1, lv2 = (rec[0], rec[1], rec[2]), (rec[3], rec[4], rec[5]), \
        (rec[6], rec[7], rec[8])
    nl = (rec[9], rec[10], rec[11])
    pdf_l = rec[12]
    emission = (rec[13], rec[14], rec[15])

    bu, bv, bw = light_sampling.fold_barycentric(xi1, xi2)
    point = tuple(bu * a + bv * b + bw * c for a, b, c in zip(lv0, lv1, lv2))
    l_vec = pv.sub(point, x1)
    dist2 = pv.dot(l_vec, l_vec)
    dist = torch.sqrt(torch.clamp_min(dist2, EPSILON))
    l_norm = pv.scale(l_vec, 1.0 / torch.clamp_min(dist, 1e-20))
    nl = pv.where(pv.dot(nl, pv.neg(l_norm)) < 0.0, pv.neg(nl), nl)
    cos_x = pv.dot(normal, l_norm)
    cos_y = pv.dot(nl, pv.neg(l_norm))
    g = torch.clamp_min(cos_y * cos_x / torch.clamp_min(dist2, EPSILON),
                        EPSILON)
    ob = pv.normalize(outgoing)
    brdf = bsdf.eval_bsdf_blend_p(mat["kd"], mat["ks"], mat["metal"],
                                  mat["rough"], mat["lut"], normal, l_norm,
                                  ob)
    pdf_b = bsdf.pdf_bsdf_blend_p(mat["ks"], mat["metal"], mat["rough"],
                                  normal, l_norm, ob) \
        * cos_y / torch.clamp_min(dist2, EPSILON)
    pdf_b = torch.where(torch.isfinite(pdf_b), pdf_b, _z(pdf_b))
    p_hat = pv.length(pv.scale(pv.mul(emission, brdf), g))
    return dict(
        p_hat=p_hat,
        pdf_light=torch.clamp_min(pdf_l, EPSILON),
        pdf_bsdf=pdf_b,
        x2=point,
        n2=nl,
        emission=emission,
        l_norm=l_norm,
        dist=dist,
    )


def bsdf_candidate_p(scene, x1, normal, outgoing, mat, strategy, seed, cfg,
                     live=None):
    """Planar SampleLightBSDF (:873-911, Sampler_v6.hlsl:199-271)."""
    nrm_o = pv.normalize(outgoing)
    sample, seed = bsdf.sample_bsdf_p(strategy, mat["ks"], mat["rough"],
                                      nrm_o, normal, seed)
    hit = trace_closest_p(scene, x1, sample, cfg, t_min=S_BIAS,
                          coherent=False, live=live)
    hmat = fetch_material_p(scene, hit["mid"])
    ke = hmat["ke"]
    is_light = pv.avg(ke) * 3.0 > EPSILON
    l_vec = pv.sub(hit["pos"], x1)
    dist2 = torch.clamp_min(pv.dot(l_vec, l_vec), EPSILON)
    cos_t = pv.dot(hit["normal"], pv.neg(sample))
    # the reference's emissive pdf omits 1/area (quirk kept)
    pdf_light = pv.avg(ke) / torch.clamp_min(scene.lights.total_weight,
                                             EPSILON)
    brdf = bsdf.eval_bsdf_blend_p(mat["kd"], mat["ks"], mat["metal"],
                                  mat["rough"], mat["lut"], normal, sample,
                                  nrm_o)
    pdf_b = bsdf.pdf_bsdf_blend_p(mat["ks"], mat["metal"], mat["rough"],
                                  normal, sample, nrm_o) * cos_t / dist2
    zero = _z(pdf_b)
    pdf_b = torch.where(torch.isfinite(pdf_b), pdf_b, zero)
    ndot = pv.dot(normal, sample)
    p_hat = pv.length(pv.scale(pv.mul(brdf, ke), ndot * cos_t / dist2))
    p_hat = torch.where(is_light & hit["valid"], p_hat, zero)
    return dict(
        p_hat=p_hat,
        pdf_light=torch.where(is_light, pdf_light, zero),
        pdf_bsdf=pdf_b,
        x2=hit["pos"],
        n2=hit["normal"],
        emission=ke,
    ), seed


# ------------------------------ pairwise MIS ----------------------------


def pairwise_mis_canonical_temporal(m_c, m_n, m_sum, m_cap):
    """GenPairwiseMIS_canonical_temporal (:482-487, MIS_v6.hlsl:64-72)."""
    c = torch.clamp_max(m_c, m_cap)
    m = c / torch.clamp_min(m_sum, 1e-9)
    den = c + (m_sum - c)
    return m + torch.where(den > 0.0,
                           (torch.clamp_max(m_n, m_cap) / m_sum) * (c / den),
                           _z(m))


def pairwise_mis_noncanonical_temporal(m_c, m_n, m_sum, m_cap):
    """GenPairwiseMIS_noncanonical_temporal (:490-496, MIS_v6.hlsl:74-81)."""
    num = m_sum - torch.clamp_max(m_c, m_cap)
    den = num + torch.clamp_max(m_c, m_cap)
    return torch.where(
        den > 0.0,
        (torch.clamp_max(m_n, m_cap) / torch.clamp_min(m_sum, 1e-9))
        * num / den,
        _z(num))


# ----------------------- spatial picks and rejections --------------------


def mirror_clamp(x, size: int):
    """Mirror coordinates into [0, size) (:502-506)."""
    x = torch.abs(x)
    return torch.where(x >= size, 2 * size - x - 2, x)


def reject_w_sum(w_sum, threshold):
    return w_sum > threshold


def reject_jacobian(j, threshold):
    return (j > threshold) | (j < 1.0 / threshold) | ~torch.isfinite(j)


def jacobian_reconnection_p(x1_r, x1_q, x2q, n2q):
    """Planar reconnection-shift Jacobian (:914-923, Sampler_v6.hlsl:48-68)."""
    vq = pv.sub(x2q, x1_q)
    vr = pv.sub(x2q, x1_r)
    nrm = pv.normalize(n2q)
    cos_q = torch.abs(pv.dot(pv.normalize(pv.neg(vq)), nrm))
    cos_r = torch.abs(pv.dot(pv.normalize(pv.neg(vr)), nrm))
    len_q = pv.dot(vq, vq)
    len_r = pv.dot(vr, vr)
    return ((cos_q / torch.clamp_min(cos_r, 1e-20))
            * (len_r / torch.clamp_min(len_q, 1e-20)))


def reject_normal_p(n1, n2, threshold):
    return pv.dot(n1, n2) < threshold


def reject_distance_p(x1, x2, cam_pos, threshold):
    d1 = pv.length(pv.sub(x1, cam_pos))
    d2 = pv.length(pv.sub(x2, cam_pos))
    rel = torch.abs(d1 - d2) / torch.clamp_min(torch.maximum(d1, d2), 1e-20)
    return rel > threshold


def reject_below_surface_p(d, n):
    return pv.dot(d, n) < 0.0


# --------------------------- reprojection -------------------------------


def reproject_to_prev_pixel_p(scene, world_pos, obj, prev_view, prev_proj,
                              width: int, height: int):
    """Planar GetBestReprojectedPixel_d (:944-1008, Sampler_v6.hlsl:738-785):
    current world pos -> object local (adjugate inverse of the current
    transform) -> previous world -> previous clip -> pixel.  Returns
    (px, py) int32 with (-1, -1) behind the camera."""
    i_count = scene.object_to_world.shape[0]
    idx = obj.long()
    rows_c = scene.object_to_world.reshape(i_count, 16)[idx]
    rows_p = scene.prev_object_to_world.reshape(i_count, 16)[idx]
    r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2 = \
        [rows_c[:, k] for k in range(12)]
    c00 = r11 * r22 - r12 * r21
    c01 = r02 * r21 - r01 * r22
    c02 = r01 * r12 - r02 * r11
    c10 = r12 * r20 - r10 * r22
    c11 = r00 * r22 - r02 * r20
    c12 = r02 * r10 - r00 * r12
    c20 = r10 * r21 - r11 * r20
    c21 = r01 * r20 - r00 * r21
    c22 = r00 * r11 - r01 * r10
    det = r00 * c00 + r01 * c01 + r02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det,
                                torch.ones_like(det))
    dx = world_pos[0] - t0
    dy = world_pos[1] - t1
    dz = world_pos[2] - t2
    lx = (c00 * dx + c01 * dy + c02 * dz) * inv_det
    ly = (c10 * dx + c11 * dy + c12 * dz) * inv_det
    lz = (c20 * dx + c21 * dy + c22 * dz) * inv_det
    p00, p01, p02, pt0, p10, p11, p12, pt1, p20, p21, p22, pt2 = \
        [rows_p[:, k] for k in range(12)]
    pwx = p00 * lx + p01 * ly + p02 * lz + pt0
    pwy = p10 * lx + p11 * ly + p12 * lz + pt1
    pwz = p20 * lx + p21 * ly + p22 * lz + pt2
    vp = prev_proj @ prev_view
    clip_x = vp[0, 0] * pwx + vp[0, 1] * pwy + vp[0, 2] * pwz + vp[0, 3]
    clip_y = vp[1, 0] * pwx + vp[1, 1] * pwy + vp[1, 2] * pwz + vp[1, 3]
    w = vp[3, 0] * pwx + vp[3, 1] * pwy + vp[3, 2] * pwz + vp[3, 3]
    good = w > 0.0
    inv_w = 1.0 / torch.clamp_min(w, 1e-20)
    ux = (clip_x * inv_w) * 0.5 + 0.5
    uy = 1.0 - ((clip_y * inv_w) * 0.5 + 0.5)
    # torch.round is round-half-to-even, like jnp.round; the clamp keeps
    # the int cast defined far off screen (still out of bounds)
    px = torch.round(torch.clamp(ux * width, -1e9, 1e9)).to(torch.int32)
    py = torch.round(torch.clamp(uy * height, -1e9, 1e9)).to(torch.int32)
    neg = torch.full_like(px, -1)
    return torch.where(good, px, neg), torch.where(good, py, neg)


# ------------------------------ AoS forms --------------------------------


