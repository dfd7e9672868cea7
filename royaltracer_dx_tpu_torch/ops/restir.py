"""ReSTIR DI building blocks (port of royaltracer_dx_tpu/ops/restir.py).

Tracing with v6 hit semantics, reconnection p-hat, NEE / BSDF candidates,
pairwise MIS, spatial rejection tests and reprojection: the planar forms
(:583-1011) that the renderer and restir_gi call, and the AoS forms
(:281-580, :808, :1011) of the reference-shaped API, whose traces go
through the same dispatch.  ``wants_chunking`` and ``_chunked_rays``
(:109-168) are not ported: they cap the JAX package's trace memory, and
every port path traces a batch in one piece (below).

Trace dispatch: the JAX package's decisions on every device.  Under
traversal "bvh" every closest-hit and occlusion batch goes through the
LBVH (ops/traverse.py), under "cluster" through the clusters in tiles of
``cfg.cluster_tile`` rays (ops/cluster_traverse.py), as in the JAX package
(:198-207, :235-243).  Otherwise ``resolve_closest_mode`` /
``resolve_any_mode`` (:88-107) pick brute force (ops/brute_trace.py: the
``brute_closest`` / ``brute_any`` kernels) or the stream traversal
(``closest_hit_stream_xla`` / ``any_hit_stream_xla`` in
ops/stream_trace.py, with the Morton presort on windowed scenes,
``_wants_presort``, :77-85): "auto" takes brute force below
``STREAM_AUTO_MIN_TRIS`` triangles, and scattered closest-hit batches of
fewer than 2^20 rays on flat-path scenes go to brute force too.  Each
route launches its kernels for CUDA tensors and runs their plain versions
for CPU tensors.  Each batch is counted and spanned as
``trace.<query>.<route>`` (utils/telemetry.py).

The JAX package splits trace batches above 4M rays into sequential chunks
aligned to 128 rays (``_chunked_rays``, :143-168) to fit TPU HBM; on an
80 GB card a whole 1080p batch — pass 3's fused 9N = 18.7M segments
included — fits, so the port traces every batch in one piece.  That
equals the chunked trace everywhere but under the cluster traversal with
a ``cluster_tile`` that does not divide 128, where the chunk boundaries
would cut tiles, and so decide answers: the port refuses such a batch
above 2^22 rays (``cluster_tile_for``).
"""

from __future__ import annotations

import torch

from royaltracer_dx_tpu_torch.config import (
    EPSILON,
    MISS_MATERIAL_ID,
    S_BIAS,
    STREAM_AUTO_MIN_TRIS,
    RenderConfig,
)
from royaltracer_dx_tpu_torch.ops import bsdf, light_sampling
from royaltracer_dx_tpu_torch.ops.brute_trace import (
    any_hit_brute_traced,
    closest_hit_brute_traced,
)
from royaltracer_dx_tpu_torch.ops.cluster_traverse import (
    any_hit_clustered,
    closest_hit_clustered,
)
from royaltracer_dx_tpu_torch.ops.intersect import (
    as_planes3,
    hit_attributes_p,
    interpolate_hit,
)
from royaltracer_dx_tpu_torch.ops.stream_trace import (
    S,
    any_hit_stream_xla,
    closest_hit_stream_xla,
)
from royaltracer_dx_tpu_torch.ops.traverse import any_hit_bvh, closest_hit_bvh
from royaltracer_dx_tpu_torch.scene.types import SceneArrays
from royaltracer_dx_tpu_torch.utils import math3d as m3
from royaltracer_dx_tpu_torch.utils import pvec as pv
from royaltracer_dx_tpu_torch.utils import telemetry
from royaltracer_dx_tpu_torch.utils.rng import (
    tea_batch,
    tea_batch_at,
    tea_batch_major,
)

_T_MAX = 1e4
# the miss sentinel as the int32 the passes carry (uint32 4294967294 -> -2)
MISS_ID_I32 = MISS_MATERIAL_ID - (1 << 32)
# stream_trace.py:1444 — scenes of at most this many clusters take the JAX
# package's single-level flat path (a dispatch input)
_FLAT_MAX_CLUSTERS = 128
# restir.py:140 — the JAX package traces larger batches in chunks
_TRACE_CHUNK_RAYS = 1 << 22


# ------------------------------ dispatch --------------------------------


def _resolve_accel(scene: SceneArrays, cfg: RenderConfig) -> str:
    """cfg.accel with "auto" resolved against the scene size (:56-65)."""
    mode = cfg.accel
    if mode == "auto":
        if (scene.stream is not None
                and scene.num_triangles >= STREAM_AUTO_MIN_TRIS):
            return "stream"
        return "brute"
    return mode


def _is_flat(scene: SceneArrays) -> bool:
    return (scene.stream is not None
            and scene.stream.num_blocks * S <= _FLAT_MAX_CLUSTERS)


def _wants_presort(scene: SceneArrays) -> bool:
    """The Morton ray presort of stream batches (:77-85): on windowed
    scenes only (more than 128 clusters)."""
    return not _is_flat(scene)


def resolve_closest_mode(scene: SceneArrays, cfg: RenderConfig, n: int,
                         coherent: bool) -> str:
    """The JAX package's closest-hit decision (:88-102)."""
    mode = _resolve_accel(scene, cfg)
    if (mode == "stream" and not coherent and _is_flat(scene)
            and n < (1 << 20)):
        mode = "brute"
    return mode


def resolve_any_mode(scene: SceneArrays, cfg: RenderConfig, n: int) -> str:
    """The JAX package's occlusion decision (:105-107)."""
    return _resolve_accel(scene, cfg)


def wants_gi_compaction(scene: SceneArrays, cfg: RenderConfig) -> bool:
    """GI wavefront compaction decision (:115-127): "on", or "auto" on a
    scene whose stream accel has more than 128 clusters (the windowed
    scale, where the traces it saves are expensive)."""
    if cfg.gi_compaction == "on":
        return True
    return (cfg.gi_compaction == "auto" and scene.stream is not None
            and scene.stream.num_blocks * S > _FLAT_MAX_CLUSTERS)


def trace_mode(scene: SceneArrays, cfg: RenderConfig, n: int,
               coherent: bool = True, closest: bool = True) -> str:
    """Which trace a batch takes, the JAX package's decision on every
    device: "bvh" (the LBVH kernels), "cluster" (the cluster kernels),
    "stream" (the stream kernels) or "brute" (the brute-force kernels)."""
    if cfg.accel == "bvh":
        if scene.bvh is None:
            raise ValueError("traversal='bvh' on a scene without an LBVH "
                             "(Scene.flatten(build_bvh=True) builds it)")
        return "bvh"
    if cfg.accel == "cluster":
        if scene.clusters is None:
            raise ValueError("traversal='cluster' on a scene without "
                             "clusters (Scene.flatten(build_clusters=True) "
                             "builds them)")
        return "cluster"
    if closest:
        mode = resolve_closest_mode(scene, cfg, n, coherent)
    else:
        mode = resolve_any_mode(scene, cfg, n)
    if mode == "stream" and scene.stream is None:
        raise ValueError("traversal='stream' on a scene without a stream "
                         "accel (Scene.flatten(build_stream=True) builds it)")
    return mode


def cluster_tile_for(n: int, tile: int) -> int:
    """``tile`` for a cluster trace of ``n`` rays in one piece.  Above
    2^22 rays the JAX package traces 128-aligned chunks (``_chunked_rays``,
    :143-168): a tile that divides 128 keeps the batch's tiles there, one
    that does not is cut by the chunks, so such a batch is refused."""
    if n > _TRACE_CHUNK_RAYS and 128 % tile:
        raise ValueError(
            f"cluster_tile={tile}: a batch of {n} rays (above "
            f"{_TRACE_CHUNK_RAYS}) takes a cluster_tile that divides 128")
    return tile


def _closest_dispatch(scene: SceneArrays, origins, dirs, cfg: RenderConfig,
                      t_min, t_max, coherent: bool = True):
    """The TraceRay dispatch (:171-213)."""
    op, dp = as_planes3(origins), as_planes3(dirs)
    n = op[0].shape[0]
    mode = trace_mode(scene, cfg, n, coherent, True)
    with telemetry.trace("closest", mode, n):
        if mode == "bvh":
            return closest_hit_bvh(op, dp, scene.bvh, t_min, t_max)
        if mode == "cluster":
            tile = cluster_tile_for(n, cfg.cluster_tile)
            return closest_hit_clustered(op, dp, scene.clusters, t_min,
                                         t_max, tile=tile)
        if mode == "stream":
            return closest_hit_stream_xla(op, dp, scene.stream, t_min, t_max,
                                          wb=cfg.stream_wb,
                                          presort=_wants_presort(scene))
        return closest_hit_brute_traced(op, dp, scene.tri_verts, t_min,
                                        t_max)


def _any_dispatch(scene: SceneArrays, origins, dirs, cfg: RenderConfig,
                  t_min, t_max):
    """The shadow TraceRay dispatch (:216-248)."""
    op, dp = as_planes3(origins), as_planes3(dirs)
    n = op[0].shape[0]
    mode = trace_mode(scene, cfg, n, True, False)
    with telemetry.trace("any", mode, n):
        if mode == "bvh":
            return any_hit_bvh(op, dp, scene.bvh, t_min, t_max)
        if mode == "cluster":
            tile = cluster_tile_for(n, cfg.cluster_tile)
            return any_hit_clustered(op, dp, scene.clusters, t_min, t_max,
                                     tile=tile)
        if mode == "stream":
            return any_hit_stream_xla(op, dp, scene.stream, t_min, t_max,
                                      wb=cfg.stream_wb,
                                      presort=_wants_presort(scene))
        return any_hit_brute_traced(op, dp, scene.tri_verts, t_min, t_max)


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


def visibility_check(scene, x1, n1, direction, dist, cfg):
    """V in {0, 1} (:281-287, Sampler_v6.hlsl:86-104); AoS [N, 3]."""
    o = x1 + m3.normalize(n1) * S_BIAS
    t_max = torch.clamp_min(dist - 10.0 * S_BIAS, 2.0 * S_BIAS)
    occ = trace_occluded(scene, o, direction, torch.zeros_like(dist), t_max,
                         cfg)
    return torch.where(occ, 0.0, 1.0)


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


def fetch_material(scene: SceneArrays, mid) -> dict:
    """AoS MaterialOptimized gather (:292-306); the sentinel id maps to the
    all-zero miss material with LUT 1."""
    sentinel = mid == MISS_ID_I32
    safe = torch.where(sentinel, torch.zeros_like(mid), mid).long()
    mats = scene.materials
    z = sentinel[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=mid.device)
    return dict(
        kd=torch.where(z, zero, mats.kd[safe]),
        ks=torch.where(z, zero, mats.ks[safe]),
        ke=torch.where(z, zero, mats.ke[safe]),
        rough=torch.where(sentinel, zero, mats.pr_pm_ps_pc[safe, 0]),
        metal=torch.where(sentinel, zero, mats.pr_pm_ps_pc[safe, 1]),
        lut=torch.where(z, zero + 1.0, mats.lut[safe]),
    )


def _mat_index(mat: dict, idx) -> dict:
    return {k: v[idx] for k, v in mat.items()}


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
    rec = light_sampling.select_light_records(scene.light_table,
                                              scene.lights.cdf, u_sel)
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


def reconnect_di(x1, n1, x2, n2, l2, outgoing, mat):
    """f G reconnection (:318-331, Sampler_v6.hlsl:106-131): the blended
    BRDF x L2 x cos(x1) cos(x2) / dist^2, n2 flipped toward x1."""
    d = x2 - x1
    dist = m3.length(d)
    dn = m3.normalize(d)
    cos1 = torch.clamp_min(m3.dot(n1, dn), 0.0)
    n2f = torch.where((m3.dot(n2, -dn) < 0.0)[..., None], -n2, n2)
    cos2 = torch.clamp_min(m3.dot(n2f, -dn), 0.0)
    f = bsdf.eval_bsdf_blend(mat["kd"], mat["ks"], mat["metal"],
                             mat["rough"], mat["lut"], n1, -dn,
                             m3.normalize(outgoing))
    return f * l2 * (cos1 * cos2
                     / torch.clamp_min(dist * dist, 1e-20))[..., None]


def reconnect_gi(x1, n1, xn, e3, outgoing, mat):
    """GI reconnection (:334-348, Sampler_v6.hlsl:134-161): the blended
    BRDF x |cos(x1)| x E3, non-finite zeroed."""
    dn = m3.normalize(xn - x1)
    cos1 = torch.abs(m3.dot(n1, dn))
    f = bsdf.eval_bsdf_blend(mat["kd"], mat["ks"], mat["metal"],
                             mat["rough"], mat["lut"], n1, -dn,
                             m3.normalize(outgoing))
    fr = f * cos1[..., None] * e3
    finite = torch.all(torch.isfinite(fr), dim=-1, keepdim=True)
    return torch.where(finite, fr, 0.0)


def get_p_hat_di(scene, x1, n1, x2, n2, l2, outgoing, mat, use_visibility,
                 cfg):
    """p-hat = |ReconnectDI| (x V) (:351-358, Sampler_v6.hlsl:163-171)."""
    f = m3.linearize(reconnect_di(x1, n1, x2, n2, l2, outgoing, mat))
    if use_visibility:
        d = x2 - x1
        f = f * visibility_check(scene, x1, n1, m3.normalize(d),
                                 m3.length(d), cfg)
    return f


def get_p_hat_gi(scene, x1, n1, xn, e3, outgoing, mat, use_visibility, cfg):
    """float3 p-hat for GI (:361-368, Sampler_v6.hlsl:173-181)."""
    f = reconnect_gi(x1, n1, xn, e3, outgoing, mat)
    if use_visibility:
        d = xn - x1
        v = visibility_check(scene, x1, n1, m3.normalize(d), m3.length(d),
                             cfg)
        f = f * v[..., None]
    return f


def nee_candidates(scene, x1, normal, outgoing, mat, strategy, seed,
                   m_count: int):
    """M NEE candidates a lane, batched (:374-438, SampleLightNEE,
    Sampler_v6.hlsl:273-396, visibility off as in SampleRIS).  Returns
    (dict of [N, M] p_hat, pdf_light, pdf_bsdf (area measure), dist and
    [N, M, 3] x2, n2, emission, l_norm; seed)."""
    n = x1.shape[0]
    lights = scene.lights
    us, seed = tea_batch(seed, 3 * m_count)
    us = us.reshape(n, m_count, 3)
    idx = light_sampling.select_light(lights, us[..., 0]).long()
    wv = light_sampling.light_world_verts(lights, scene.object_to_world, idx)
    bu, bv, bw = light_sampling.fold_barycentric(us[..., 1], us[..., 2])
    point = (bu[..., None] * wv[..., 0, :] + bv[..., None] * wv[..., 1, :]
             + bw[..., None] * wv[..., 2, :])
    l_vec = point - x1[:, None, :]
    dist2 = m3.dot(l_vec, l_vec)
    dist = torch.sqrt(torch.clamp_min(dist2, EPSILON))
    l_norm = l_vec / torch.clamp_min(dist, 1e-20)[..., None]
    cr = m3.cross(wv[..., 1, :] - wv[..., 0, :], wv[..., 2, :] - wv[..., 0, :])
    area = torch.abs(0.5 * m3.length(cr))
    nl = m3.normalize(cr)
    nl = torch.where((m3.dot(nl, -l_norm) < 0.0)[..., None], -nl, nl)
    cos_x = m3.dot(normal[:, None, :], l_norm)
    cos_y = m3.dot(nl, -l_norm)
    g = torch.clamp_min(cos_y * cos_x / torch.clamp_min(dist2, EPSILON),
                        EPSILON)
    pdf_l = lights.weight[idx] / torch.clamp_min(area, EPSILON)
    emission = lights.emission[idx]
    matb = {k: v[:, None] if v.dim() == 1 else v[:, None, :]
            for k, v in mat.items()}
    nb = normal[:, None, :]
    ob = m3.normalize(outgoing)[:, None, :]
    brdf = bsdf.eval_bsdf_blend(matb["kd"], matb["ks"], matb["metal"],
                                matb["rough"], matb["lut"], nb, -l_norm, ob)
    pdf_b = bsdf.pdf_bsdf_blend(matb["ks"], matb["metal"], matb["rough"],
                                nb, -l_norm, ob) \
        * cos_y / torch.clamp_min(dist2, EPSILON)
    pdf_b = torch.where(torch.isfinite(pdf_b), pdf_b, 0.0)
    p_hat = m3.linearize(emission * brdf * g[..., None])
    return dict(p_hat=p_hat, pdf_light=torch.clamp_min(pdf_l, EPSILON),
                pdf_bsdf=pdf_b, x2=point, n2=nl, emission=emission,
                l_norm=l_norm, dist=dist), seed


def nee_candidates_p(scene, x1, normal, outgoing, mat, seed, m_count: int):
    """Planar, candidate-major SampleLightNEE batch (:808-820): [M, N]
    planes from ``tea_batch_major``'s draws 3i, 3i + 1, 3i + 2, and the
    advanced seed.  The passes take one candidate at a time
    (``nee_candidate_at_p``: the same values)."""
    us, seed = tea_batch_major(seed, 3 * m_count)
    return _nee_one(scene, x1, normal, outgoing, mat, us[0::3], us[1::3],
                    us[2::3]), seed


def bsdf_candidate(scene, x1, normal, outgoing, mat, strategy, seed, cfg):
    """One BSDF light candidate: sample the lobe, trace, MIS pdfs
    (:441-479, SampleLightBSDF, Sampler_v6.hlsl:199-271); p_hat = 0 where
    the ray missed or hit a non-emitter.  Returns (dict, seed)."""
    nrm = m3.normalize(outgoing)
    sample, seed = bsdf.sample_bsdf(strategy, mat["ks"], mat["rough"], nrm,
                                    normal, seed)
    hit = trace_closest(scene, x1, sample, cfg, t_min=S_BIAS)
    ke = fetch_material(scene, hit["mid"])["ke"]
    is_light = m3.luminance_avg(ke) * 3.0 > EPSILON
    l_vec = hit["pos"] - x1
    dist2 = torch.clamp_min(m3.dot(l_vec, l_vec), EPSILON)
    cos_t = m3.dot(hit["normal"], -sample)
    # the reference's emissive pdf omits 1/area (quirk kept)
    pdf_light = (m3.luminance_avg(ke) * 3.0 / 3.0) / torch.clamp_min(
        scene.lights.total_weight, EPSILON)
    brdf = bsdf.eval_bsdf_blend(mat["kd"], mat["ks"], mat["metal"],
                                mat["rough"], mat["lut"], normal, -sample,
                                nrm)
    pdf_b = bsdf.pdf_bsdf_blend(mat["ks"], mat["metal"], mat["rough"],
                                normal, -sample, nrm) * cos_t / dist2
    pdf_b = torch.where(torch.isfinite(pdf_b), pdf_b, 0.0)
    ndot = m3.dot(normal, sample)
    p_hat = m3.linearize(brdf * ke * (ndot * cos_t / dist2)[..., None])
    return dict(
        p_hat=torch.where(is_light & hit["valid"], p_hat, 0.0),
        pdf_light=torch.where(is_light, pdf_light, 0.0),
        pdf_bsdf=pdf_b, x2=hit["pos"], n2=hit["normal"], emission=ke,
    ), seed


def spatial_candidate_pixels(px, py, width: int, height: int, radius,
                             exponent, tries: int, seed):
    """``tries`` weighted-disk neighbour picks a lane (:509-530,
    GetRandomPixelCircleWeighted, Common_v6.hlsl:203-241); a pick of the
    centre pixel is flagged, not redrawn (the JAX package's documented
    deviation).  Returns (nx [N, T], ny [N, T], is_center [N, T], seed)."""
    n = px.shape[0]
    us, seed = tea_batch(seed, 2 * tries)
    us = us.reshape(n, tries, 2)
    r = radius * torch.pow(us[..., 0], exponent)
    ang = us[..., 1] * 6.2831853
    ox = (torch.cos(ang) * r).to(torch.int32)
    oy = (torch.sin(ang) * r).to(torch.int32)
    nx = mirror_clamp(px[:, None] + ox, width)
    ny = mirror_clamp(py[:, None] + oy, height)
    is_center = (nx == px[:, None]) & (ny == py[:, None])
    return nx, ny, is_center, seed


def reject_normal(n1, n2, threshold):
    """RejectNormal (:536-538, Common_v6.hlsl:333-336)."""
    return m3.dot(n1, n2) < threshold


def reject_distance(x1, x2, cam_pos, threshold):
    """RejectDistance (:541-546, Common_v6.hlsl:343-350)."""
    d1 = m3.length(x1 - cam_pos)
    d2 = m3.length(x2 - cam_pos)
    rel = torch.abs(d1 - d2) / torch.clamp_min(torch.maximum(d1, d2), 1e-20)
    return rel > threshold


def reject_below_surface(d, n):
    return m3.dot(d, n) < 0.0


def jacobian_reconnection(x1_r, x1_q, x2q, n2q):
    """Reconnection-shift Jacobian (:561-571, Sampler_v6.hlsl:48-68)."""
    vq = x2q - x1_q
    vr = x2q - x1_r
    nrm = m3.normalize(n2q)
    cos_q = torch.abs(m3.dot(m3.normalize(-vq), nrm))
    cos_r = torch.abs(m3.dot(m3.normalize(-vr), nrm))
    len_q = m3.dot(vq, vq)
    len_r = m3.dot(vr, vr)
    return ((cos_q / torch.clamp_min(cos_r, 1e-20))
            * (len_r / torch.clamp_min(len_q, 1e-20)))


def reproject_to_prev_pixel(scene, world_pos, obj, prev_view, prev_proj,
                            width: int, height: int):
    """GetBestReprojectedPixel_d (:1011-1037, Sampler_v6.hlsl:738-785):
    current world position -> object space (the inverse of the current
    transform) -> previous world -> previous clip -> pixel; (-1, -1)
    behind the camera.  AoS world_pos [N, 3]; (px, py) int32.  The int
    casts are clamped to +-1e9 as in ``reproject_to_prev_pixel_p``."""
    idx = obj.long()
    o2w = scene.object_to_world[idx]
    prev = scene.prev_object_to_world[idx]
    inv_rot = torch.linalg.inv(o2w[:, :3, :3])
    local = torch.einsum("nij,nj->ni", inv_rot, world_pos - o2w[:, :3, 3])
    pw = (torch.einsum("nij,nj->ni", prev[:, :3, :3], local)
          + prev[:, :3, 3])
    vp = prev_proj @ prev_view
    clip = pw @ vp[:3, :3].T + vp[:3, 3]
    w = pw @ vp[3, :3] + vp[3, 3]
    good = w > 0.0
    ndc = clip[:, :2] / torch.clamp_min(w, 1e-20)[:, None]
    uv = ndc * 0.5 + 0.5
    ux, uy = uv[:, 0], 1.0 - uv[:, 1]
    px = torch.round(torch.clamp(ux * width, -1e9, 1e9)).to(torch.int32)
    py = torch.round(torch.clamp(uy * height, -1e9, 1e9)).to(torch.int32)
    neg = torch.full_like(px, -1)
    return torch.where(good, px, neg), torch.where(good, py, neg)
