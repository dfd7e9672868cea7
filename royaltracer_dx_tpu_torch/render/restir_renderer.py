"""ReSTIR DI+GI progressive renderer (port of
royaltracer_dx_tpu/render/restir_renderer.py:1-1296).

One frame runs the reference's three DispatchRays passes
(Renderer.cpp:611-673):

  pass 1  primary trace, RIS over 4 NEE + 1 BSDF DI candidates,
          visibility-checked W, GI path sampling (init, 3 bounces, final
          shadow)                                         (:221-372)
  pass 2  temporal reuse through the previous frame's packed records
                                                          (:375-520)
  pass 3  spatial reuse: <= 3 candidates from <= 9 weighted-disk tries,
          pairwise MIS with visibility rays, final shade  (:523-969)

then accumulates into the framebuffer and ping-pongs the ``last_*``
buffers (:1177-1196).  Inside the passes everything is planar (tuples of
[N] planes, utils/pvec.py); reservoirs cross frames as AoS dicts keyed
like the JAX dataclasses, so ``state_dict`` uses the npz key names of
io/checkpoint.py:36-57.

Every trace of the frame goes through ops/restir.py, which on the card
launches the stream kernels of csrc/stream_trace.cu.

Pass 3 reads its accept rows from float16 tables exactly where the JAX
package does (:651-653, :756-757) and gathers the chosen candidates'
payload again from the packed shards; otherwise the accept masks differ.
Where a world coordinate passes float16's largest value (65504) those
tables would hold inf and reject every spatial tap, as the JAX package's
do; there they are float32 (``_accept_dtype``), and f16 records, whose
positions would overflow too, raise (``check_world``).
The shards are stored in ``cfg.record_dtype`` (f32, f16 or bf16): values
round through torch.float16 / torch.bfloat16 (round to nearest even, as
XLA's converts do) at the same places as in the JAX package, and the
flags are computed on the stored values (:110-168).

``update()`` refits the scene after ``Scene.set_transform``;
``render_many(k)`` runs k frames with one synchronisation; GI wavefront
compaction (``pass1_gi_bounce_compact``) runs where
``restir.wants_gi_compaction`` says; ``profile = True`` times each pass
and reports the occupancy.

Pixel-band sharding (parallel/shard.py) runs the same passes on a band of
rows: ``xs`` / ``ys`` are the band's GLOBAL pixel coordinates (seeds and
camera rays), and pass 2 / pass 3 index their gather tables through the
band's local window of rows [row0, row0 + band_h), which the sharded
renderer extends by halo rows from the neighbouring bands.  The defaults
(the whole image) give the single-device frame.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from royaltracer_dx_tpu_torch.camera import Camera, generate_rays
from royaltracer_dx_tpu_torch.config import (
    S_BIAS,
    STREAM_AUTO_MIN_TRIS,
    RenderConfig,
)
from royaltracer_dx_tpu_torch.device import resolve_device
from royaltracer_dx_tpu_torch.ops import bsdf, restir, restir_gi
from royaltracer_dx_tpu_torch.ops.reservoir import (
    from_planes,
    get_w,
    is_valid_gi_p,
    to_planes,
    update_reservoir_p,
    zeros_reservoir,
)
from royaltracer_dx_tpu_torch.render.framebuffer import Framebuffer, accumulate
from royaltracer_dx_tpu_torch.scene.scene import Scene
from royaltracer_dx_tpu_torch.utils import math3d as m3
from royaltracer_dx_tpu_torch.utils import pvec as pv
from royaltracer_dx_tpu_torch.utils.rng import (
    pixel_seed,
    tea_batch_at,
    tea_random,
)

_DI_KEYS = ("x2", "n2", "l2")
_GI_KEYS = ("xn", "nn", "e3")
_SD_KEYS = ("x1", "n1", "o", "l1", "mid", "obj")
_RES_KEYS = ("w_sum", "w", "m")
_F = torch.float32
_I = torch.int32
# payload record dtypes (:975-977)
_REC_DTYPES = {"f32": torch.float32, "f16": torch.float16,
               "bf16": torch.bfloat16}
# float16's largest finite value: the bound on world coordinates of the
# f16 accept tables and records
F16_MAX = 65504.0


def _pixel_grid(cfg: RenderConfig, device):
    ys, xs = torch.meshgrid(torch.arange(cfg.height, device=device),
                            torch.arange(cfg.width, device=device),
                            indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _sentinel(mid):
    return mid == restir.MISS_ID_I32


def _zero_di(like) -> dict:
    z = like * 0.0
    zv = (z, z, z)
    return dict(x2=zv, n2=zv, l2=zv, w_sum=z, w=z, m=z)


# ----------------------- packed narrow-row gathers -----------------------


def _tap_gather(table, idx):
    """Every packed-record row gather goes through this seam (:101-107)."""
    return table[idx.long()]


def _len_sq(v3):
    return (v3[..., 0] * v3[..., 0] + v3[..., 1] * v3[..., 1]
            + v3[..., 2] * v3[..., 2])


def _pack_record(sd: dict, res: dict, keys: tuple,
                 dtype=torch.float32) -> tuple:
    """sdata planes + reservoir planes -> three [N, 8] shards stored in
    ``dtype`` (:110-166):

      S0: x1(3) n1(3) mid flags     -- every accept test's columns
      S1: vec0(3) vec1(3) w_sum obj -- GI jacobian tries + payloads
      S2: o(3) vec2(3) w m          -- chosen-candidate epilogue

    flags = (|l1| == 0) + 2 * is_valid, evaluated on the stored-dtype
    values; ids travel as float values (exact below 2^11 in f16)."""
    v0, v1, v2 = (res[k] for k in keys)
    s0, s1, s2 = (torch.stack(c, -1).to(dtype).to(_F) for c in (
        list(sd["x1"]) + list(sd["n1"]),
        list(v0) + list(v1) + [res["w_sum"]],
        list(sd["o"]) + list(v2) + [res["w"], res["m"]]))
    l1_zero = _len_sq(torch.stack(list(sd["l1"]), -1).to(dtype).to(_F)) == 0.0
    w_sum_s = s1[..., 6]
    m_s = s2[..., 7]
    if keys[0] == "x2":     # DI validity (reservoir.is_valid_di_p)
        valid = ((_len_sq(s1[..., 3:6]) > 0.0)       # n2
                 & (_len_sq(s2[..., 3:6]) > 0.0)     # l2
                 & (w_sum_s > 0.0) & (m_s > 0.0))
    else:                   # GI validity (reservoir.is_valid_gi_p)
        valid = (w_sum_s > 0.0) & (m_s > 0.0)
    flags = l1_zero.to(_F) + 2.0 * valid.to(_F)
    s0 = torch.cat([s0, sd["mid"].to(_F)[..., None], flags[..., None]], -1)
    s1 = torch.cat([s1, sd["obj"].to(_F)[..., None]], -1)
    return s0.to(dtype), s1.to(dtype), s2.to(dtype)


def _unpack_record(rows: tuple, keys: tuple) -> tuple[dict, dict]:
    """Gathered shard rows (s0, s1, s2) -> (sdata planes, reservoir
    planes); sd carries ``l1_zero``, res a pre-baked ``valid``
    (:169-189)."""
    r0, r1, r2 = (r.to(_F) for r in rows)
    flags = r0[..., 7]
    sd = dict(
        x1=(r0[..., 0], r0[..., 1], r0[..., 2]),
        n1=(r0[..., 3], r0[..., 4], r0[..., 5]),
        o=(r2[..., 0], r2[..., 1], r2[..., 2]),
        mid=r0[..., 6].to(_I),
        obj=r1[..., 7].to(_I),
        l1_zero=(torch.floor(flags * 0.5) * 2.0 != flags),  # bit 0
    )
    res = _unpack_res(r1, r2, keys)
    res["valid"] = flags >= 2.0
    return sd, res


def _shards_from_legacy(rows, keys: tuple) -> tuple:
    """A legacy monolithic [N, 26] packed table (columns x1 n1 o l1 mid
    obj vec0 vec1 vec2 w_sum w m) as the three shards (:192-206); read by
    the checkpoint loader only."""
    c = rows.to(_F)
    sd = dict(x1=(c[..., 0], c[..., 1], c[..., 2]),
              n1=(c[..., 3], c[..., 4], c[..., 5]),
              o=(c[..., 6], c[..., 7], c[..., 8]),
              l1=(c[..., 9], c[..., 10], c[..., 11]),
              mid=c[..., 12].to(_I), obj=c[..., 13].to(_I))
    res = {keys[0]: (c[..., 14], c[..., 15], c[..., 16]),
           keys[1]: (c[..., 17], c[..., 18], c[..., 19]),
           keys[2]: (c[..., 20], c[..., 21], c[..., 22]),
           "w_sum": c[..., 23], "w": c[..., 24], "m": c[..., 25]}
    return _pack_record(sd, res, keys, rows.dtype)


def _unpack_res(r1, r2, keys: tuple) -> dict:
    """Reservoir planes from gathered S1/S2 rows only (:209-218)."""
    r1 = r1.to(_F)
    r2 = r2.to(_F)
    return {keys[0]: (r1[..., 0], r1[..., 1], r1[..., 2]),
            keys[1]: (r1[..., 3], r1[..., 4], r1[..., 5]),
            keys[2]: (r2[..., 3], r2[..., 4], r2[..., 5]),
            "w_sum": r1[..., 6], "w": r2[..., 6], "m": r2[..., 7]}


# ================================ PASS 1 =================================


def pass1_di(scene, cam: dict, frame: int, cfg: RenderConfig, xs=None,
             ys=None):
    """Primary trace + SampleRIS + visibility W (:224-309, pass1:49-171).
    ``xs`` / ``ys``: the GLOBAL pixel coordinates of the lanes (default:
    the whole image).  Returns (reservoir DI planes, sdata planes,
    gi_inputs, seed)."""
    if xs is None:
        xs, ys = _pixel_grid(cfg, scene.device)
    seed = pixel_seed(xs, ys, 1, frame)
    origins, dirs = generate_rays(cam, cfg.width, cfg.height, xs=xs, ys=ys)
    dirs = m3.normalize(dirs)

    hit = restir.trace_closest_p(scene, origins, dirs, cfg, t_min=1e-4)
    mid = hit["mid"]
    mat = restir.fetch_material_p(scene, mid)
    emissive = pv.length(mat["ke"]) > 0.0
    sampling = hit["valid"] & ~emissive
    zero = sampling.to(_F) * 0.0

    outgoing = pv.neg(pv.from_aos(dirs, 1))
    reservoir = _zero_di(zero)

    # ---- SampleRIS (Sampler_v6.hlsl:653-736)
    strategy, _, seed = bsdf.select_strategy_p(
        mat["ks"], mat["metal"], mat["rough"], hit["normal"], outgoing, seed)
    m1, m2 = cfg.nee_samples_di, cfg.bsdf_samples_di
    # NEE candidate i draws counters 3i..3i+2 of seed_c; the seed
    # advances once for the batch
    seed_c = seed
    _, seed = tea_random(seed)
    # wi = p_hat / (M1 pdf_l + M2 pdf_b): the balance heuristic with the
    # candidate pdf cancelled
    for i in range(m1):
        c = restir.nee_candidate_at_p(scene, hit["pos"], hit["normal"],
                                      outgoing, mat, seed_c, i)
        wi = c["p_hat"] / torch.clamp_min(
            m1 * c["pdf_light"] + m2 * c["pdf_bsdf"], 1e-20)
        ok = sampling & (c["p_hat"] > 0.0) & torch.isfinite(wi)
        reservoir, _, seed = update_reservoir_p(
            reservoir, _DI_KEYS, ok, wi, zero,
            (c["x2"], c["n2"], c["emission"]), seed)
    for _ in range(m2):
        bc, seed = restir.bsdf_candidate_p(
            scene, hit["pos"], hit["normal"], outgoing, mat, strategy, seed,
            cfg, live=sampling)
        wi = bc["p_hat"] / torch.clamp_min(
            m1 * bc["pdf_light"] + m2 * bc["pdf_bsdf"], 1e-20)
        ok = (sampling & (bc["p_hat"] > 0.0) & torch.isfinite(wi)
              & (bc["pdf_bsdf"] > 0.0))
        reservoir, _, seed = update_reservoir_p(
            reservoir, _DI_KEYS, ok, wi, zero,
            (bc["x2"], bc["n2"], bc["emission"]), seed)
    reservoir["m"] = torch.where(sampling, 1.0, reservoir["m"])

    zv = pv.splat(zero)
    sdata = dict(
        x1=pv.where(sampling, hit["pos"], zv),
        n1=pv.where(sampling, pv.normalize(hit["normal"]), zv),
        o=pv.where(sampling, outgoing, zv),
        l1=pv.where(hit["valid"], mat["ke"], zv),
        mid=mid,
        obj=hit["obj"],
    )

    # visibility-checked W (pass1:166-167); lanes that never fed the
    # reservoir trace dead shadow segments
    p_hat = restir.get_p_hat_di_p(
        scene, sdata["x1"], sdata["n1"], reservoir["x2"], reservoir["n2"],
        reservoir["l2"], sdata["o"], mat, True, cfg,
        vis_mask=sampling & (reservoir["w_sum"] > 0.0))
    reservoir["w"] = torch.where(sampling, get_w(reservoir["w_sum"], p_hat),
                                 zero)
    gi_inputs = dict(x1=sdata["x1"], n1=hit["normal"], o=sdata["o"], mid=mid,
                     sampling=sampling)
    return reservoir, sdata, gi_inputs, seed


def pass1_gi_init(scene, gi_inputs: dict, seed, cfg: RenderConfig) -> dict:
    """GI reconnection-vertex bounce (:312-319)."""
    st = restir_gi.gi_init(scene, cfg, gi_inputs["x1"], gi_inputs["n1"],
                           gi_inputs["o"], gi_inputs["mid"], seed,
                           live=gi_inputs["sampling"])
    st["active"] = st["active"] & gi_inputs["sampling"]
    return st


pass1_gi_bounce = restir_gi.gi_bounce


def _tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts and tuples of tensors (and the
    matching leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def pass1_gi_bounce_compact(scene, cfg: RenderConfig, st: dict,
                            bounce: int = 0) -> dict:
    """gi_bounce with wavefront compaction (:325-356): the active lanes
    are stably partitioned to the front (stable argsorts of ~active), and
    when they fit in half the width the bounce runs on that half while
    the dead tail passes through untouched.  Every state leaf, the seeds
    included, moves with its lane, so the result equals the uncompacted
    bounce bit for bit.

    The JAX package picks the half or the full width on the device with
    ``lax.cond(cnt <= half, ...)``; here that choice is one host read of
    the active count per bounce."""
    active = st["active"]
    half = active.shape[0] // 2
    order = torch.argsort((~active).to(torch.uint8), stable=True)
    inverse = torch.argsort(order, stable=True)
    stp = _tree_map(lambda a: a[order], st)
    if int(active.sum()) <= half:
        head = restir_gi.gi_bounce(
            scene, cfg, _tree_map(lambda a: a[:half], stp), bounce)
        stp = _tree_map(lambda h, t: torch.cat([h, t[half:]]), head, stp)
    else:
        stp = restir_gi.gi_bounce(scene, cfg, stp, bounce)
    return _tree_map(lambda a: a[inverse], stp)


def pass1_gi_final(scene, gi_inputs: dict, st: dict, cfg: RenderConfig):
    """gi_finalize + W_GI (:358-372, pass1:176-181)."""
    reservoir, _, seed = restir_gi.gi_finalize(scene, cfg, st)
    mat = restir.fetch_material_p(scene, gi_inputs["mid"])
    f_c = pv.length(restir.get_p_hat_gi_p(
        scene, gi_inputs["x1"], pv.normalize(gi_inputs["n1"]),
        reservoir["xn"], reservoir["e3"], gi_inputs["o"], mat, False, cfg))
    sampling = gi_inputs["sampling"]
    reservoir["w"] = torch.where(sampling, get_w(reservoir["w_sum"], f_c),
                                 0.0)
    reservoir["m"] = sampling.to(_F)
    return reservoir, seed


# ================================ PASS 2 =================================


def pass2_temporal(scene, cam: dict, frame: int, cur_di: dict, cur_gi: dict,
                   sdata: dict, last_packed_di: tuple, last_packed_gi: tuple,
                   cfg: RenderConfig, xs=None, ys=None, row0: int = 0,
                   band_h: int | None = None):
    """Temporal reuse (:378-520, RayGen_v6_pass2.hlsl:47-204).  Reprojected
    pixels outside the image reject temporal reuse (the reference reads
    garbage there).  On a band (xs / ys its global coordinates), the last
    tables hold the rows [row0, row0 + band_h) and a reprojection outside
    them rejects temporal reuse too."""
    if xs is None:
        xs, ys = _pixel_grid(cfg, scene.device)
    if band_h is None:
        band_h = cfg.height
    seed = pixel_seed(xs, ys, 2, frame)
    cam_pos = tuple(cam["view_inv"][c, 3] for c in range(3))
    shading = ~((sdata["l1"][0] != 0.0) | (sdata["l1"][1] != 0.0)
                | (sdata["l1"][2] != 0.0))

    px, py = restir.reproject_to_prev_pixel_p(
        scene, sdata["x1"], sdata["obj"], cam["prev_view"], cam["prev_proj"],
        cfg.width, cfg.height)
    # global image bounds, then the local window of the band's rows
    ly = py - row0
    in_bounds = ((px >= 0) & (px < cfg.width)
                 & (py >= 0) & (py < cfg.height)
                 & (ly >= 0) & (ly < band_h))
    idx = (torch.clamp(ly, 0, band_h - 1) * cfg.width
           + torch.clamp(px, 0, cfg.width - 1))

    # 3 + 2 narrow shard gathers (the GI table shares sdata with DI)
    l_sd, l_di = _unpack_record(
        tuple(_tap_gather(s, idx) for s in last_packed_di), _DI_KEYS)
    l_gi = _unpack_res(_tap_gather(last_packed_gi[1], idx),
                       _tap_gather(last_packed_gi[2], idx), _GI_KEYS)

    mat = restir.fetch_material_p(scene, sdata["mid"])

    # ---- DI acceptance (pass2:89-97)
    accept_di = (
        shading & in_bounds
        & l_sd["l1_zero"]
        & l_di["valid"]
        & ~restir.reject_distance_p(sdata["x1"], l_sd["x1"], cam_pos, 0.1)
        & (l_di["x2"][0] != 0.0) & (l_di["x2"][1] != 0.0)
        & (l_di["x2"][2] != 0.0)
        & (l_sd["mid"] == sdata["mid"])
    )

    cap = float(cfg.temporal_m_cap)
    m_sum = (torch.clamp_max(cur_di["m"], cap)
             + torch.clamp_max(l_di["m"], cap))
    mi_c = restir.pairwise_mis_canonical_temporal(cur_di["m"], l_di["m"],
                                                  m_sum, cap)
    mi_t = restir.pairwise_mis_noncanonical_temporal(cur_di["m"], l_di["m"],
                                                     m_sum, cap)
    last_n2_zero = pv.length(l_di["n2"]) == 0.0
    mi_c = torch.where(last_n2_zero, 1.0, mi_c)
    mi_t = torch.where(last_n2_zero, 0.0, mi_t)

    # both visibility-bearing p-hats of this pass share one shadow batch;
    # rejected lanes trace dead segments
    accept_gi = (
        shading & in_bounds
        & l_sd["l1_zero"]
        & ~restir.reject_w_sum(l_gi["w_sum"], cfg.w_sum_threshold)
        & ~restir.reject_distance_p(sdata["x1"], l_sd["x1"], cam_pos, 0.1)
        & is_valid_gi_p(l_gi)
        & (l_sd["mid"] == sdata["mid"])
    )
    vis_t, vis_t_gi = restir.visibility_batch_p(
        scene,
        [(sdata["x1"], sdata["n1"], l_di["x2"], accept_di),
         (sdata["x1"], sdata["n1"], l_gi["xn"], accept_gi)], cfg)

    w_c = mi_c * restir.get_p_hat_di_p(
        scene, sdata["x1"], sdata["n1"], cur_di["x2"], cur_di["n2"],
        cur_di["l2"], sdata["o"], mat, False, cfg) * cur_di["w"]
    w_t = mi_t * restir.get_p_hat_di_p(
        scene, sdata["x1"], sdata["n1"], l_di["x2"], l_di["n2"], l_di["l2"],
        sdata["o"], mat, False, cfg) * vis_t * l_di["w"]

    merged = dict(
        cur_di,
        m=torch.where(accept_di, torch.clamp_max(cur_di["m"], cap),
                      cur_di["m"]),
        w_sum=torch.where(accept_di, w_c, cur_di["w_sum"]),
    )
    merged, _, seed = update_reservoir_p(
        merged, _DI_KEYS, accept_di, w_t, torch.clamp_max(l_di["m"], cap),
        (l_di["x2"], l_di["n2"], l_di["l2"]), seed)
    p_hat = restir.get_p_hat_di_p(
        scene, sdata["x1"], sdata["n1"], merged["x2"], merged["n2"],
        merged["l2"], sdata["o"], mat, False, cfg)
    merged["w"] = torch.where(accept_di, get_w(merged["w_sum"], p_hat),
                              merged["w"])

    # ---- GI acceptance (pass2:99-106)
    cap_gi = float(cfg.temporal_m_cap_gi)
    m_sum_gi = (torch.clamp_max(cur_gi["m"], cap_gi)
                + torch.clamp_max(l_gi["m"], cap_gi))
    mi_c_gi = restir.pairwise_mis_canonical_temporal(
        cur_gi["m"], l_gi["m"], m_sum_gi, cap_gi)
    mi_t_gi = restir.pairwise_mis_noncanonical_temporal(
        cur_gi["m"], l_gi["m"], m_sum_gi, cap_gi)

    f_c = restir.get_p_hat_gi_p(scene, sdata["x1"], sdata["n1"],
                                cur_gi["xn"], cur_gi["e3"], sdata["o"], mat,
                                False, cfg)
    w_c_gi = mi_c_gi * pv.length(f_c) * cur_gi["w"]
    f_t = restir.get_p_hat_gi_p(scene, sdata["x1"], sdata["n1"], l_gi["xn"],
                                l_gi["e3"], sdata["o"], mat, False, cfg)
    w_t_gi = mi_t_gi * pv.length(f_t) * vis_t_gi * l_gi["w"]

    merged_gi = dict(
        cur_gi,
        m=torch.where(accept_gi, torch.clamp_max(cur_gi["m"], cap_gi),
                      cur_gi["m"]),
        w_sum=torch.where(accept_gi, w_c_gi, cur_gi["w_sum"]),
    )
    merged_gi, _, seed = update_reservoir_p(
        merged_gi, _GI_KEYS, accept_gi, w_t_gi,
        torch.clamp_max(l_gi["m"], cap_gi),
        (l_gi["xn"], l_gi["nn"], l_gi["e3"]), seed)
    p_hat_gi = pv.length(restir.get_p_hat_gi_p(
        scene, sdata["x1"], sdata["n1"], merged_gi["xn"], merged_gi["e3"],
        sdata["o"], mat, False, cfg))
    merged_gi["w"] = torch.where(
        accept_gi, get_w(merged_gi["w_sum"], p_hat_gi), merged_gi["w"])
    return merged, merged_gi


# ================================ PASS 3 =================================


def _spatial_try_at(xs, ys, cfg: RenderConfig, seed, t: int, row0: int = 0,
                    band_h: int | None = None):
    """Weighted-disk neighbor pick #t (:593-625, Common_v6.hlsl:203-241):
    counters 2t / 2t+1 of ``seed``, mirror-clamped at the IMAGE borders.
    The row then becomes a row of the local window [row0, row0 + band_h)
    (the whole image by default; a band's window extended by halo rows
    under sharding).  Returns (local pixel index [N], is_center [N])."""
    if band_h is None:
        band_h = cfg.height
    u_r = tea_batch_at(seed, 2 * t)
    u_a = tea_batch_at(seed, 2 * t + 1)
    r = cfg.spatial_radius * torch.pow(u_r, cfg.spatial_exponent)
    ang = u_a * 6.2831853
    ox = (torch.cos(ang) * r).to(_I)
    oy = (torch.sin(ang) * r).to(_I)
    nx = restir.mirror_clamp(xs + ox, cfg.width)
    ny = restir.mirror_clamp(ys + oy, cfg.height)      # global row mirror
    nx = torch.clamp(nx, 0, cfg.width - 1)
    ly = torch.clamp(ny - row0, 0, band_h - 1)         # local window row
    is_center = (nx == xs) & (ny == ys)
    return ly * cfg.width + nx, is_center


def _accept_dtype(scene) -> torch.dtype:
    """Pass 3's accept tables: float16 as in the JAX package while every
    world coordinate fits it (then every accept mask equals the JAX
    package's), else float32."""
    return torch.float16 if scene.world_abs_max <= F16_MAX else torch.float32


def _claim_first_k(accept_t, pidx_t, cnt, sel_pidx, ok, k: int):
    """Stream one try into the first-k candidate slots (:680-689).  Lanes
    with no accepted try keep try 0's pick; ``ok`` masks it everywhere."""
    if sel_pidx is None:
        sel_pidx = [pidx_t] * k
    for v in range(k):
        take = accept_t & (cnt == v)
        sel_pidx[v] = torch.where(take, pidx_t, sel_pidx[v])
        ok[v] = ok[v] | take
    return cnt + accept_t.to(_I), sel_pidx


def _gi_candidates(cur_gi, sdata, mat, packed_gi, cam_pos, xs, ys, cfg,
                   seed, acc_dtype, row0: int = 0,
                   band_h: int | None = None):
    """GI candidate picks (:628-709, pass3:144-189), one flat [N] pipeline
    per try.  The accept chain reads S0 and S1 from ONE f16 table (f32
    beyond f16's range, ``_accept_dtype``); the k chosen candidates
    re-gather all three f32 shards.  Returns (gi_ok, nb_gi, nb_sd_g,
    seed)."""
    k = cfg.spatial_candidate_count
    rough_ok = mat["rough"] > 0.3
    s01 = torch.cat([packed_gi[0], packed_gi[1]], -1).to(acc_dtype)
    cnt = torch.zeros(xs.shape, dtype=_I, device=xs.device)
    sel_pidx = None
    gi_ok = [torch.zeros(xs.shape, dtype=torch.bool, device=xs.device)
             for _ in range(k)]
    for t in range(cfg.spatial_max_tries):
        pidx_t, is_center_t = _spatial_try_at(xs, ys, cfg, seed, t, row0,
                                              band_h)
        g01 = _tap_gather(s01, pidx_t).to(_F)                  # [N, 16]
        g0, g1 = g01[:, :8], g01[:, 8:]
        g_x1 = (g0[:, 0], g0[:, 1], g0[:, 2])
        g_mid = g0[:, 6].to(_I)
        g_xn = (g1[:, 0], g1[:, 1], g1[:, 2])
        g_nn = (g1[:, 3], g1[:, 4], g1[:, 5])
        jac = restir.jacobian_reconnection_p(g_x1, sdata["x1"], g_xn, g_nn)
        accept_t = (
            ~is_center_t
            & rough_ok
            & ~restir.reject_distance_p(sdata["x1"], g_x1, cam_pos, 0.1)
            & ~restir.reject_below_surface_p(
                pv.normalize(pv.sub(g_xn, sdata["x1"])), sdata["n1"])
            & ~restir.reject_w_sum(g1[:, 6], cfg.w_sum_threshold)
            & (g0[:, 7] == 3.0)   # pack-baked is_valid_gi & |l1| == 0
            & ~restir.reject_jacobian(jac, cfg.j_threshold)
            & ~_sentinel(g_mid)
            & (g_mid == sdata["mid"])
        )
        cnt, sel_pidx = _claim_first_k(accept_t, pidx_t, cnt, sel_pidx,
                                       gi_ok, k)
    _, seed = tea_random(seed)
    nb_gi, nb_sd_g = [], []
    for v in range(k):
        g0v = _tap_gather(packed_gi[0], sel_pidx[v]).to(_F)
        g1v = _tap_gather(packed_gi[1], sel_pidx[v]).to(_F)
        g2v = _tap_gather(packed_gi[2], sel_pidx[v]).to(_F)
        nb_gi.append(dict(
            xn=(g1v[:, 0], g1v[:, 1], g1v[:, 2]),
            nn=(g1v[:, 3], g1v[:, 4], g1v[:, 5]),
            w_sum=g1v[:, 6],
            e3=(g2v[:, 3], g2v[:, 4], g2v[:, 5]),
            w=g2v[:, 6],
            m=g2v[:, 7],
        ))
        nb_sd_g.append(dict(
            x1=(g0v[:, 0], g0v[:, 1], g0v[:, 2]),
            n1=(g0v[:, 3], g0v[:, 4], g0v[:, 5]),
            o=(g2v[:, 0], g2v[:, 1], g2v[:, 2]),
        ))
    return gi_ok, nb_gi, nb_sd_g, seed


def pass3_spatial(scene, cam: dict, frame: int, cur_di: dict, cur_gi: dict,
                  sdata: dict, cfg: RenderConfig, xs=None, ys=None,
                  row0: int = 0, band_h: int | None = None,
                  packed_di_ext=None, packed_gi_ext=None):
    """Spatial reuse + final shade (:712-969, RayGen_v6_pass3.hlsl:47-463).
    Returns (radiance sample [N, 3], shading mask, out_di planes, out_gi
    planes).  On a band (see pass2_temporal), ``packed_di_ext`` /
    ``packed_gi_ext`` are the current frame's packed tables over the
    band's halo-extended window, so that taps cross band borders; without
    them the tables are packed here from this call's lanes."""
    if xs is None:
        xs, ys = _pixel_grid(cfg, scene.device)
    seed = pixel_seed(xs, ys, 3, frame)
    cam_pos = tuple(cam["view_inv"][c, 3] for c in range(3))
    shading = ~((sdata["l1"][0] != 0.0) | (sdata["l1"][1] != 0.0)
                | (sdata["l1"][2] != 0.0))
    mat = restir.fetch_material_p(scene, sdata["mid"])
    k = cfg.spatial_candidate_count
    zero = shading.to(_F) * 0.0

    if packed_di_ext is None:
        rd = _rec_dtype(cfg)
        packed_di = _pack_record(sdata, cur_di, _DI_KEYS, rd)
        packed_gi = _pack_record(sdata, cur_gi, _GI_KEYS, rd)
    else:
        packed_di, packed_gi = packed_di_ext, packed_gi_ext

    # ---- DI candidates (pass3:107-142): each try gathers only the f16
    # ACCEPT row (x1/n1/mid/flags; f32 beyond f16's range); the k chosen
    # candidates' payload, origins included, re-gathers from the f32
    # shards
    acc_dtype = _accept_dtype(scene)
    acc_di = packed_di[0].to(acc_dtype)
    cnt = torch.zeros(xs.shape, dtype=_I, device=xs.device)
    sel_pidx = None
    di_ok = [torch.zeros(xs.shape, dtype=torch.bool, device=xs.device)
             for _ in range(k)]
    for t in range(cfg.spatial_max_tries):
        pidx_t, is_center_t = _spatial_try_at(xs, ys, cfg, seed, t, row0,
                                              band_h)
        r0 = _tap_gather(acc_di, pidx_t).to(_F)                # [N, 8]
        c_mid = r0[:, 6].to(_I)
        accept_t = (
            ~is_center_t
            & ~restir.reject_normal_p(
                sdata["n1"], (r0[:, 3], r0[:, 4], r0[:, 5]), 0.9)
            & ~restir.reject_distance_p(
                sdata["x1"], (r0[:, 0], r0[:, 1], r0[:, 2]), cam_pos, 0.1)
            & (r0[:, 7] == 3.0)   # pack-baked is_valid_di & |l1| == 0
            & ~_sentinel(c_mid)
            & (c_mid == sdata["mid"])
        )
        cnt, sel_pidx = _claim_first_k(accept_t, pidx_t, cnt, sel_pidx,
                                       di_ok, k)
    _, seed = tea_random(seed)
    nb_di, nb_sd = [], []
    for v in range(k):
        r0v = _tap_gather(packed_di[0], sel_pidx[v]).to(_F)
        r2v = _tap_gather(packed_di[2], sel_pidx[v]).to(_F)
        nb_di.append(_unpack_res(_tap_gather(packed_di[1], sel_pidx[v]), r2v,
                                 _DI_KEYS))
        nb_sd.append(dict(
            x1=(r0v[:, 0], r0v[:, 1], r0v[:, 2]),
            n1=(r0v[:, 3], r0v[:, 4], r0v[:, 5]),
            o=(r2v[:, 0], r2v[:, 1], r2v[:, 2]),
        ))

    cap = float(cfg.spatial_m_cap)
    m_sum = torch.clamp_max(cur_di["m"], cap)
    for v in range(k):
        m_sum = m_sum + torch.where(
            di_ok[v], torch.clamp_max(nb_di[v]["m"], cap), zero)

    # canonical MIS (MIS_v6.hlsl:2-35); p_hat_from uses visibility rays
    c_m_min = torch.clamp_max(cur_di["m"], cap)
    c_m_max = m_sum - c_m_min
    p_c = restir.get_p_hat_di_p(scene, sdata["x1"], sdata["n1"],
                                cur_di["x2"], cur_di["n2"], cur_di["l2"],
                                sdata["o"], mat, False, cfg)
    c_m_num = c_m_min * p_c
    mi_c = c_m_min / torch.clamp_min(m_sum, 1e-9)
    # every visibility-bearing p-hat of this pass (k DI p_hat_from, k GI
    # p_hat_from, k GI shift targets) shares ONE 3k*N shadow batch
    gi_ok, nb_gi, nb_sd_g, seed = _gi_candidates(
        cur_gi, sdata, mat, packed_gi, cam_pos, xs, ys, cfg, seed, acc_dtype,
        row0, band_h)
    vis_all = [] if k == 0 else restir.visibility_batch_p(
        scene,
        [(nb_sd[v]["x1"], nb_sd[v]["n1"], cur_di["x2"], shading & di_ok[v])
         for v in range(k)]
        + [(nb_sd_g[v]["x1"], nb_sd_g[v]["n1"], cur_gi["xn"],
            shading & gi_ok[v]) for v in range(k)]
        + [(sdata["x1"], sdata["n1"], nb_gi[v]["xn"], shading & gi_ok[v])
           for v in range(k)],
        cfg)
    vis_from = vis_all[:k]
    vis_from_g = vis_all[k:2 * k]
    vis_fs = vis_all[2 * k:]
    for v in range(k):
        p_from = restir.get_p_hat_di_p(
            scene, nb_sd[v]["x1"], nb_sd[v]["n1"], cur_di["x2"],
            cur_di["n2"], cur_di["l2"], nb_sd[v]["o"], mat, False,
            cfg) * vis_from[v]
        n_m_min = torch.clamp_max(nb_di[v]["m"], cap)
        m_den = c_m_num + c_m_max * p_from
        ratio = torch.where(
            m_den > 0.0,
            (n_m_min / torch.clamp_min(m_sum, 1e-9))
            * (c_m_num / torch.clamp_min(m_den, 1e-20)),
            zero)
        mi_c = mi_c + torch.where(di_ok[v], ratio, zero)

    w_c = mi_c * p_c * cur_di["w"]
    out_di = dict(
        cur_di,
        m=torch.where(shading, c_m_min, cur_di["m"]),
        w_sum=torch.where(shading, w_c, cur_di["w_sum"]),
    )

    # noncanonical merges (MIS_v6.hlsl:38-60)
    for v in range(k):
        nb, nbs = nb_di[v], nb_sd[v]
        p_from = restir.get_p_hat_di_p(
            scene, nbs["x1"], nbs["n1"], cur_di["x2"], cur_di["n2"],
            cur_di["l2"], nbs["o"], mat, False, cfg)
        m_num = (m_sum - c_m_min) * p_from
        m_den = m_num + c_m_min * p_c
        mi_s = torch.where(
            m_den > 0.0,
            (torch.clamp_max(nb["m"], cap) / torch.clamp_min(m_sum, 1e-9))
            * (m_num / torch.clamp_min(m_den, 1e-20)),
            zero)
        w_s = mi_s * restir.get_p_hat_di_p(
            scene, sdata["x1"], sdata["n1"], nb["x2"], nb["n2"], nb["l2"],
            sdata["o"], mat, False, cfg) * nb["w"]
        ok = shading & di_ok[v]
        out_di, _, seed = update_reservoir_p(
            out_di, _DI_KEYS, ok, w_s, torch.clamp_max(nb["m"], cap),
            (nb["x2"], nb["n2"], nb["l2"]), seed)

    cap_g = float(cfg.spatial_m_cap_gi)
    m_sum_g = torch.clamp_max(cur_gi["m"], cap_g)
    for v in range(k):
        m_sum_g = m_sum_g + torch.where(
            gi_ok[v], torch.clamp_max(nb_gi[v]["m"], cap_g), zero)

    cg_m_min = torch.clamp_max(cur_gi["m"], cap_g)
    cg_m_max = m_sum_g - cg_m_min
    p_c_gi = pv.length(restir.get_p_hat_gi_p(
        scene, sdata["x1"], sdata["n1"], cur_gi["xn"], cur_gi["e3"],
        sdata["o"], mat, False, cfg))
    cg_num = cg_m_min * p_c_gi
    mi_c_gi = cg_m_min / torch.clamp_min(m_sum_g, 1e-9)
    for v in range(k):
        nbs = nb_sd_g[v]
        j_v = restir.jacobian_reconnection_p(
            sdata["x1"], nbs["x1"], cur_gi["xn"], cur_gi["nn"])
        p_from = pv.length(restir.get_p_hat_gi_p(
            scene, nbs["x1"], nbs["n1"], cur_gi["xn"], cur_gi["e3"],
            nbs["o"], mat, False, cfg)) * vis_from_g[v] * j_v
        m_den = cg_num + cg_m_max * p_from
        ratio = torch.where(
            m_den > 0.0,
            (torch.clamp_max(nb_gi[v]["m"], cap_g)
             / torch.clamp_min(m_sum_g, 1e-9))
            * (cg_num / torch.clamp_min(m_den, 1e-20)),
            zero)
        mi_c_gi = mi_c_gi + torch.where(gi_ok[v], ratio, zero)
    mi_c_gi = torch.clamp(mi_c_gi, 0.0, 1.0)

    w_c_gi = mi_c_gi * p_c_gi * cur_gi["w"]
    out_gi = dict(
        cur_gi,
        m=torch.where(shading, cg_m_min, cur_gi["m"]),
        w_sum=torch.where(shading, w_c_gi, cur_gi["w_sum"]),
    )

    for v in range(k):
        nb, nbs = nb_gi[v], nb_sd_g[v]
        j_mis = restir.jacobian_reconnection_p(
            sdata["x1"], nbs["x1"], cur_gi["xn"], cur_gi["nn"])
        p_from = pv.length(restir.get_p_hat_gi_p(
            scene, nbs["x1"], nbs["n1"], cur_gi["xn"], cur_gi["e3"],
            nbs["o"], mat, False, cfg)) * j_mis
        m_num = (m_sum_g - cg_m_min) * p_from
        m_den = m_num + cg_m_min * p_c_gi
        mi_s = torch.where(
            m_den > 0.0,
            torch.clamp((torch.clamp_max(nb["m"], cap_g)
                         / torch.clamp_min(m_sum_g, 1e-9))
                        * (m_num / torch.clamp_min(m_den, 1e-20)), 0.0, 1.0),
            zero)
        j_shift = restir.jacobian_reconnection_p(
            nbs["x1"], sdata["x1"], nb["xn"], nb["nn"])
        f_s = pv.length(restir.get_p_hat_gi_p(
            scene, sdata["x1"], sdata["n1"], nb["xn"], nb["e3"], sdata["o"],
            mat, False, cfg)) * vis_fs[v]
        w_s = mi_s * f_s * nb["w"] * j_shift
        ok = shading & gi_ok[v] & (j_shift != 0.0)
        out_gi, _, seed = update_reservoir_p(
            out_gi, _GI_KEYS, ok, w_s, torch.clamp_max(nb["m"], cap_g),
            (nb["xn"], nb["nn"], nb["e3"]), seed)

    # ---- final shade (pass3:334-372); non-shading / empty-reservoir
    # lanes trace dead shadow segments
    p_hat_final = restir.get_p_hat_di_p(
        scene, sdata["x1"], sdata["n1"], out_di["x2"], out_di["n2"],
        out_di["l2"], sdata["o"], mat, True, cfg,
        vis_mask=shading & (out_di["w_sum"] != 0.0))
    out_di["w"] = torch.where(shading, get_w(out_di["w_sum"], p_hat_final),
                              out_di["w"])
    radiance = pv.scale(
        restir.reconnect_di_p(sdata["x1"], sdata["n1"], out_di["x2"],
                              out_di["n2"], out_di["l2"], sdata["o"], mat),
        out_di["w"])

    f_gi_final = restir.get_p_hat_gi_p(
        scene, sdata["x1"], sdata["n1"], out_gi["xn"], out_gi["e3"],
        sdata["o"], mat, False, cfg)
    out_gi["w"] = torch.where(
        shading, get_w(out_gi["w_sum"], pv.length(f_gi_final)), out_gi["w"])
    radiance = pv.add(radiance, pv.scale(f_gi_final, out_gi["w"]))
    radiance = pv.where(shading, radiance, pv.splat(zero))
    return pv.to_aos(radiance, 1), shading, out_di, out_gi


# ============================== RENDERER =================================


def _rec_dtype(cfg: RenderConfig) -> torch.dtype:
    """The payload records' storage dtype (:975-977)."""
    return _REC_DTYPES[cfg.record_dtype]


def _pack_last(last_di: dict, last_gi: dict, last_sdata: dict,
               dtype=torch.float32) -> tuple:
    """Persistent AoS state -> the two packed shard-tuple gather tables
    (:980-991)."""
    sd = to_planes(last_sdata)
    return (_pack_record(sd, to_planes(last_di), _DI_KEYS, dtype),
            _pack_record(sd, to_planes(last_gi), _GI_KEYS, dtype))


def _frame_body(scene, cam_base: dict, cfg: RenderConfig, st: dict,
                frame: int, tick=None):
    """One full ReSTIR frame as a state -> state function (:994-1042).

    st: dict(last_di, last_gi, last_sdata, fb, l1, prev_view, prev_proj).
    ``tick(label)``, when given, is called after each pass (profile mode).
    Returns (new state, occupancy [1 + gi_bounces] on the device: the
    pass-1 sampling share and each GI bounce's active share, for the ray
    accounting of RestirRenderer.metrics)."""
    tick = tick or (lambda label: None)
    cam = dict(cam_base, prev_view=st["prev_view"], prev_proj=st["prev_proj"])
    res_di, sdata, gi_in, seed = pass1_di(scene, cam, frame, cfg)
    tick("pass1_di")
    occ = [gi_in["sampling"].to(_F).mean()]
    gst = pass1_gi_init(scene, gi_in, seed, cfg)
    # compaction pays two argsorts and two permutations of the whole
    # state per bounce: only worth it where traces are expensive (:1144-
    # 1152), so the decision is restir.wants_gi_compaction's
    compact = restir.wants_gi_compaction(scene, cfg)
    bounce_fn = pass1_gi_bounce_compact if compact else pass1_gi_bounce
    for b in range(cfg.gi_bounces):
        occ.append(gst["active"].to(_F).mean())
        gst = bounce_fn(scene, cfg, gst, b)
    res_gi, _ = pass1_gi_final(scene, gi_in, gst, cfg)
    tick("pass1_gi")
    if cfg.temporal_reuse:
        packed_di, packed_gi = _pack_last(st["last_di"], st["last_gi"],
                                          st["last_sdata"], _rec_dtype(cfg))
        tick("pack_last")
        res_di, res_gi = pass2_temporal(scene, cam, frame, res_di, res_gi,
                                        sdata, packed_di, packed_gi, cfg)
    tick("pass2_temporal")
    sample, shaded, out_di, out_gi = pass3_spatial(
        scene, cam, frame, res_di, res_gi, sdata, cfg)
    tick("pass3_spatial")
    sdata_s = from_planes({k: sdata[k] for k in _SD_KEYS})
    changed = torch.any(torch.abs(cam["view"] - st["prev_view"]) > S_BIAS)
    fb = accumulate(st["fb"], sample, changed, cfg.max_accum_frames)

    # ping-pong: pass 3 writes the last buffers only for shaded lanes
    def pick(new: dict, old: dict) -> dict:
        return {k: torch.where(shaded[:, None] if old[k].dim() == 2
                               else shaded, new[k], old[k]) for k in old}

    new_st = dict(
        last_di=pick(from_planes(out_di), st["last_di"]),
        last_gi=pick(from_planes(out_gi), st["last_gi"]),
        last_sdata=pick(sdata_s, st["last_sdata"]),
        fb=fb,
        l1=sdata_s["l1"],
        prev_view=cam["view"],
        prev_proj=cam["proj"],
    )
    return new_st, torch.stack(occ)


def ray_metrics(cfg: RenderConfig, ov, dt: float, frame: int) -> dict:
    """The frame's ray accounting (:1202-1230) from its occupancy vector
    ``ov`` (float64: the pass-1 sampling share, then each GI bounce's
    active share): lock-step LANES per pixel (pass 1: primary + BSDF-DI +
    W visibility + GI init, bounces, final shadow; pass 2: 2 visibility;
    pass 3: (2k+1) DI + 2k GI visibility), and the ACTIVE rays among
    them."""
    k = cfg.spatial_candidate_count
    b_gi = cfg.gi_bounces
    lanes = cfg.num_pixels * ((3 + 1) + (1 + b_gi + 1) + 2 + (3 * k + 1 + 2))
    s1 = float(ov[0])
    active_pp = (1.0 + 4.0 * s1 + float(ov[1:].sum()) + 2.0 * s1
                 + (3 * k + 1 + 2) * s1)
    rays_active = cfg.num_pixels * active_pp
    return dict(frame_time_s=dt, fps=1.0 / max(dt, 1e-9), frame=frame,
                rays_traced=rays_active, ray_lanes=lanes, pass1_sampling=s1,
                mrays_per_s=rays_active / dt / 1e6,
                mray_lanes_per_s=lanes / dt / 1e6)


def occupancy_metrics(cfg: RenderConfig, ov) -> dict:
    """Profile mode's occupancy entries (:1231-1236)."""
    occupancy = {"pass1_sampling": float(ov[0])}
    for b in range(cfg.gi_bounces):
        occupancy[f"gi_bounce{b}_active"] = float(ov[1 + b])
    return occupancy


def pass_timer(devices, t0: float, pass_times: dict):
    """Profile mode's tick: wait for ``devices``, then book the time since
    the previous tick under ``label`` (:1130-1139).  Every tick is a
    synchronisation, so profiled frames are indicative, not additive."""
    def tick(label: str) -> None:
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        now = time.perf_counter()
        pass_times[label] = now - (t0 + sum(pass_times.values()))
    return tick


def check_config(scene: Scene, cfg: RenderConfig) -> None:
    """Raise for the options a ReSTIR renderer cannot take."""
    restir.check_traversal(cfg)
    if cfg.gi_compaction not in ("auto", "on", "off"):
        raise ValueError(f"gi_compaction={cfg.gi_compaction!r}")
    if cfg.record_dtype not in _REC_DTYPES:
        raise ValueError(f"record_dtype={cfg.record_dtype!r}: one of "
                         f"{sorted(_REC_DTYPES)}")
    # material and instance ids travel as values in half-precision
    # columns, exact below 2^(mantissa + 1) (:1074-1082): 2^11 in pass 3's
    # f16 accept tables, which ship at every record_dtype (the JAX package
    # checks only f16/bf16 payloads), 2^8 in bf16 payloads
    lim = 256 if cfg.record_dtype == "bf16" else 2048
    n_mat = len(scene._materials)
    n_inst = len(scene.instance_mesh)
    if n_mat >= lim or n_inst >= lim:
        raise ValueError(
            f"record_dtype='{cfg.record_dtype}' (and pass 3's f16 accept "
            f"tables) need material ({n_mat}) and instance ({n_inst}) "
            f"counts < {lim}")


def check_world(arrays, cfg: RenderConfig) -> None:
    """Raise when f16 records meet a world coordinate beyond float16's
    range: their stored positions would be inf.  Run after every bake
    (construction and ``update()``), where the world bounds are read."""
    if cfg.record_dtype != "f16" or arrays.world_abs_max <= F16_MAX:
        return
    lo, hi = arrays.bounds
    axis, value = max(((a, v) for a in range(3) for v in (lo[a], hi[a])),
                      key=lambda av: abs(av[1]))
    raise ValueError(
        f"record_dtype='f16' stores world positions as float16, whose "
        f"largest finite value is {F16_MAX:g}; this scene has a world "
        f"coordinate {'xyz'[axis]} = {value:g}: use record_dtype='f32' or "
        "'bf16'")


def _wants_stream(scene: Scene, cfg: RenderConfig) -> bool:
    """Build the stream accel for traversal="stream" or a big-scene auto
    (:1290-1296); on the card flatten builds it regardless."""
    if cfg.accel == "stream":
        return True
    return (cfg.accel == "auto"
            and scene.num_triangles >= STREAM_AUTO_MIN_TRIS)


class RestirRenderer:
    """Progressive ReSTIR DI+GI renderer over a Scene (:1059-1287).

    ``device=None`` renders on the card and raises when there is none;
    the tests pass ``device="cpu"``."""

    def __init__(self, scene: Scene, camera: Camera, cfg: RenderConfig,
                 device=None):
        check_config(scene, cfg)
        self.device = resolve_device(device)
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.materials = scene.build_materials(device=self.device)
        self.scene_arrays = scene.flatten(
            self.materials, build_stream=_wants_stream(scene, cfg),
            build_bvh=cfg.accel == "bvh", bvh_leaf_size=cfg.bvh_leaf_size,
            device=self.device)
        check_world(self.scene_arrays, cfg)
        n = cfg.num_pixels
        dev = self.device
        self.last_di = zeros_reservoir(n, _DI_KEYS, dev)
        self.last_gi = zeros_reservoir(n, _GI_KEYS, dev)
        self.last_sdata = dict(
            {k: torch.zeros((n, 3), dtype=_F, device=dev)
             for k in ("x1", "n1", "o", "l1")},
            mid=torch.full((n,), restir.MISS_ID_I32, dtype=_I, device=dev),
            obj=torch.zeros((n,), dtype=_I, device=dev))
        self.fb = Framebuffer.create(n, dev)
        self.l1 = torch.zeros((n, 3), dtype=_F, device=dev)
        self.frame = 0
        self._prev_view = torch.zeros((4, 4), dtype=_F, device=dev)
        self._prev_proj = torch.zeros((4, 4), dtype=_F, device=dev)
        self.metrics: dict = {}
        # opt-in per-pass timing and occupancy (each pass ends in a sync)
        self.profile = False

    def _camera_arrays(self) -> dict:
        mats = self.camera.matrices(self.cfg.width / self.cfg.height)
        return {k: torch.as_tensor(v, dtype=_F, device=self.device)
                for k, v in mats.items()}

    def _state(self) -> dict:
        return dict(last_di=self.last_di, last_gi=self.last_gi,
                    last_sdata=self.last_sdata, fb=self.fb, l1=self.l1,
                    prev_view=self._prev_view, prev_proj=self._prev_proj)

    def update(self, camera: Camera | None = None) -> None:
        """Refit the scene after ``Scene.set_transform`` (and optionally
        move the camera) (:1110-1113): the world bake and the stream
        accel's refit run on the renderer's device."""
        if camera is not None:
            self.camera = camera
        self.scene_arrays = self.scene.flatten(self.materials,
                                               prev=self.scene_arrays)
        check_world(self.scene_arrays, self.cfg)

    def _set_state(self, st: dict) -> None:
        self.last_di = st["last_di"]
        self.last_gi = st["last_gi"]
        self.last_sdata = st["last_sdata"]
        self.fb = st["fb"]
        self.l1 = st["l1"]
        self._prev_view = st["prev_view"]
        self._prev_proj = st["prev_proj"]

    def render(self) -> None:
        """One progressive frame (:1115-1236)."""
        cfg = self.cfg
        # seed term: the frame counter, or wall-clock nanos cut to uint32
        # (the reference's camera-buffer time, Renderer.cpp:1754-1761)
        if cfg.seed_mode == "time":
            frame = time.time_ns() & 0xFFFFFFFF
        else:
            frame = self.frame
        t0 = time.perf_counter()
        pass_times: dict = {}
        tick = (pass_timer([self.device], t0, pass_times) if self.profile
                else None)
        st, occ = _frame_body(self.scene_arrays, self._camera_arrays(), cfg,
                              self._state(), frame, tick)
        self._set_state(st)
        ov = occ.double().cpu().numpy()   # waits for the frame
        dt = time.perf_counter() - t0
        self.frame += 1
        self.metrics = ray_metrics(cfg, ov, dt, self.frame)
        if self.profile:
            self.metrics["pass_times_s"] = pass_times
            self.metrics["occupancy"] = occupancy_metrics(cfg, ov)

    def render_many(self, k: int) -> None:
        """Render k frames and synchronise once at the end (:1238-1271):
        the same frames as k ``render()`` calls, without the per-frame
        host read of the ray accounting.  (Where GI compaction is on, each
        bounce still reads its active count.)  Camera and scene stay fixed
        across the batch; the metrics are per batch."""
        if self.cfg.seed_mode == "time":
            raise ValueError("render_many needs deterministic seed_mode="
                             "'frame' (time advances per call, not per "
                             "frame)")
        cam = self._camera_arrays()
        st = self._state()
        t0 = time.perf_counter()
        for i in range(int(k)):
            st, _ = _frame_body(self.scene_arrays, cam, self.cfg, st,
                                self.frame + i)
        float(st["fb"].count[0])          # the one wait for the batch
        dt = time.perf_counter() - t0
        self._set_state(st)
        self.frame += int(k)
        self.metrics = dict(frame_time_s=dt / max(k, 1),
                            fps=k / max(dt, 1e-9), frame=self.frame,
                            batch_frames=int(k), batch_time_s=dt)

    def radiance(self) -> np.ndarray:
        """Linear image: accumulated shade, L1 passthrough for
        emissive-primary pixels (:1273-1280, pass3:458-463)."""
        avg = self.fb.accum / torch.clamp_min(self.fb.count, 1.0)[:, None]
        emissive = torch.any(self.l1 != 0, dim=-1)
        out = torch.where(emissive[:, None], self.l1, avg)
        return out.cpu().numpy().reshape(self.cfg.height, self.cfg.width, 3)

    def image(self, srgb: bool = True) -> np.ndarray:
        img = np.nan_to_num(self.radiance(), nan=0.0, posinf=0.0)
        if srgb:
            img = m3.srgb_gamma(torch.clamp_min(torch.as_tensor(img),
                                                0.0)).numpy()
        return np.clip(img, 0.0, 1.0)

    # ------------------------------ state --------------------------------

    def state_dict(self) -> dict:
        """Progressive state as numpy arrays under the npz key names of the
        JAX package's checkpoint (io/checkpoint.py:36-57)."""
        out = {"format": np.asarray("restir"),
               "frame": np.asarray(self.frame),
               "prev_view": self._prev_view.cpu().numpy(),
               "prev_proj": self._prev_proj.cpu().numpy(),
               "fb.accum": self.fb.accum.cpu().numpy(),
               "fb.count": self.fb.count.cpu().numpy(),
               "l1": self.l1.cpu().numpy()}
        for name in ("last_di", "last_gi", "last_sdata"):
            for k, v in getattr(self, name).items():
                out[f"{name}.{k}"] = v.cpu().numpy()
        return out

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict`` (or a JAX-package checkpoint's arrays)
        of the same resolution onto this renderer's device."""
        if str(state.get("format", "restir")) != "restir":
            raise ValueError(f"state format {state['format']!r} is not a "
                             "single-device ReSTIR state")
        n = int(np.asarray(state["fb.accum"]).shape[0])
        if n != self.cfg.num_pixels:
            raise ValueError(f"state has {n} pixels, the renderer "
                             f"{self.cfg.num_pixels}")

        def t(key, dtype=_F):
            return torch.as_tensor(np.asarray(state[key]), dtype=dtype,
                                   device=self.device)

        self.frame = int(np.asarray(state["frame"]))
        self._prev_view = t("prev_view")
        self._prev_proj = t("prev_proj")
        self.fb = Framebuffer(accum=t("fb.accum"), count=t("fb.count"))
        self.l1 = t("l1")
        for name in ("last_di", "last_gi", "last_sdata"):
            cur = getattr(self, name)
            setattr(self, name, {k: t(f"{name}.{k}", cur[k].dtype)
                                 for k in cur})
