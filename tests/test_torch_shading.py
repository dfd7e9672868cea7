"""The port's BSDF, light sampling, reservoir and ReSTIR planar functions
against the JAX package, on identical random inputs made with numpy.

Tolerance: integer outputs (strategies, seeds, masks, pixel indices) are
equal and floats agree within 1e-4 relative (1e-6 absolute) on at least
99.9% of the lanes.  The two sides round the same float32 formulas in
different places (XLA fuses and contracts products into FMAs, PyTorch
runs op by op), which moves results by a few ulps; near a cancellation or
a threshold that rare lane may move further, hence the lane share.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.ops import bsdf as jb
from royaltracer_dx_tpu.ops import light_sampling as jls
from royaltracer_dx_tpu.ops import reservoir as jres
from royaltracer_dx_tpu.ops import restir as jre
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.scene.procedural import cornell_box as j_cornell

from royaltracer_dx_tpu_torch import convert
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import bsdf as tb
from royaltracer_dx_tpu_torch.ops import light_sampling as tls
from royaltracer_dx_tpu_torch.ops import reservoir as tres
from royaltracer_dx_tpu_torch.ops import restir as tre

N = 2048
RTOL, ATOL, MIN_LANES = 1e-4, 1e-6, 0.999


def flat(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for v in tree for a in flat(v)]
    a = tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)
    return [a.astype(np.int64) if a.dtype == np.uint32 else a]


def assert_lanes(port, ref):
    lp, lr = flat(port), flat(ref)
    assert len(lp) == len(lr)
    n = lr[0].shape[0]
    agree = np.ones(n, bool)
    for a, b in zip(lp, lr):
        a = np.broadcast_to(a, b.shape)
        if b.dtype.kind == "f":
            ok = np.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
        else:
            ok = a == b
        agree &= ok.reshape(n, -1).all(axis=1)
    assert agree.mean() >= MIN_LANES, f"{agree.mean():.4f} of lanes agree"


def unit(rng, n=N):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def both(a):
    """numpy -> (jax, torch) inputs; dicts and tuples of planes keep
    their structure."""
    if isinstance(a, dict):
        pairs = {k: both(v) for k, v in a.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if isinstance(a, tuple):
        j, t = zip(*(both(x) for x in a))
        return tuple(j), tuple(t)
    if a.dtype == np.uint32:
        return jnp.asarray(a), torch.as_tensor(a.astype(np.int64))
    return jnp.asarray(a), torch.as_tensor(a)


def planes(v):
    return tuple(np.ascontiguousarray(v[:, c]) for c in range(3))


@pytest.fixture(scope="module")
def shading_inputs():
    rng = np.random.default_rng(0)
    n = unit(rng)
    v = unit(rng)
    v = np.where((v * n).sum(1, keepdims=True) < 0, -v, v)
    l = unit(rng)
    mat = dict(
        kd=planes(rng.uniform(0, 1, (N, 3)).astype(np.float32)),
        ks=planes(rng.uniform(0, 1, (N, 3)).astype(np.float32)),
        metal=rng.uniform(0, 1, N).astype(np.float32),
        rough=rng.uniform(0.02, 1, N).astype(np.float32),
        lut=tuple(rng.uniform(0.2, 1, N).astype(np.float32)
                  for _ in range(16)),
    )
    seed = rng.integers(0, 2**32, (N, 2), dtype=np.uint64).astype(np.uint32)
    return dict(n=planes(n), v=planes(v), l=planes(l), mat=mat, seed=seed)


def test_bsdf_planar_forms_match(shading_inputs):
    s = shading_inputs
    (jn, tn), (jv, tv), (jl, tl) = both(s["n"]), both(s["v"]), both(s["l"])
    m = {k: both(v) for k, v in s["mat"].items()}
    J = {k: v[0] for k, v in m.items()}
    T = {k: v[1] for k, v in m.items()}
    assert_lanes(tb.eval_bsdf_blend_p(T["kd"], T["ks"], T["metal"],
                                      T["rough"], T["lut"], tn, tl, tv),
                 jb.eval_bsdf_blend_p(J["kd"], J["ks"], J["metal"],
                                      J["rough"], J["lut"], jn, jl, jv))
    assert_lanes(tb.pdf_bsdf_blend_p(T["ks"], T["metal"], T["rough"], tn, tl,
                                     tv),
                 jb.pdf_bsdf_blend_p(J["ks"], J["metal"], J["rough"], jn, jl,
                                     jv))
    assert_lanes(tb.ess_lookup_hat(T["lut"], tn[2]),
                 jb.ess_lookup_hat(J["lut"], jn[2]))
    js, tsd = both(s["seed"])
    jst = jb.select_strategy_p(J["ks"], J["metal"], J["rough"], jn, jv, js)
    tst = tb.select_strategy_p(T["ks"], T["metal"], T["rough"], tn, tv, tsd)
    assert_lanes(tst, jst)
    assert_lanes(tb.eval_bsdf_p(tst[0], T["kd"], T["ks"], T["rough"],
                                T["lut"], tn, tl, tv),
                 jb.eval_bsdf_p(jst[0], J["kd"], J["ks"], J["rough"],
                                J["lut"], jn, jl, jv))
    assert_lanes(tb.pdf_bsdf_p(tst[0], T["rough"], tn, tl, tv),
                 jb.pdf_bsdf_p(jst[0], J["rough"], jn, jl, jv))
    assert_lanes(tb.sample_bsdf_p(tst[0], T["ks"], T["rough"], tv, tn, tsd),
                 jb.sample_bsdf_p(jst[0], J["ks"], J["rough"], jv, jn, js))


@pytest.fixture(scope="module")
def scenes():
    """The JAX Cornell scene and the same arrays converted to the port."""
    s = j_cornell(emission=18.0)
    ja = s.flatten(s.build_materials())
    d = dict(tri_verts=ja.tri_verts, tri_normals=ja.tri_normals,
             tri_material=ja.tri_material, tri_instance=ja.tri_instance,
             object_to_world=ja.object_to_world,
             prev_object_to_world=ja.prev_object_to_world)
    for grp in ("materials", "lights"):
        obj = getattr(ja, grp)
        for f in dataclasses.fields(obj):
            d[f"{grp}.{f.name}"] = getattr(obj, f.name)
    ta = convert.scene_arrays_from_numpy(
        {k: np.asarray(v) for k, v in d.items()}, device="cpu")
    return ja, ta


def test_light_sampling_matches(scenes):
    ja, ta = scenes
    jt = jls.light_tables(ja.lights, ja.object_to_world)
    tt = tls.light_tables(ta.lights, ta.object_to_world)
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    u = np.random.default_rng(1).uniform(0, 1, (4, N)).astype(np.float32)
    ju, tu = both(u)
    assert_lanes(tuple(x.T for x in tls.select_light_records(
        tls.light_table(ta.lights, ta.object_to_world), ta.lights.cdf, tu)),
        tuple(jnp.asarray(x).T for x in jls.select_light_records(
            jt, ja.lights.cdf, ju)))
    xi = np.random.default_rng(2).uniform(0, 1, (2, N)).astype(np.float32)
    (j1, t1), (j2, t2) = both(xi[0]), both(xi[1])
    assert_lanes(tls.fold_barycentric(t1, t2), jls.fold_barycentric(j1, j2))


def test_update_reservoir_matches():
    rng = np.random.default_rng(3)
    keys = ("x2", "n2", "l2")
    r = {k: planes(rng.normal(size=(N, 3)).astype(np.float32)) for k in keys}
    r.update(w_sum=rng.uniform(0, 2, N).astype(np.float32),
             w=rng.uniform(0, 1, N).astype(np.float32),
             m=rng.integers(0, 4, N).astype(np.float32))
    r["w_sum"][::7] = 0.0
    sample = tuple(planes(rng.normal(size=(N, 3)).astype(np.float32))
                   for _ in keys)
    mask = rng.uniform(size=N) < 0.7
    wi = rng.uniform(0, 3, N).astype(np.float32)
    m_add = np.ones(N, np.float32)
    seed = rng.integers(0, 2**32, (N, 2), dtype=np.uint64).astype(np.uint32)
    args = [both(r), both(mask), both(wi), both(m_add), both(sample),
            both(seed)]
    jr = jres.update_reservoir_p(args[0][0], keys, *(a[0] for a in args[1:]))
    tr = tres.update_reservoir_p(args[0][1], keys, *(a[1] for a in args[1:]))
    assert_lanes(tr, jr)
    assert_lanes(tres.get_w(tr[0]["w_sum"], torch.as_tensor(wi)),
                 jres.get_w(jr[0]["w_sum"], jnp.asarray(wi)))
    assert_lanes(tres.is_valid_di_p(tr[0]), jres.is_valid_di_p(jr[0]))


def test_restir_planar_functions_match(scenes, shading_inputs):
    ja, ta = scenes
    cfg_j, cfg_t = JConfig(width=8, height=8), RenderConfig(width=8, height=8)
    s = shading_inputs
    rng = np.random.default_rng(4)
    # shading points inside the Cornell box, outgoing toward the camera
    x1 = planes(rng.uniform(0.05, 0.95, (N, 3)).astype(np.float32))
    x2 = planes(rng.uniform(0.05, 0.95, (N, 3)).astype(np.float32))
    e3 = planes(rng.uniform(0, 2, (N, 3)).astype(np.float32))
    (jx1, tx1), (jx2, tx2), (je3, te3) = both(x1), both(x2), both(e3)
    (jn, tn), (jv, tv), (jn2, tn2) = both(s["n"]), both(s["v"]), both(s["l"])
    mid = rng.integers(0, 4, N).astype(np.int32)
    mid[::11] = np.int32(-2)                      # the miss sentinel
    jmid, tmid = both(mid)
    jmat = jre.fetch_material_p(ja, jmid)
    tmat = tre.fetch_material_p(ta, tmid)
    assert_lanes(tmat, jmat)
    assert_lanes(tre.reconnect_di_p(tx1, tn, tx2, tn2, te3, tv, tmat),
                 jre.reconnect_di_p(jx1, jn, jx2, jn2, je3, jv, jmat))
    assert_lanes(tre.reconnect_gi_p(tx1, tn, tx2, te3, tv, tmat),
                 jre.reconnect_gi_p(jx1, jn, jx2, je3, jv, jmat))
    js, tsd = both(s["seed"])
    for i in range(3):
        assert_lanes(tre.nee_candidate_at_p(ta, tx1, tn, tv, tmat, tsd, i),
                     jre.nee_candidate_at_p(ja, jx1, jn, jv, jmat, js, i))
    strat = rng.integers(0, 2, N).astype(np.int32)
    jsg, tsg = both(strat)
    live = rng.uniform(size=N) < 0.8
    jlv, tlv = both(live)
    assert_lanes(tre.bsdf_candidate_p(ta, tx1, tn, tv, tmat, tsg, tsd, cfg_t,
                                      live=tlv),
                 jre.bsdf_candidate_p(ja, jx1, jn, jv, jmat, jsg, js, cfg_j,
                                      live=jlv))
    assert_lanes(tre.visibility_batch_p(ta, [(tx1, tn, tx2),
                                             (tx2, tn2, tx1, tlv)], cfg_t),
                 jre.visibility_batch_p(ja, [(jx1, jn, jx2),
                                             (jx2, jn2, jx1, jlv)], cfg_j))
    mc, mn = (rng.integers(0, 40, N).astype(np.float32) for _ in range(2))
    (jmc, tmc), (jmn, tmn) = both(mc), both(mn)
    for fn in ("pairwise_mis_canonical_temporal",
               "pairwise_mis_noncanonical_temporal"):
        assert_lanes(getattr(tre, fn)(tmc, tmn, tmc + tmn, 16.0),
                     getattr(jre, fn)(jmc, jmn, jmc + jmn, 16.0))
    jac_t = tre.jacobian_reconnection_p(tx1, tx2, te3, tn)
    jac_j = jre.jacobian_reconnection_p(jx1, jx2, je3, jn)
    assert_lanes(jac_t, jac_j)
    cam = (jnp.float32(0.5), jnp.float32(0.5), jnp.float32(1.7))
    cam_t = (torch.tensor(0.5), torch.tensor(0.5), torch.tensor(1.7))
    assert_lanes((tre.reject_normal_p(tn, tn2, 0.9),
                  tre.reject_distance_p(tx1, tx2, cam_t, 0.1),
                  tre.reject_below_surface_p(tv, tn),
                  tre.reject_jacobian(jac_t, 5.0)),
                 (jre.reject_normal_p(jn, jn2, 0.9),
                  jre.reject_distance_p(jx1, jx2, cam, 0.1),
                  jre.reject_below_surface_p(jv, jn),
                  jre.reject_jacobian(jac_j, 5.0)))
    px = rng.integers(-40, 80, N).astype(np.int32)
    np.testing.assert_array_equal(
        tre.mirror_clamp(torch.as_tensor(px), 64).numpy(),
        np.asarray(jre.mirror_clamp(jnp.asarray(px), 64)))


def test_trace_and_reprojection_match(scenes):
    ja, ta = scenes
    from royaltracer_dx_tpu.camera import Camera as JCam
    from royaltracer_dx_tpu_torch.camera import Camera as TCam

    cfg_j, cfg_t = JConfig(width=8, height=8), RenderConfig(width=8, height=8)
    rng = np.random.default_rng(5)
    o = planes(np.tile(np.float32([[0.5, 0.5, 1.7]]), (N, 1)))
    d = planes(unit(rng) * np.float32([1, 1, -1]) - np.float32([0, 0, 1]))
    (jo, to), (jd, td) = both(o), both(d)
    jh = jre.trace_closest_p(ja, jo, jd, cfg_j)
    th = tre.trace_closest_p(ta, to, td, cfg_t)
    assert_lanes(th, jh)
    mats = JCam(eye=(0.6, 0.45, 1.8), center=(0.5, 0.5, 0.0)).matrices(1.3)
    tmats = TCam(eye=(0.6, 0.45, 1.8), center=(0.5, 0.5, 0.0)).matrices(1.3)
    obj = np.zeros(N, np.int32)
    jp = jre.reproject_to_prev_pixel_p(ja, jh["pos"], jnp.asarray(obj),
                                       jnp.asarray(mats["view"]),
                                       jnp.asarray(mats["proj"]), 40, 31)
    tp = tre.reproject_to_prev_pixel_p(ta, th["pos"], torch.as_tensor(obj),
                                       torch.as_tensor(tmats["view"]),
                                       torch.as_tensor(tmats["proj"]), 40, 31)
    assert_lanes(tp, jp)
