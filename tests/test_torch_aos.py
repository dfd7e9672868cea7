"""The port's AoS helpers (math3d, rng.tea_randoms, the AoS BSDF forms,
the reservoir types, select_light, the AoS ReSTIR forms) and
stream_trace.coherence_order against the JAX package, on random inputs
made with numpy, on the CPU.

Bit-exact: TEA draws, select_strategy, select_light, is_valid_*, the
reservoir picks, the reject masks, the spatial picks and reprojected
pixels, coherence_order's permutation and its inverse.  Floats: within
a number of units in the last place of max(|value|, 1), stated per
function below beside what was measured on this CPU: XLA-CPU and PyTorch
differ in cos / sin / rsqrt / pow, in the order of three-term sums and in
fused multiply-adds, and GGX amplifies such an ulp (GGX_ULPS).  The scene functions share one 32-triangle Cornell
scene (brute-force traces in both packages) and use 256 lanes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.ops import bsdf as jbsdf
from royaltracer_dx_tpu.ops import light_sampling as jls
from royaltracer_dx_tpu.ops import reservoir as jres
from royaltracer_dx_tpu.ops import restir as jrestir
from royaltracer_dx_tpu.ops import stream_trace as jst
from royaltracer_dx_tpu.scene.procedural import cornell_box as j_cornell
from royaltracer_dx_tpu.utils import math3d as jm3
from royaltracer_dx_tpu.utils import rng as jrng
from royaltracer_dx_tpu_torch import convert
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import bsdf as tbsdf
from royaltracer_dx_tpu_torch.ops import light_sampling as tls
from royaltracer_dx_tpu_torch.ops import reservoir as tres
from royaltracer_dx_tpu_torch.ops import restir as trestir
from royaltracer_dx_tpu_torch.ops import stream_trace as tst
from royaltracer_dx_tpu_torch.utils import math3d as tm3
from royaltracer_dx_tpu_torch.utils import rng as trng
from test_torch_restir import jax_scene_dict
from test_torch_restir import one_torch_thread  # noqa: F401 (autouse)

N = 256


def ulps(port, ref, scale=1.0):
    """The largest difference in units in the last place of max(|ref|,
    scale); NaN must sit on the same lanes."""
    a = np.asarray(port.numpy() if torch.is_tensor(port) else port,
                   np.float32)
    b = np.asarray(ref, np.float32)
    assert a.shape == b.shape
    assert (np.isnan(a) == np.isnan(b)).all()
    ok = ~np.isnan(b)
    if not ok.any():
        return 0.0
    unit = np.spacing(np.maximum(np.abs(b[ok]), np.float32(scale)))
    return float((np.abs(a[ok] - b[ok]) / unit).max())


def same(port, ref):
    a = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    b = np.asarray(ref)
    if b.dtype == np.uint32:
        b = b.astype(np.int64)
    np.testing.assert_array_equal(a, b)


def tt(x):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a)


def unit(rng, n=N, shape=()):
    v = rng.normal(size=shape + (n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def seeds(rng, n=N):
    return rng.integers(0, 2**32, (n, 2), dtype=np.uint32)


def make_lanes():
    """Random per-lane BSDF inputs: normals, a view direction and a light
    direction in the normal's hemisphere, materials, LUT rows, seeds."""
    rng = np.random.default_rng(5)
    n = unit(rng)
    v = unit(rng)
    v = np.where((v * n).sum(-1, keepdims=True) < 0, -v, v)
    light = unit(rng)
    light = np.where((light * n).sum(-1, keepdims=True) < 0, -light, light)
    return dict(
        n=n, v=v, incoming=-light,
        kd=rng.uniform(0, 1, (N, 4)).astype(np.float32),
        ks=rng.uniform(0, 1, (N, 3)).astype(np.float32),
        rough=rng.uniform(0.02, 1.0, N).astype(np.float32),
        metal=rng.uniform(0, 1, N).astype(np.float32),
        lut=rng.uniform(0.4, 1.0, (N, 16)).astype(np.float32),
        strategy=rng.integers(0, 2, N).astype(np.int32),
        seed=seeds(rng))


@pytest.fixture(scope="module")
def lanes():
    return make_lanes()


@pytest.fixture(scope="module")
def cornell():
    """The JAX Cornell scene (brute-force traces) and the port's copy."""
    scene = j_cornell(emission=18.0)
    # the E_ss LUT's Monte Carlo build takes seconds: its default rows do
    js = scene.flatten(scene.build_materials(with_lut=False))
    ts = convert.scene_arrays_from_numpy(jax_scene_dict(js), device="cpu")
    return (js, JConfig(width=8, height=8, traversal="brute"), ts,
            RenderConfig(width=8, height=8, traversal="brute"))


# ------------------------------- math3d ----------------------------------


MATH3D = {
    # name: (args from the lanes, ulps bar)
    "reflect": (lambda L: (L["v"], L["n"]), 2),
    "coordinate_system": (lambda L: (L["n"],), 2),
    "luminance_avg": (lambda L: (L["kd"][:, :3],), 1),
    "linearize": (lambda L: (L["ks"],), 1),
    "safe_multiply": (lambda L: (np.where(L["rough"] > 0.5, L["rough"],
                                          np.float32(np.inf)), L["ks"]), 1),
    "transform_points": (lambda L: (np.arange(16, dtype=np.float32)
                                    .reshape(4, 4) / 7.0, L["v"]), 2),
    "transform_dirs": (lambda L: (np.arange(16, dtype=np.float32)
                                  .reshape(4, 4) / 7.0, L["v"]), 2),
    "reinhard": (lambda L: (L["ks"] * 4.0,), 1),
}


@pytest.mark.parametrize("name", sorted(MATH3D))
def test_math3d(lanes, name):
    make, bar = MATH3D[name]
    args = make(lanes)
    out_j = getattr(jm3, name)(*[jnp.asarray(a) for a in args])
    out_t = getattr(tm3, name)(*[torch.as_tensor(a) for a in args])
    pairs = zip(out_t, out_j) if isinstance(out_j, tuple) else [(out_t,
                                                                 out_j)]
    for a, b in pairs:
        assert ulps(a, b) <= bar


def test_tea_randoms_bit_exact(lanes):
    uj, sj = jrng.tea_randoms(jnp.asarray(lanes["seed"]), 5)
    ut, st = trng.tea_randoms(tt(lanes["seed"]), 5)
    assert ut.shape == (N, 5)
    same(ut, uj)
    same(st, sj)


# -------------------------------- bsdf ----------------------------------


def bsdf_args(L, names):
    table = dict(normal=L["n"], outgoing=L["v"], incoming=L["incoming"],
                 kd=L["kd"], ks=L["ks"], roughness=L["rough"],
                 metallic=L["metal"], lut_row=L["lut"],
                 strategy=L["strategy"], seed=L["seed"],
                 f0=L["ks"], cos_theta=(L["n"] * L["v"]).sum(-1),
                 ndotv=(L["n"] * L["v"]).sum(-1))
    return [table[k] for k in names]


# name: (argument names, ulps bar at the scale of max(|value|, 1));
# measured: 0-1.5 for the closed forms, 7.3 sample_lambertian, 27 the GGX
# samples, 331-490 the GGX evaluations (below)
GGX_ULPS = 1024
BSDF = {
    "schlick_fresnel": (("f0", "cos_theta"), 2),
    "ess_lookup": (("lut_row", "ndotv"), 2),
    "sample_lambertian": (("normal", "seed"), 16),
    "eval_lambertian": (("kd",), 2),
    "pdf_lambertian": (("normal", "incoming"), 2),
    "sample_ggx": (("roughness", "outgoing", "normal", "seed"), 64),
    "eval_ggx": (("ks", "roughness", "lut_row", "normal", "incoming",
                  "outgoing"), GGX_ULPS),
    "pdf_ggx": (("roughness", "normal", "incoming", "outgoing"), GGX_ULPS),
    "strategy_probs": (("ks", "metallic", "normal", "outgoing"), 4),
    "select_strategy": (("ks", "metallic", "roughness", "normal",
                         "outgoing", "seed"), 4),
    "sample_bsdf": (("strategy", "ks", "roughness", "outgoing", "normal",
                     "seed"), 64),
    "eval_bsdf": (("strategy", "kd", "ks", "roughness", "lut_row", "normal",
                   "incoming", "outgoing"), GGX_ULPS),
    "pdf_bsdf": (("strategy", "roughness", "normal", "incoming",
                  "outgoing"), GGX_ULPS),
    "eval_bsdf_blend": (("kd", "ks", "metallic", "roughness", "lut_row",
                         "normal", "incoming", "outgoing"), GGX_ULPS),
    "pdf_bsdf_blend": (("ks", "metallic", "roughness", "normal", "incoming",
                        "outgoing"), GGX_ULPS),
}


@pytest.mark.parametrize("name", sorted(BSDF))
def test_bsdf_aos(lanes, name):
    """Each AoS BSDF function against JAX's: integer outputs (the
    strategy) and seeds bit-exact, floats within the stated ulps at the
    scale of max(|value|, 1).  GGX's D = a2 / (pi denom^2), denom = 1 -
    ndoth^2 (1 - a2), multiplies the relative error of ndoth (an ulp:
    normalize's rsqrt and sum order differ) by ~4 ndoth^2 / denom, ~260
    at roughness 0.19 and ndoth 0.993, whence GGX_ULPS."""
    names, bar = BSDF[name]
    args = bsdf_args(lanes, names)
    out_j = getattr(jbsdf, name)(*[jnp.asarray(a) for a in args])
    out_t = getattr(tbsdf, name)(*[tt(a) for a in args])
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        b = np.asarray(b)
        if b.dtype.kind == "f":
            assert a.dtype == torch.float32
            assert ulps(a, b) <= bar
        else:
            same(a, b)


# ------------------------------ reservoirs -------------------------------


def _res_fields(rng, keys):
    vals = {k: rng.normal(size=(N, 3)).astype(np.float32) for k in keys}
    for k in ("w_sum", "w", "m"):
        vals[k] = np.where(rng.random(N) < 0.2, 0.0,
                           rng.uniform(0, 2, N)).astype(np.float32)
    vals[keys[1]][rng.random(N) < 0.1] = 0.0          # zero-length normals
    return vals


@pytest.mark.parametrize("kind", ["di", "gi"])
def test_reservoir_update_and_validity(kind):
    rng = np.random.default_rng(11)
    keys = ("x2", "n2", "l2") if kind == "di" else ("xn", "nn", "e3")
    jcls = jres.ReservoirDI if kind == "di" else jres.ReservoirGI
    tcls = tres.ReservoirDI if kind == "di" else tres.ReservoirGI
    vals = _res_fields(rng, keys)
    rj = jcls(**{k: jnp.asarray(v) for k, v in vals.items()})
    rt = tcls(**{k: torch.as_tensor(v) for k, v in vals.items()})
    same(getattr(tres, f"is_valid_{kind}")(rt),
         getattr(jres, f"is_valid_{kind}")(rj))
    accept = rng.random(N) < 0.7
    wi = rng.uniform(0, 1, N).astype(np.float32)
    m_add = np.ones(N, np.float32)
    sample = [rng.normal(size=(N, 3)).astype(np.float32) for _ in range(3)]
    seed = seeds(rng)
    upd_j = getattr(jres, f"update_reservoir_{kind}")
    upd_t = getattr(tres, f"update_reservoir_{kind}")
    out_j, take_j, seed_j = upd_j(rj, jnp.asarray(accept), jnp.asarray(wi),
                                  jnp.asarray(m_add),
                                  *[jnp.asarray(s) for s in sample],
                                  jnp.asarray(seed))
    out_t, take_t, seed_t = upd_t(rt, torch.as_tensor(accept),
                                  torch.as_tensor(wi),
                                  torch.as_tensor(m_add),
                                  *[torch.as_tensor(s) for s in sample],
                                  tt(seed))
    assert isinstance(out_t, tcls)
    same(take_t, take_j)
    same(seed_t, seed_j)
    for f in dataclasses.fields(tcls):
        # selects and one add: bit-equal
        same(getattr(out_t, f.name), getattr(out_j, f.name))
    z_j = jcls.zeros_like_lanes(jnp.asarray(sample[0]))
    z_t = tcls.zeros_like_lanes(torch.as_tensor(sample[0]))
    for f in dataclasses.fields(tcls):
        same(getattr(z_t, f.name), getattr(z_j, f.name))


@pytest.mark.parametrize("kind", ["di", "gi", "sdata"])
def test_reservoir_plane_converters(kind):
    rng = np.random.default_rng(12)
    if kind == "sdata":
        vals = {k: rng.normal(size=(N, 3)).astype(np.float32)
                for k in ("x1", "n1", "o", "l1")}
        vals["mid"] = rng.integers(0, 9, N).astype(np.int32)
        vals["obj"] = rng.integers(0, 3, N).astype(np.int32)
        jcls, tcls = jres.SampleData, tres.SampleData
    else:
        keys = ("x2", "n2", "l2") if kind == "di" else ("xn", "nn", "e3")
        vals = _res_fields(rng, keys)
        jcls = jres.ReservoirDI if kind == "di" else jres.ReservoirGI
        tcls = tres.ReservoirDI if kind == "di" else tres.ReservoirGI
    rj = jcls(**{k: jnp.asarray(v) for k, v in vals.items()})
    rt = tcls(**{k: torch.as_tensor(v) for k, v in vals.items()})
    pj = getattr(jres, f"{kind}_to_planes")(rj)
    pt = getattr(tres, f"{kind}_to_planes")(rt)
    assert sorted(pj) == sorted(pt)
    for k in pj:
        if isinstance(pj[k], tuple):
            for a, b in zip(pt[k], pj[k]):
                same(a, b)
        else:
            same(pt[k], pj[k])
    back = getattr(tres, f"planes_to_{kind}")(pt)
    assert isinstance(back, tcls)
    for f in dataclasses.fields(tcls):
        same(getattr(back, f.name), vals[f.name])


# ------------------------------ light pick -------------------------------


def test_select_light_bit_exact(cornell):
    js, _, ts, _ = cornell
    rng = np.random.default_rng(13)
    cdf = np.asarray(js.lights.cdf)
    u = np.concatenate([rng.uniform(0, 1, N), cdf, np.nextafter(cdf, 0),
                        [0.0, 1.0]]).astype(np.float32)
    same(tls.select_light(ts.lights, torch.as_tensor(u)),
         jls.select_light(js.lights, jnp.asarray(u)))


# --------------------------- ReSTIR, AoS forms ---------------------------


def make_points():
    """Lanes in the Cornell box: two random points inside it, random unit
    normals and view directions, material ids, radiance, seeds, lobes."""
    rng = np.random.default_rng(17)
    x1 = rng.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    x2 = rng.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    n1 = unit(rng)
    n2 = unit(rng)
    o = unit(rng)
    mid = rng.integers(0, 4, N).astype(np.int32)
    return dict(x1=x1, x2=x2, n1=n1, n2=n2, o=o, mid=mid,
                l2=rng.uniform(0, 5, (N, 3)).astype(np.float32),
                seed=seeds(rng), strategy=rng.integers(0, 2, N)
                .astype(np.int32))


@pytest.fixture(scope="module")
def points():
    return make_points()


def _materials(cornell, mid):
    js, _, ts, _ = cornell
    return (jrestir.fetch_material(js, jnp.asarray(mid)),
            trestir.fetch_material(ts, torch.as_tensor(mid)))


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [tt(x) for x in xs]


def assert_tree(port, ref, bar, scale=1.0):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            assert_tree(port[k], ref[k], bar, scale)
        return
    if isinstance(ref, (tuple, list)):
        for a, b in zip(port, ref):
            assert_tree(a, b, bar, scale)
        return
    b = np.asarray(ref)
    if b.dtype.kind == "f":
        assert ulps(port, b, scale) <= bar
    else:
        same(port, b)


def test_mat_index(cornell, points):
    mj, mt = _materials(cornell, points["mid"])
    idx = np.arange(0, N, 3)
    assert_tree(trestir._mat_index(mt, torch.as_tensor(idx)),
                jrestir._mat_index(mj, jnp.asarray(idx)), 0)


def test_visibility_check(cornell, points):
    js, jc, ts, tc = cornell
    p = points
    d = p["x2"] - p["x1"]
    dist = np.linalg.norm(d, axis=1).astype(np.float32)
    dn = (d / dist[:, None]).astype(np.float32)
    vj = jrestir.visibility_check(js, *_j(p["x1"], p["n1"], dn, dist), jc)
    vt = trestir.visibility_check(ts, *_t(p["x1"], p["n1"], dn, dist), tc)
    same(vt, vj)
    assert 0 < float(vt.sum()) < N


@pytest.mark.parametrize("kind", ["di", "gi"])
def test_reconnect(cornell, points, kind):
    """ReconnectDI / GI: 64 ulps (measured 25)."""
    p = points
    mj, mt = _materials(cornell, p["mid"])
    if kind == "di":
        args = (p["x1"], p["n1"], p["x2"], p["n2"], p["l2"], p["o"])
    else:
        args = (p["x1"], p["n1"], p["x2"], p["l2"], p["o"])
    fj = getattr(jrestir, f"reconnect_{kind}")(*_j(*args), mj)
    ft = getattr(trestir, f"reconnect_{kind}")(*_t(*args), mt)
    assert ulps(ft, fj) <= 64


@pytest.mark.parametrize("kind", ["di", "gi"])
@pytest.mark.parametrize("vis", [False, True])
def test_get_p_hat(cornell, points, kind, vis):
    js, jc, ts, tc = cornell
    p = points
    mj, mt = _materials(cornell, p["mid"])
    if kind == "di":
        args = (p["x1"], p["n1"], p["x2"], p["n2"], p["l2"], p["o"])
    else:
        args = (p["x1"], p["n1"], p["x2"], p["l2"], p["o"])
    fj = getattr(jrestir, f"get_p_hat_{kind}")(js, *_j(*args), mj, vis, jc)
    ft = getattr(trestir, f"get_p_hat_{kind}")(ts, *_t(*args), mt, vis, tc)
    assert ulps(ft, fj) <= 64


def test_nee_candidates(cornell, points):
    """SampleLightNEE batch, 4 candidates: the picked lights' emission
    bit-exact, floats within 64 ulps (measured 39, p_hat)."""
    js, _, ts, _ = cornell
    p = points
    mj, mt = _materials(cornell, p["mid"])
    args = (p["x1"], p["n1"], p["o"])
    # jitted: op by op, XLA compiles each of its many small ops first
    oj, sj = jax.jit(lambda *a: jrestir.nee_candidates(js, *a, 4))(
        *_j(*args), mj, jnp.asarray(p["strategy"]), jnp.asarray(p["seed"]))
    ot, st = trestir.nee_candidates(ts, *_t(*args), mt,
                                    tt(p["strategy"]), tt(p["seed"]), 4)
    same(st, sj)
    assert ot["p_hat"].shape == (N, 4)
    same(ot["emission"], oj["emission"])
    assert_tree(ot, oj, 64)


def test_nee_candidates_p(cornell, points):
    js, _, ts, _ = cornell
    p = points
    mj = jrestir.fetch_material_p(js, jnp.asarray(p["mid"]))
    mt = trestir.fetch_material_p(ts, torch.as_tensor(p["mid"]))

    def planes(x, to):
        return tuple(to(x[:, c]) for c in range(3))

    oj, sj = jax.jit(lambda *a: jrestir.nee_candidates_p(js, *a, 4))(
        planes(p["x1"], jnp.asarray), planes(p["n1"], jnp.asarray),
        planes(p["o"], jnp.asarray), mj, jnp.asarray(p["seed"]))
    ot, st = trestir.nee_candidates_p(
        ts, planes(p["x1"], tt), planes(p["n1"], tt), planes(p["o"], tt),
        mt, tt(p["seed"]), 4)
    same(st, sj)
    assert ot["p_hat"].shape == (4, N)
    assert_tree(ot, oj, 64)


def test_bsdf_candidate(cornell, points):
    """SampleLightBSDF: sample, trace (brute force in both packages), MIS
    pdfs.  The emission (a material row) and p_hat's zero lanes exact;
    floats within 128 ulps (measured 84, pdf_bsdf: GGX's pdf, see
    GGX_ULPS; hit positions 11)."""
    js, jc, ts, tc = cornell
    p = points
    mj, mt = _materials(cornell, p["mid"])
    args = (p["x1"], p["n1"], p["o"])
    oj, sj = jrestir.bsdf_candidate(js, *_j(*args), mj,
                                    jnp.asarray(p["strategy"]),
                                    jnp.asarray(p["seed"]), jc)
    ot, st = trestir.bsdf_candidate(ts, *_t(*args), mt, tt(p["strategy"]),
                                    tt(p["seed"]), tc)
    same(st, sj)
    same(ot["emission"], oj["emission"])
    same(ot["p_hat"] > 0, np.asarray(oj["p_hat"]) > 0)
    assert_tree(ot, oj, 128)


def test_spatial_candidate_pixels(points):
    rng = np.random.default_rng(19)
    px = rng.integers(0, 32, N).astype(np.int32)
    py = rng.integers(0, 27, N).astype(np.int32)
    oj = jrestir.spatial_candidate_pixels(jnp.asarray(px), jnp.asarray(py),
                                          32, 27, 20.0, 0.5, 9,
                                          jnp.asarray(points["seed"]))
    ot = trestir.spatial_candidate_pixels(torch.as_tensor(px),
                                          torch.as_tensor(py), 32, 27, 20.0,
                                          0.5, 9, tt(points["seed"]))
    for a, b in zip(ot, oj):
        same(a, b)


REJECT = {
    "reject_normal": lambda p: (p["n1"], p["n2"], np.float32(0.3)),
    "reject_distance": lambda p: (p["x1"], p["x2"],
                                  np.asarray([0.5, 0.5, 1.72], np.float32),
                                  np.float32(0.1)),
    "reject_below_surface": lambda p: (p["o"], p["n1"]),
}


@pytest.mark.parametrize("name", sorted(REJECT))
def test_reject_masks(points, name):
    args = REJECT[name](points)
    mj = getattr(jrestir, name)(*_j(*args))
    mt = getattr(trestir, name)(*_t(*args))
    same(mt, mj)
    assert 0 < int(mt.sum()) < N


def test_jacobian_reconnection(points):
    """Reconnection Jacobian: 64 ulps (measured 32: a ratio of two
    cosines of normalized vectors and two squared lengths)."""
    p = points
    args = (p["x1"], p["x2"], p["l2"], p["n2"])
    assert ulps(trestir.jacobian_reconnection(*_t(*args)),
                jrestir.jacobian_reconnection(*_j(*args))) <= 64


def test_reproject_to_prev_pixel(cornell, points):
    """Pixels bit-exact, through a moved previous camera."""
    from royaltracer_dx_tpu.camera import Camera as JCamera

    js, _, ts, _ = cornell
    cam = JCamera(eye=(0.55, 0.45, 1.7), center=(0.5, 0.5, 0.0))
    mats = cam.matrices(32 / 27)
    view, proj = np.asarray(mats["view"]), np.asarray(mats["proj"])
    obj = np.zeros(N, np.int32)
    oj = jrestir.reproject_to_prev_pixel(js, jnp.asarray(points["x1"]),
                                         jnp.asarray(obj), *_j(view, proj),
                                         32, 27)
    ot = trestir.reproject_to_prev_pixel(ts, tt(points["x1"]),
                                         torch.as_tensor(obj),
                                         *_t(view, proj), 32, 27)
    for a, b in zip(ot, oj):
        same(a, b)
    assert (ot[0] >= 0).any()


# --------------------------- coherence_order -----------------------------


def test_coherence_order_bit_exact():
    rng = np.random.default_rng(23)
    tris = rng.uniform(-1, 1, (3000, 1, 3)) + rng.uniform(-0.1, 0.1,
                                                          (3000, 3, 3))
    tris = tris.astype(np.float32)
    acc_j = jst.build_stream_accel(jnp.asarray(tris))
    acc_t = convert.stream_accel_from_numpy(
        {f.name: np.asarray(getattr(acc_j, f.name))
         for f in dataclasses.fields(tst.StreamAccel)}, device="cpu")
    o = rng.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32)
    d = unit(rng, 4096)
    # duplicates give equal keys: the stable sort's order decides
    o[1::7], d[1::7] = o[0::7][:len(o[1::7])], d[0::7][:len(d[1::7])]
    order_j, inv_j = jst.coherence_order(jnp.asarray(o), jnp.asarray(d),
                                         acc_j)
    for rays in ((tt(o), tt(d)),
                 (tuple(tt(o[:, c]) for c in range(3)),
                  tuple(tt(d[:, c]) for c in range(3)))):
        order_t, inv_t = tst.coherence_order(*rays, acc_t)
        assert order_t.dtype == inv_t.dtype == torch.int32
        same(order_t, order_j)
        same(inv_t, inv_j)
