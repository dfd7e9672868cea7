"""The port's megakernel path tracer (render/megakernel.py) and its
progressive ``Renderer`` (render/renderer.py) against the JAX package.

Tolerances: on random lane states, every integer and decision leaf (seeds,
alive, hit-derived masks) equal and every float within 1e-5 absolute +
1e-4 relative, on at least 99.9% of the lanes: an ulp of XLA-vs-PyTorch
drift in the RIS ``cumsum``, in ``rsqrt`` or in the russian-roulette test
``u_rr > q`` can flip one lane's decision.  ``bounce_step`` and
``trace_paths`` are held against the JAX functions run op by op
(``jax.disable_jit``): jitted, XLA fuses the bounce and rounds
differently, which flips the visibility of grazing shadow rays (points on
the Cornell ceiling toward the light 1e-3 below it) on ~0.2% of the
lanes, against 0-0.03% op by op.  Frames: ``image_close`` of
tests/test_torch_restir.py (>= 99% of pixels within 1e-3, channel means
within 0.5%).  The port's ``render_many(k)`` against k ``render()`` calls
is bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from royaltracer_dx_tpu import cli as jcli
from royaltracer_dx_tpu.camera import Camera as JCamera
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.render import megakernel as jmk
from royaltracer_dx_tpu.render.renderer import Renderer as JRenderer
from royaltracer_dx_tpu.scene import procedural as jproc

from royaltracer_dx_tpu_torch import convert
from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import intersect as tit
from royaltracer_dx_tpu_torch.ops import stream_trace as tst
from royaltracer_dx_tpu_torch.render import megakernel as tmk
from royaltracer_dx_tpu_torch.render.renderer import Renderer
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from test_torch_restir import (  # noqa: F401 (one_torch_thread: autouse)
    MIN_LANES,
    assert_lanes,
    image_close,
    jax_scene_dict,
    leaves,
    one_torch_thread,
    to_t,
    with_lut,
)

W, H = 32, 27
EYE, CENTER = (0.5, 0.5, 1.72), (0.5, 0.5, 0.0)
ATOL, RTOL = 1e-5, 1e-4
LANES = 4096
CFG = dict(width=W, height=H, max_bounces=5)


def assert_lanes_close(port, ref, skip=()):
    assert_lanes(port, ref, skip, rtol=RTOL, atol=ATOL)


# ------------------------------ fixtures ---------------------------------


@pytest.fixture(scope="module")
def glossy():
    """The Cornell box with its white walls made glossy (rough 0.3,
    metal 0.3) and its red walls near-mirror (rough 0.02), so that both
    BSDF strategies run: (JAX SceneArrays, port SceneArrays on the CPU,
    JAX config)."""
    js = jproc.cornell_box(emission=18.0)
    jsa = js.flatten(js.build_materials())
    m = jsa.materials
    ks = np.asarray(m.ks).copy()
    pr = np.asarray(m.pr_pm_ps_pc).copy()
    ks[0] = 0.6
    pr[0, :2] = (0.3, 0.3)
    ks[1] = 0.4
    pr[1, :2] = (0.02, 0.0)
    jsa = jsa.replace(materials=m.replace(ks=jnp.asarray(ks),
                                          pr_pm_ps_pc=jnp.asarray(pr)))
    tsa = convert.scene_arrays_from_numpy(jax_scene_dict(jsa), device="cpu")
    return jsa, tsa, JConfig(**CFG)


def in_the_air(n, rng):
    """n points inside the Cornell box and outside its two inner boxes (a
    shadow ray from inside a box leaves only through the seams of its
    faces, where an ulp of drift decides)."""
    p = rng.uniform(0.05, 0.95, (4 * n, 3)).astype(np.float32)
    inside = np.zeros(len(p), bool)
    for lo, hi in (((0.10, 0.0, 0.12), (0.45, 0.60, 0.45)),
                   ((0.55, 0.0, 0.50), (0.85, 0.30, 0.80))):
        inside |= ((p > np.asarray(lo) - 0.01)
                   & (p < np.asarray(hi) + 0.01)).all(axis=1)
    return p[~inside][:n]


def random_state(n=LANES, seed=0) -> dict:
    """A lane state in the air of the Cornell box (rays through its open
    front miss); 10% of the lanes dead."""
    rng = np.random.default_rng(seed)

    def unit(k):
        v = rng.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)

    return dict(
        origin=in_the_air(n, rng),
        direction=unit(n),
        throughput=rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32),
        pdf_prev=rng.uniform(0.1, 5.0, n).astype(np.float32),
        seed=rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(
            np.uint32),
        emission=rng.uniform(0.0, 0.5, (n, 3)).astype(np.float32),
        alive=rng.uniform(size=n) < 0.9,
        prev_normal=unit(n),
        rays=np.float32(0.0),
    )


# ----------------------------- one bounce ---------------------------------


def test_fetch_material_matches(glossy):
    jsa, tsa, _ = glossy
    mid = np.random.default_rng(1).integers(0, 4, 512).astype(np.int32)
    ref = jmk._fetch_material(jsa, jnp.asarray(mid))
    out = tmk._fetch_material(tsa, torch.as_tensor(mid))
    for k, v in leaves(ref).items():
        np.testing.assert_array_equal(leaves(out)[k], v)


def test_ris_nee_matches(glossy):
    """RIS over 10 NEE candidates + one shadow ray on random shading
    points, normals, directions, strategies and seeds."""
    jsa, tsa, jcfg = glossy
    rng = np.random.default_rng(2)
    n = LANES

    def unit():
        v = rng.normal(size=(3, n))
        return tuple((v / np.linalg.norm(v, axis=0)).astype(np.float32))

    mid = rng.integers(0, 3, n).astype(np.int32)
    pos = tuple(in_the_air(n, rng).T.copy())
    normal, flat, outgoing = unit(), unit(), unit()
    strategy = rng.integers(0, 2, n).astype(np.int32)
    seed = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    args = (pos, normal, flat, outgoing, strategy, seed)

    def jfn(sa, mid, pos, normal, flat, outgoing, strategy, seed):
        mat = jmk._fetch_material(sa, mid)
        return jmk._ris_nee(sa, mat, pos, normal, flat, outgoing, strategy,
                            seed, jcfg.ris_m, jcfg)

    ref = jax.jit(jfn)(jsa, jnp.asarray(mid),
                       *jax.tree.map(jnp.asarray, args))
    targs = to_t(args)
    mat = tmk._fetch_material(tsa, torch.as_tensor(mid))
    out = tmk._ris_nee(tsa, mat, *targs[:4], targs[4], targs[5],
                       jcfg.ris_m, RenderConfig(**CFG))
    assert_lanes_close(out, ref)
    direct = np.stack([np.asarray(c) for c in ref[0]])
    assert (direct > 0).any(axis=0).mean() > 0.3      # light got through


@pytest.mark.parametrize("bounce", [0, 1, 4], ids=["b0", "b1", "b4-rr"])
def test_bounce_step_matches(glossy, bounce):
    """bounce_step on a random lane state: bounce 0 (MIS weight 1),
    bounce 1 and bounce 4 (russian roulette past rr_threshold=3)."""
    jsa, tsa, jcfg = glossy
    st = random_state(seed=10 + bounce)
    with jax.disable_jit():
        ref = jmk.bounce_step(jsa, {k: jnp.asarray(v) for k, v in st.items()},
                              jnp.uint32(bounce), jcfg)
    out = tmk.bounce_step(tsa, to_t(st), bounce, RenderConfig(**CFG))
    assert_lanes_close(out, ref, skip=("rays",))
    assert float(out["rays"]) == float(ref["rays"])
    alive = np.asarray(ref["alive"])
    assert 0.2 < alive.mean() < 0.9             # some shaded, some not
    if bounce == 4:
        # russian roulette killed some shaded lanes in both packages
        jshade = np.asarray(ref["pdf_prev"]) != st["pdf_prev"]
        assert (jshade & ~alive).any()


def test_trace_paths_matches(glossy):
    """All bounces in one call: the radiance and the ray count."""
    jsa, tsa, _ = glossy
    st = random_state(seed=20)
    o, d, s = st["origin"], st["direction"], st["seed"]
    kw = dict(CFG, max_bounces=2)
    with jax.disable_jit():
        ref_rad, ref_rays = jmk.trace_paths_impl(
            jsa, jnp.asarray(o), jnp.asarray(d), jnp.asarray(s),
            JConfig(**kw))
    rad, rays = tmk.trace_paths(tsa, torch.as_tensor(o), torch.as_tensor(d),
                                to_t(s), RenderConfig(**kw))
    assert float(rays) == float(ref_rays)
    close = np.isclose(rad.numpy(), np.asarray(ref_rad), rtol=RTOL,
                       atol=ATOL).all(axis=1)
    assert close.mean() >= MIN_LANES


# ------------------------------- frames ----------------------------------


@pytest.fixture(scope="module")
def jax_cornell():
    r = JRenderer(jproc.cornell_box(emission=18.0),
                  JCamera(eye=EYE, center=CENTER), JConfig(**CFG))
    r.render()
    r.render()
    return r


def _port(scene, camera, lut, **kw):
    r = Renderer(scene, camera, RenderConfig(**dict(CFG, **kw)),
                 device="cpu")
    with_lut(r, lut)
    return r


def test_cornell_frames_match(jax_cornell):
    r = _port(tproc.cornell_box(emission=18.0),
              Camera(eye=EYE, center=CENTER),
              np.asarray(jax_cornell.scene_arrays.materials.lut))
    assert r.scene_arrays.stream is None       # 36 tris: brute on the CPU
    r.render()
    r.render()
    image_close(r.radiance(), np.asarray(jax_cornell.radiance()))
    assert (r.fb.count == 2).all() and r.frame == 2
    assert r.metrics["rays_traced"] == jax_cornell.metrics["rays_traced"]
    np.testing.assert_allclose(r.image(), np.asarray(jax_cornell.image()),
                               atol=2e-3)


def test_stream_scene_frames_match():
    """The menger scene (4,802 triangles) with traversal="stream": every
    trace of the port's bounces runs the stream kernels' plain version,
    dead and missed lanes included."""
    kw = dict(max_bounces=3, traversal="stream")
    js, jc = jcli.build_scene("menger")
    jrr = JRenderer(js, jc, JConfig(**dict(CFG, **kw)))
    jrr.render()
    jrr.render()
    launches = dict(tst.LAUNCHES)
    r = _port(*tproc.menger_scene(),
              np.asarray(jrr.scene_arrays.materials.lut), **kw)
    assert r.scene_arrays.num_triangles >= 1500
    assert r.scene_arrays.stream is not None
    r.render()
    r.render()
    assert tst.LAUNCHES == launches            # CPU tensors launch nothing
    image_close(r.radiance(), np.asarray(jrr.radiance()))
    assert r.metrics["rays_traced"] == jrr.metrics["rays_traced"]


def _pallas_worklists(origins, dirs, t_min, t_max, accel, wb):
    """Chunk worklists bounded over every lane, as the JAX package's
    Pallas path builds them (stream_trace.py:482-504)."""
    chunks = origins.shape[0] // tst.RAYS_PER_CHUNK
    o = origins.reshape(chunks, tst.RAYS_PER_CHUNK, 3)
    d = dirs.reshape(chunks, tst.RAYS_PER_CHUNK, 3)
    ok, entry = tst._interval_slab(
        torch.amin(o, 1), torch.amax(o, 1), torch.amin(d, 1),
        torch.amax(d, 1), accel.top_lo, accel.top_hi,
        torch.amin(t_min.reshape(chunks, -1), 1),
        torch.amax(t_max.reshape(chunks, -1), 1))
    skey, sbid = torch.sort(torch.where(ok, entry, tit.INF), dim=1,
                            stable=True)
    return (sbid[:, :wb].to(torch.int32).contiguous(),
            skey[:, :wb].contiguous(),
            torch.clamp_max(ok.sum(1), wb).to(torch.int32))


def test_missed_lanes_leave_chunk_bounds(monkeypatch):
    """A lane whose ray missed casts its shadow ray from ~1e30 with t_min
    NaN (megakernel.py:181).  Bounded over every lane, as the Pallas path
    bounds them, such a chunk's t_min bound is NaN and its worklist empty,
    so its live lanes read unoccluded; bounded over the lanes with t_max >
    t_min (the port's ``_build_worklists``), every lane equals brute
    force.  On the menger scene with traversal="stream"."""
    calls = []
    real = tst.any_hit_stream

    def spy(o, d, accel, t_min, t_max, wb=64):
        out = real(o, d, accel, t_min, t_max, wb=wb)
        calls.append((o, d, accel, t_min, t_max, wb, out))
        return out

    # the dispatch reaches it through stream_trace.any_hit_stream_xla
    monkeypatch.setattr(tst, "any_hit_stream", spy)
    r = Renderer(*tproc.menger_scene(),
                 RenderConfig(**dict(CFG, max_bounces=2, traversal="stream")),
                 device="cpu")
    r.render()
    assert calls
    o, d, accel, t_min, t_max, wb, occ = calls[-1]
    assert torch.isnan(t_min).any()            # missed lanes are present
    op, dp = (torch.stack(v, 1) for v in (o, d))
    brute = tit.any_hit_brute(op, dp, r.scene_arrays.tri_verts, t_min,
                              t_max)
    assert torch.equal(occ, brute) and bool(brute.any())
    rows, _, _, cnt = tst.prepare_stream(o, d, accel, t_min, t_max, wb)
    wl_p, went_p, cnt_p = _pallas_worklists(
        rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7], accel,
        max(wb, accel.num_blocks))
    # every chunk with an occluded lane walks; under the Pallas bounds
    # some of them have an empty worklist
    chunks = cnt.shape[0]
    n = brute.shape[0]
    blocked = torch.nn.functional.pad(brute, (0, rows.shape[0] - n)).reshape(
        chunks, -1).any(dim=1)
    assert bool((cnt[blocked] > 0).all())
    assert bool((cnt_p[blocked] == 0).any())
    _, slot_p, _ = tst.stream_any(rows, wl_p, went_p, cnt_p,
                                  accel.blk_tris, accel.blk_boxes)
    occ_p = (slot_p[:n] >= 0) & (rows[:n, 7] > rows[:n, 6])
    assert int((brute & ~occ_p).sum()) > 0


# ----------------------- render_many, camera, options --------------------


def test_render_many_equals_render():
    """render_many(3) and then render_many(1) against 4 render() calls,
    bit for bit (tests/test_restir.py:408-416 for the port)."""
    cfg = RenderConfig(width=16, height=16, max_bounces=3, aa_jitter=False)
    cam = Camera(eye=EYE, center=CENTER)
    a = Renderer(tproc.cornell_box(emission=18.0), cam, cfg, device="cpu")
    b = Renderer(tproc.cornell_box(emission=18.0), cam, cfg, device="cpu")
    for _ in range(4):
        a.render()
    b.render_many(3)
    assert b.metrics["batch_frames"] == 3 and b.frame == 3
    assert set(b.metrics) == {"frame_time_s", "fps", "frame",
                              "batch_frames", "batch_time_s"}
    b.render_many(1)
    np.testing.assert_array_equal(a.radiance(), b.radiance())
    assert torch.equal(a.fb.count, b.fb.count) and a.frame == b.frame == 4
    for k, v in a.state_dict().items():
        np.testing.assert_array_equal(b.state_dict()[k], v)


def test_camera_move_resets_accumulation():
    """tests/test_megakernel.py:73-80 for the port."""
    cam = Camera(eye=EYE, center=CENTER)
    r = Renderer(tproc.cornell_box(), cam,
                 RenderConfig(width=16, height=12, max_bounces=2),
                 device="cpu")
    r.render()
    r.render()
    assert float(r.fb.count.max()) == 2.0
    r.update(camera=cam.orbited(0.02, 0.0))
    r.render()
    assert float(r.fb.count.max()) == 1.0 and r.frame == 3
    r.render()
    assert float(r.fb.count.min()) == 2.0


@pytest.mark.parametrize("traversal", ["cluster"])
def test_unported_traversal_raises(traversal):
    """The cluster traversal refused until it was ported; now the
    megakernel renders through it."""
    r = Renderer(tproc.cornell_box(emission=18.0),
                 Camera(eye=EYE, center=CENTER),
                 RenderConfig(width=8, height=8, traversal=traversal),
                 device="cpu")
    assert r.scene_arrays.clusters is not None
    r.render()
    img = r.radiance()
    assert np.isfinite(img).all() and img.mean() > 0.0


def test_renderer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="GPU"):
        Renderer(tproc.cornell_box(), Camera(eye=EYE, center=CENTER),
                 RenderConfig(width=8, height=8))
