"""The port's dynamic scenes, checkpoints and frame batching against the
JAX package: the stream accel's refit, ``Scene.flatten(prev=...)`` and
``RestirRenderer.update()`` (with bf16 payload records), a JAX
checkpoint resumed by the port, and ``render_many`` (with f16 payload
records).

Tolerances: the refit's ``perm`` and boxes are bit-equal to JAX
``refit_stream_accel`` on the same triangles; frames use ``image_close``
of tests/test_torch_restir.py (>= 99% of pixels within 1e-3, channel
means within 0.5%), because an ulp of XLA-vs-PyTorch drift can flip an
RIS pick; the port's render_many against its render() is bit-equal.  A reduced RenderConfig (1 GI
bounce, 3 spatial tries, 1 candidate, 1 NEE sample) keeps the JAX
compiles short; the passes' shapes are the same as at the defaults.
"""

import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.camera import Camera as JCamera
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.io import checkpoint as jck
from royaltracer_dx_tpu.ops import stream_trace as jst
from royaltracer_dx_tpu.render import restir_renderer as jr
from royaltracer_dx_tpu.scene import procedural as jproc

from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.io import checkpoint as tck
from royaltracer_dx_tpu_torch.ops import stream_trace as tst
from royaltracer_dx_tpu_torch.render import restir_renderer as tr
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from test_torch_restir import (  # noqa: F401 (one_torch_thread: autouse)
    image_close,
    one_torch_thread,
    with_lut,
)

W, H = 32, 27
EYE, CENTER = (0.5, 0.5, 1.72), (0.5, 0.5, 0.0)
SMALL = dict(width=W, height=H, gi_bounces=1, spatial_max_tries=3,
             spatial_candidate_count=1, nee_samples=1, nee_samples_di=1)
SHRINK = np.diag([0.2, 0.2, 0.2, 1.0]).astype(np.float32)


def two_instances(proc):
    """tests/test_restir.py:136-164: the Cornell mesh again as a second
    instance, shrunk into the box."""
    scene = proc.cornell_box(emission=18.0)
    scene.add_instance(0, SHRINK)
    return scene


def spin(i):
    ang = 0.3 * i
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[c, 0, s, 0.4], [0, 1, 0, 0.4], [-s, 0, c, 0.4],
                     [0, 0, 0, 1]], np.float32) @ SHRINK


def port_renderer(scene, lut, **kw):
    r = tr.RestirRenderer(scene, Camera(eye=EYE, center=CENTER),
                          RenderConfig(**dict(SMALL, **kw)), device="cpu")
    with_lut(r, lut)
    r.materials = r.scene_arrays.materials    # update() keeps the JAX LUT
    return r


def np_state(r) -> dict:
    return {k: np.asarray(v) for k, v in r.state_dict().items()}


# -------------------------------- refit ----------------------------------


@pytest.mark.parametrize("motion", ["translate", "jitter"])
def test_refit_matches_jax(motion):
    v, idx = jproc.random_tris(3000, seed=4)
    t0 = v[idx]
    rng = np.random.default_rng(7)
    if motion == "translate":
        t1 = t0 + np.float32([0.25, -0.5, 0.125])
    else:
        t1 = t0 + rng.normal(0.0, 0.01, t0.shape).astype(np.float32)
    j = jst.refit_stream_accel(jst.build_stream_accel(t0), t1)
    p = tst.refit_stream_accel(tst.build_stream_accel(torch.as_tensor(t0)),
                               torch.as_tensor(t1))
    assert p.num_blocks == j.num_blocks == 2
    for f in ("perm", "blk_tris", "blk_boxes", "top_lo", "top_hi"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_flatten_prev_refits():
    """flatten(prev=...) keeps the build's perm (a refit, not a rebuild)
    and matches the JAX package's flatten(prev=...)."""
    from royaltracer_dx_tpu.scene.scene import Scene as JScene
    from royaltracer_dx_tpu_torch.scene.scene import Scene as TScene

    # 2 x 1500 = 3000 triangles: the JAX build compiled for
    # test_refit_matches_jax is reused
    v, idx = jproc.random_tris(1500, seed=5)
    out = []
    for cls, kw in ((JScene, {}), (TScene, dict(device="cpu"))):
        s = cls()
        m = s.add_mesh(v, idx)
        s.add_instance(m)
        s.add_instance(m, SHRINK)
        first = s.flatten(s.build_materials(with_lut=False, **kw),
                          build_stream=True, **kw)
        s.set_transform(1, spin(2))
        out.append((first, s.flatten(prev=first)))
    (j0, j1), (p0, p1) = out
    np.testing.assert_array_equal(p1.stream.perm.numpy(), p0.stream.perm.numpy())
    np.testing.assert_array_equal(p1.stream.perm.numpy(),
                                  np.asarray(j1.stream.perm))
    np.testing.assert_allclose(p1.tri_verts.numpy(), np.asarray(j1.tri_verts),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p1.stream.blk_boxes.numpy(),
                               np.asarray(j1.stream.blk_boxes),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(p1.prev_object_to_world.numpy(),
                                  np.asarray(j1.prev_object_to_world))


# ------------------------- the animated scenario -------------------------


BF16 = dict(SMALL, record_dtype="bf16")


@pytest.fixture(scope="module")
def animated(tmp_path_factory):
    """The JAX scenario and the port's, frame by frame, with bf16 payload
    records: set_transform + update() + render() three times with a
    static camera.  Then the JAX renderer's checkpoint and its next
    frame."""
    jrr = jr.RestirRenderer(two_instances(jproc), JCamera(eye=EYE,
                            center=CENTER), JConfig(**BF16))
    lut = np.asarray(jrr.scene_arrays.materials.lut)
    scene = two_instances(tproc)
    r = port_renderer(scene, lut, record_dtype="bf16")
    frames = []
    for i in range(3):
        jrr.scene.set_transform(1, spin(i))
        jrr.update()
        jrr.render()
        scene.set_transform(1, spin(i))
        r.update()
        r.render()
        frames.append(dict(jax=np.asarray(jrr.radiance()),
                           port=r.radiance(),
                           jax_count=np.asarray(jrr.fb.count),
                           port_count=r.fb.count.numpy(),
                           jax_m=float(np.asarray(jrr.last_di.m).max()),
                           port_m=float(r.last_di["m"].max())))
    ckpt = str(tmp_path_factory.mktemp("ck") / "jax.npz")
    jck.save_renderer_state(ckpt, jrr)
    jrr.render()
    return dict(frames=frames, lut=lut, ckpt=ckpt, frame=jrr.frame,
                image=np.asarray(jrr.radiance()),
                count=np.asarray(jrr.fb.count))


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_dynamic_scene_animation_matches_jax(animated, frame):
    f = animated["frames"][frame]
    assert np.isfinite(f["port"]).all()
    image_close(f["port"], f["jax"])
    np.testing.assert_array_equal(f["port_count"], f["jax_count"])
    assert f["port_count"].max() == frame + 1   # static camera: no reset
    if frame:
        assert f["port_m"] > 1.0                  # temporal reuse survived


def _resumable(lut):
    """A port renderer over the scenario's scene after its third
    set_transform (current spin(2), previous spin(1))."""
    scene = two_instances(tproc)
    scene.set_transform(1, spin(1))
    scene.set_transform(1, spin(2))
    return port_renderer(scene, lut, record_dtype="bf16")


def test_jax_checkpoint_resumes_in_the_port(animated):
    """The port resumes the JAX renderer's checkpoint (bf16 records,
    after the three animated frames) and its next frame matches the JAX
    next frame."""
    r = _resumable(animated["lut"])
    tck.load_renderer_state(animated["ckpt"], r)
    assert r.frame == 3
    r.render()
    assert r.frame == animated["frame"] == 4
    np.testing.assert_array_equal(r.fb.count.numpy(), animated["count"])
    image_close(r.radiance(), animated["image"])


def test_port_checkpoint_round_trip(animated, tmp_path):
    """The port's npz has the JAX package's keys and dtypes; resuming it
    gives the same next frame bit for bit."""
    a = _resumable(animated["lut"])
    tck.load_renderer_state(animated["ckpt"], a)
    path = str(tmp_path / "port.npz")
    tck.save_renderer_state(path, a)
    with np.load(path) as mine, np.load(animated["ckpt"]) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in theirs.files:
            assert mine[k].dtype == theirs[k].dtype, k
    b = _resumable(animated["lut"])
    tck.load_renderer_state(path, b)
    a.render()
    b.render()
    assert a.frame == b.frame == 4
    np.testing.assert_array_equal(a.radiance(), b.radiance())


def test_update_moves_the_camera():
    scene = two_instances(tproc)
    r = tr.RestirRenderer(scene, Camera(eye=EYE, center=CENTER),
                          RenderConfig(**SMALL), device="cpu")
    r.render()
    r.render()
    assert float(r.fb.count.max()) == 2.0
    r.update(camera=r.camera.orbited(0.05, 0.0))
    r.render()
    assert float(r.fb.count.max()) == 1.0         # camera moved: reset


# ------------------------------ render_many ------------------------------


@pytest.mark.parametrize("record_dtype", ["f32", "f16"])
def test_render_many_equals_render(record_dtype):
    states = []
    for many in (True, False):
        r = tr.RestirRenderer(two_instances(tproc),
                              Camera(eye=EYE, center=CENTER),
                              RenderConfig(**dict(SMALL,
                                                  record_dtype=record_dtype)),
                              device="cpu")
        if many:
            r.render_many(3)
            assert set(r.metrics) == {"frame_time_s", "fps", "frame",
                                      "batch_frames", "batch_time_s"}
            assert r.metrics["batch_frames"] == 3
        else:
            for _ in range(3):
                r.render()
        assert r.frame == 3
        states.append(np_state(r))
    a, b = states
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_render_many_matches_jax_f16():
    """render_many(2) with f16 payload records against the JAX
    render_many(2) (one fori_loop jit)."""
    cfg = dict(SMALL, record_dtype="f16")
    jrr = jr.RestirRenderer(two_instances(jproc), JCamera(eye=EYE,
                            center=CENTER), JConfig(**cfg))
    jrr.render_many(2)
    r = port_renderer(two_instances(tproc),
                      np.asarray(jrr.scene_arrays.materials.lut),
                      record_dtype="f16")
    r.render_many(2)
    assert r.frame == jrr.frame == 2
    assert set(r.metrics) == set(jrr.metrics)
    image_close(r.radiance(), np.asarray(jrr.radiance()))
    np.testing.assert_array_equal(r.fb.count.numpy(), np.asarray(jrr.fb.count))


def test_render_many_needs_frame_seeds():
    r = tr.RestirRenderer(tproc.cornell_box(), Camera(eye=EYE, center=CENTER),
                          RenderConfig(**dict(SMALL, seed_mode="time")),
                          device="cpu")
    with pytest.raises(ValueError, match="seed_mode"):
        r.render_many(2)
