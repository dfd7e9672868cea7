"""GI wavefront compaction in the port: the compacted bounce against the
uncompacted one, and the port's compacted frames on the 8-block
heightfield(66) scene against the JAX package's.

Tolerances: the port against itself is bit-equal (every state leaf, the
seeds included, travels with its lane, as in tests/test_restir.py:183-
204); against JAX, ``image_close`` of tests/test_torch_restir.py (>= 99%
of pixels within 1e-3, channel means within 0.5%).
"""

import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.camera import Camera as JCamera
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.ops import restir as jrestir
from royaltracer_dx_tpu.render import restir_renderer as jr
from royaltracer_dx_tpu.scene import procedural as jproc
from royaltracer_dx_tpu.scene.scene import Scene as JScene

from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import restir as trestir
from royaltracer_dx_tpu_torch.render import restir_renderer as tr
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from royaltracer_dx_tpu_torch.scene.scene import Scene as TScene
from test_torch_restir import (  # noqa: F401 (one_torch_thread: autouse)
    image_close,
    one_torch_thread,
    with_lut,
)

EYE, CENTER = (0.5, 0.5, 1.72), (0.5, 0.5, 0.0)
SMALL = dict(width=32, height=27, gi_bounces=1, spatial_max_tries=3,
             spatial_candidate_count=1, nee_samples=1, nee_samples_di=1)


def np_state(r) -> dict:
    return {k: np.asarray(v) for k, v in r.state_dict().items()}


def terrain(proc, cls):
    """heightfield(66) (8,450 triangles, 8 blocks = 256 clusters: the
    windowed scale where "auto" compaction engages) under a square light
    outside the camera's view: a pixel on the light's edge, where an ulp
    decides the hit, would move the image mean by 2%."""
    v, idx = proc.heightfield(66)
    s = cls()
    grey = s.add_material(kd=(0.6, 0.6, 0.6, 1.0))
    light = s.add_material(ke=(40.0, 40.0, 40.0))
    s.add_instance(s.add_mesh(v, idx, tri_material=np.full(len(idx), grey,
                                                           np.int32)))
    lv = np.array([[-1.0, 4.0, -1.0], [1.0, 4.0, -1.0], [1.0, 4.0, 1.0],
                   [-1.0, 4.0, 1.0]], np.float32)
    s.add_instance(s.add_mesh(lv, np.array([[0, 2, 1], [0, 3, 2]], np.int32),
                              tri_material=np.array([light, light],
                                                    np.int32)))
    return s


TERRAIN_CAM = dict(eye=(2.5, 2.2, 2.5), center=(0.0, 0.0, 0.0))


def test_terrain_compacted_frames_match_jax():
    jrr = jr.RestirRenderer(terrain(jproc, JScene), JCamera(**TERRAIN_CAM),
                            JConfig(**SMALL))
    assert jrestir.wants_gi_compaction(jrr.scene_arrays, jrr.cfg)
    for _ in range(2):
        jrr.render()
    lut = np.asarray(jrr.scene_arrays.materials.lut)
    states = []
    for mode in ("auto", "off"):
        r = tr.RestirRenderer(terrain(tproc, TScene), Camera(**TERRAIN_CAM),
                              RenderConfig(**dict(SMALL, gi_compaction=mode)),
                              device="cpu")
        with_lut(r, lut)
        assert r.scene_arrays.stream.num_blocks == 8
        assert trestir.wants_gi_compaction(r.scene_arrays, r.cfg) == (
            mode == "auto")
        for _ in range(2):
            r.render()
        if mode == "auto":
            assert r.radiance().mean() > 0.05
            image_close(r.radiance(), np.asarray(jrr.radiance()))
        states.append(np_state(r))
    for k in states[0]:
        np.testing.assert_array_equal(states[0][k], states[1][k], err_msg=k)


@pytest.mark.parametrize("record_dtype", ["f32", "bf16"])
def test_gi_compaction_bit_identical(record_dtype):
    """Compacted GI bounces (active lanes stably partitioned to the
    front, the bounce on a half-width prefix) give the uncompacted frames
    bit for bit."""
    out = []
    for mode in ("on", "off"):
        r = tr.RestirRenderer(
            tproc.cornell_box(emission=18.0), Camera(eye=EYE, center=CENTER),
            RenderConfig(width=24, height=24, gi_compaction=mode,
                         record_dtype=record_dtype), device="cpu")
        for _ in range(3):
            r.render()
        out.append(np_state(r))
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=k)


def test_compaction_bounce_equals_bounce():
    """One compacted bounce against gi_bounce on the same state, at half
    and at full width (the host read picks the branch).  Lanes inactive
    on entry keep their seed in the compacted tail, where gi_bounce
    advances it; nothing reads an inactive lane's seed again."""
    r = tr.RestirRenderer(tproc.cornell_box(emission=18.0),
                          Camera(eye=EYE, center=CENTER),
                          RenderConfig(width=24, height=24), device="cpu")
    cam = r._camera_arrays()
    cam.update(prev_view=r._prev_view, prev_proj=r._prev_proj)
    _, _, gi_in, seed = tr.pass1_di(r.scene_arrays, cam, 0, r.cfg)
    st = tr.pass1_gi_init(r.scene_arrays, gi_in, seed, r.cfg)
    n = st["active"].shape[0]
    for keep in (n // 4, n):          # at most half active, then all
        st2 = dict(st, active=st["active"] & (torch.arange(n) < keep))
        a = tr.pass1_gi_bounce_compact(r.scene_arrays, r.cfg, st2, 0)
        b = tr.pass1_gi_bounce(r.scene_arrays, r.cfg, st2, 0)
        live = st2["active"]
        for (ka, va), (kb, vb) in zip(_flat(a), _flat(b)):
            assert ka == kb
            if ka == "seed":
                va, vb = va[live], vb[live]
            np.testing.assert_array_equal(va.numpy(), vb.numpy(), err_msg=ka)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree
