"""The port's configuration and scene build against the JAX package.

RenderConfig fields and defaults are identical.  ``Scene.flatten`` and
the [T, 20] triangle table are exact (the bake multiplies by an identity
or an axis-permuting transform here, so no rounding can differ); the
light CDF is numpy in both packages and held within 1e-6.  The E_ss LUT
draws other Monte Carlo samples (threefry vs a torch.Generator), so it is
held to the JAX LUT within Monte Carlo error: both are means of 16000
samples of a quantity in [0, 1.6], whose standard error is <= 0.013, so
two independent estimates stay within 0.05 (about 4 standard errors of
their difference).
"""

import dataclasses

import numpy as np
import pytest
import torch

from royaltracer_dx_tpu import config as jconfig
from royaltracer_dx_tpu.scene import lut as jlut
from royaltracer_dx_tpu.scene import procedural as jproc
from royaltracer_dx_tpu.scene.scene import Scene as JScene

from royaltracer_dx_tpu_torch import config as tconfig
from royaltracer_dx_tpu_torch.scene import lut as tlut
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from royaltracer_dx_tpu_torch.scene.scene import Scene as TScene


def test_render_config_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.RenderConfig)]
    assert tf == jf
    for name in ("REF_PI", "S_BIAS", "EPSILON", "STREAM_AUTO_MIN_TRIS",
                 "LUT_SIZE_THETA", "MISS_MATERIAL_ID"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    cfg = tconfig.RenderConfig(use_bvh=True)
    assert cfg.accel == "bvh" and cfg.num_pixels == 1920 * 1080


def _two_instance(scene_cls, proc):
    """menger_sponge(1) twice: identity, and an axis permutation with a
    translation (exact in float32), plus a light."""
    s = scene_cls()
    v, idx = proc.menger_sponge(1)
    white = s.add_material(kd=(0.7, 0.7, 0.7, 1.0), ks=(0, 0, 0))
    light = s.add_material(ke=(20.0, 20.0, 20.0))
    mesh = s.add_mesh(v, idx, tri_material=np.full(len(idx), white, np.int32))
    s.add_instance(mesh)
    m = np.zeros((4, 4), np.float32)
    m[0, 2] = m[1, 0] = m[2, 1] = m[3, 3] = 1.0
    m[:3, 3] = (2.0, 0.5, -1.0)
    s.add_instance(mesh, m)
    lv = np.array([[0.2, 1.4, 0.2], [0.8, 1.4, 0.2], [0.8, 1.4, 0.8],
                   [0.2, 1.4, 0.8]], np.float32)
    lm = s.add_mesh(lv, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
                    tri_material=np.asarray([light, light], np.int32))
    s.add_instance(lm)
    return s


@pytest.mark.parametrize("which", ["cornell", "menger", "instanced"])
def test_flatten_exact(which):
    if which == "cornell":
        js, ts = jproc.cornell_box(emission=18.0), tproc.cornell_box(
            emission=18.0)
    elif which == "menger":
        js, ts = _menger_jax(), tproc.menger_scene()[0]
    else:
        js, ts = _two_instance(JScene, jproc), _two_instance(TScene, tproc)
    jm = js.build_materials(with_lut=False)
    tm = ts.build_materials(with_lut=False, device="cpu")
    ja = js.flatten(jm)
    ta = ts.flatten(tm, device="cpu")
    for f in ("tri_verts", "tri_normals", "tri_material", "tri_instance",
              "tri_table", "object_to_world", "prev_object_to_world"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    for f in ("kd", "ks", "ni", "ke", "pr_pm_ps_pc", "lut"):
        np.testing.assert_array_equal(getattr(ta.materials, f).numpy(),
                                      np.asarray(getattr(ja.materials, f)))
    jl, tl = ja.lights, ta.lights
    np.testing.assert_array_equal(tl.verts.numpy(), np.asarray(jl.verts))
    np.testing.assert_array_equal(tl.instance.numpy(), np.asarray(jl.instance))
    np.testing.assert_array_equal(tl.emission.numpy(), np.asarray(jl.emission))
    for f in ("weight", "cdf", "total_weight"):
        np.testing.assert_allclose(getattr(tl, f).numpy(),
                                   np.asarray(getattr(jl, f)), rtol=1e-6)
    assert float(tl.cdf[-1]) == 1.0


def _menger_jax():
    """The JAX CLI's --scene menger (cli.py:86-98)."""
    s = JScene()
    v, idx = jproc.menger_sponge(2)
    white = s.add_material(kd=(0.7, 0.7, 0.7, 1.0), ks=(0, 0, 0))
    light = s.add_material(ke=(20.0, 20.0, 20.0))
    mesh = s.add_mesh(v, idx, tri_material=np.full(len(idx), white, np.int32))
    s.add_instance(mesh)
    lv = np.array([[0.2, 1.4, 0.2], [0.8, 1.4, 0.2], [0.8, 1.4, 0.8],
                   [0.2, 1.4, 0.8]], np.float32)
    lm = s.add_mesh(lv, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
                    tri_material=np.asarray([light, light], np.int32))
    s.add_instance(lm)
    return s


def test_menger_scene_is_the_reference_size():
    s, cam = tproc.menger_scene()
    assert s.num_triangles == 4800 + 2
    assert cam.eye == (2.2, 1.6, 2.2)


def test_lut_within_monte_carlo_error():
    rough = np.asarray([0.05, 0.3, 0.6, 1.0], np.float32)
    j = np.asarray(jlut.compute_ess_lut(rough))
    t = tlut.compute_ess_lut(rough).numpy()
    assert t.shape == j.shape == (4, 16)
    assert np.abs(t - j).max() < 0.05
    assert ((t > 0) & (t <= 1)).all()
    # reproducible: the same generator seed gives the same LUT
    g = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(tlut.compute_ess_lut(rough, g).numpy(), t)
