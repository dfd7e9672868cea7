"""The port's MIS-free DI oracle (render/di_oracle.py) against the JAX
package's, and its frame batching.

Tolerances: the oracle's primary geometry is the port's own ``pass1_di``
(held against JAX by tests/test_torch_restir.py), so frames use
``image_close`` of tests/test_torch_restir.py (>= 99% of pixels within
1e-3, channel means within 0.5%).  ``render_many(k)`` sums its k frames
in float32 before the float64 total, so against k ``render()`` calls it
is within 1e-5 (tests/test_restir.py:406); ``render_many(1)`` is
bit-equal to ``render()``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.camera import Camera as JCamera
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.render.di_oracle import DiOracle as JDiOracle
from royaltracer_dx_tpu.scene import procedural as jproc

from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.render.di_oracle import DiOracle
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from royaltracer_dx_tpu_torch.scene.scene import Scene
from test_torch_restir import (  # noqa: F401 (one_torch_thread: autouse)
    image_close,
    one_torch_thread,
)

W, H = 32, 27
EYE, CENTER = (0.5, 0.5, 1.72), (0.5, 0.5, 0.0)


@pytest.fixture
def jax_lut(monkeypatch):
    """Make the port's Scene.build_materials carry a given E_ss LUT (the
    port's own LUT draws other Monte Carlo samples than JAX's)."""
    real = Scene.build_materials

    def use(lut):
        def build(self, with_lut=True, device=None):
            m = real(self, with_lut=False, device=device)
            return dataclasses.replace(
                m, lut=torch.as_tensor(np.asarray(lut), device=m.kd.device))

        monkeypatch.setattr(Scene, "build_materials", build)

    return use


def test_di_oracle_frames_match(jax_lut):
    jo = JDiOracle(jproc.cornell_box(emission=18.0),
                   JCamera(eye=EYE, center=CENTER),
                   JConfig(width=W, height=H))
    jo.render()
    jo.render()
    jax_lut(jo.scene_arrays.materials.lut)
    o = DiOracle(tproc.cornell_box(emission=18.0),
                 Camera(eye=EYE, center=CENTER),
                 RenderConfig(width=W, height=H), device="cpu")
    o.render()
    o.render()
    assert o.frame == 2 and o._acc.dtype == torch.float64
    img = o.radiance()
    assert img.dtype == np.float32 and np.isfinite(img).all()
    image_close(img, np.asarray(jo.radiance()))


def test_di_oracle_stream_scene_matches(jax_lut):
    """The menger scene (4,802 triangles) with traversal="stream": the
    primary trace and the shadow rays through the stream kernels' plain
    version, against the JAX oracle's brute force (which it takes at the
    default traversal: it flattens without the stream accel, and fails
    under traversal="stream").  33 pixels wide: at 32 the camera's pixel
    corners fall on cube edges, where brute force and the stream walk take
    the two triangles of an exact-t tie."""
    from royaltracer_dx_tpu import cli as jcli

    js, jc = jcli.build_scene("menger")
    jo = JDiOracle(js, jc, JConfig(width=W + 1, height=H))
    jo.render()
    jo.render()
    jax_lut(jo.scene_arrays.materials.lut)
    o = DiOracle(*tproc.menger_scene(),
                 RenderConfig(width=W + 1, height=H, traversal="stream"),
                 device="cpu")
    assert o.scene_arrays.num_triangles >= 1500
    assert o.scene_arrays.stream is not None
    o.render()
    o.render()
    image_close(o.radiance(), np.asarray(jo.radiance()))


def test_di_oracle_render_many():
    cfg = RenderConfig(width=16, height=16, aa_jitter=False)
    cam = Camera(eye=EYE, center=CENTER)
    a = DiOracle(tproc.cornell_box(emission=18.0), cam, cfg, device="cpu")
    b = DiOracle(tproc.cornell_box(emission=18.0), cam, cfg, device="cpu")
    c = DiOracle(tproc.cornell_box(emission=18.0), cam, cfg, device="cpu")
    for _ in range(5):
        a.render()
        c.render_many(1)
    b.render_many(5)
    assert a.frame == b.frame == c.frame == 5
    np.testing.assert_allclose(b.radiance(), a.radiance(), atol=1e-5)
    assert torch.equal(a._acc, c._acc)
    assert not np.array_equal(a.radiance(), np.zeros_like(a.radiance()))


def test_di_oracle_options():
    """traversal="cluster" refused until it was ported; now the oracle
    renders through it.  Without a card the default device
    raises."""
    cam = Camera(eye=EYE, center=CENTER)
    o = DiOracle(tproc.cornell_box(emission=18.0), cam,
                 RenderConfig(width=8, height=8, traversal="cluster"),
                 device="cpu")
    assert o.scene_arrays.clusters is not None
    o.render()
    img = o.radiance()
    assert np.isfinite(img).all() and img.mean() > 0.0
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="GPU"):
        DiOracle(tproc.cornell_box(), cam, RenderConfig(width=8, height=8))
