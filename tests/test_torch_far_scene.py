"""Pass 3's accept tables beyond float16's range.

The JAX package casts pass 3's accept rows (the DI row, the GI S0/S1
table) to float16; a world coordinate beyond 65504 becomes inf there,
silently: the GI chain then accepts no tap, and the DI chain's rejection
tests pass on the inf rows.  The port keeps float16 while
every world coordinate fits it (so its accept masks equal the JAX
package's) and reads the tables as float32 beyond; f16 records, whose
positions overflow as well, raise.

The input: the Cornell box scaled by 1000 and moved to x = +70,000, the
camera moved alike, 3 frames at 32x27 through RestirRenderer and at
32x26 through two bands of ShardedRestirRenderer, on the CPU, held
against the same box at the origin.  The accepted taps are counted by
wrapping ``_claim_first_k``, which every try of both candidate chains
passes through.
"""

import numpy as np
import pytest
import torch

from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.parallel.shard import ShardedRestirRenderer
from royaltracer_dx_tpu_torch.render import restir_renderer as rr
from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
from royaltracer_dx_tpu_torch.scene.procedural import cornell_box
from test_torch_restir import one_torch_thread  # noqa: F401 (autouse)

SCALE = 1000.0


def _box(shift):
    """The Cornell box scaled by SCALE and moved to x = shift, and the
    CLI's Cornell camera moved alike."""
    s = cornell_box(emission=18.0)
    m = np.diag([SCALE, SCALE, SCALE, 1.0]).astype(np.float32)
    m[0, 3] = shift
    for i in range(len(s.instance_mesh)):
        s.set_transform(i, m)
        s.set_transform(i, m)                 # previous = current
    cam = Camera(eye=(0.5 * SCALE + shift, 0.5 * SCALE, 1.72 * SCALE),
                 center=(0.5 * SCALE + shift, 0.5 * SCALE, 0.0))
    return s, cam


def _renderer(kind, scene, cam, **cfg):
    if kind == "single":
        return RestirRenderer(scene, cam, RenderConfig(width=32, height=27,
                                                       **cfg), device="cpu")
    # two bands need an even height
    return ShardedRestirRenderer(scene, cam, RenderConfig(
        width=32, height=26, **cfg), devices=["cpu"] * 2)


def _accepted_taps(monkeypatch, r, frames=3):
    """(accepted taps [passes, 2, tries]: a pass 3 runs the DI chain's
    tries, then the GI chain's; the radiance) over the frames."""
    calls = []
    real = rr._claim_first_k

    def counted(accept_t, *args):
        calls.append(int(accept_t.sum()))
        return real(accept_t, *args)

    monkeypatch.setattr(rr, "_claim_first_k", counted)
    for _ in range(frames):
        r.render()
    monkeypatch.setattr(rr, "_claim_first_k", real)
    return np.asarray(calls).reshape(-1, 2, r.cfg.spatial_max_tries), \
        r.radiance()


# each try's accepted taps of the far box within this share of the box at
# the origin's: the two differ by translation rounding alone (the far
# box's positions carry an ulp of 1/128, and its GI paths start a little
# differently), which moves a try's count by up to ~0.33; the float16
# cast accepts no GI tap and about twice the DI taps
TAPS_RTOL = 0.5
# the radiance means within 5% (seen: 2.0-2.7%; the float16 cast is as
# close, so the taps carry the check)
MEAN_RTOL = 0.05


@pytest.mark.parametrize("kind", ["single", "bands"])
def test_far_scene_keeps_its_spatial_taps(monkeypatch, kind):
    """Beyond 65504 the tables are float32, and every try of both chains
    accepts about the taps of the same box at the origin (float16
    tables, in range), where only translation rounding differs; the
    radiance means agree.  The float16 cast of the JAX package fails the
    same check on every try: it turns the GI chain off and lets the DI
    chain's rejection tests pass on inf rows."""
    scene, cam = _box(0.0)
    near, near_img = _accepted_taps(monkeypatch, _renderer(kind, scene, cam))
    assert (near > 0).all()

    scene, cam = _box(70000.0)
    r = _renderer(kind, scene, cam)
    assert r.scene_arrays.world_abs_max > rr.F16_MAX
    assert rr._accept_dtype(r.scene_arrays) is torch.float32
    far, img = _accepted_taps(monkeypatch, r)
    assert np.isfinite(img).all()
    np.testing.assert_array_less(np.abs(far - near), TAPS_RTOL * near)
    assert abs(img.mean() / near_img.mean() - 1.0) < MEAN_RTOL

    scene, cam = _box(70000.0)
    r = _renderer(kind, scene, cam)
    monkeypatch.setattr(rr, "_accept_dtype", lambda arrays: torch.float16)
    f16, _ = _accepted_taps(monkeypatch, r)
    assert (f16[:, 1] == 0).all()
    assert (np.abs(f16 - near) > TAPS_RTOL * near).all()


@pytest.mark.parametrize("kind", ["single", "bands"])
def test_in_range_scene_keeps_float16_tables(monkeypatch, kind):
    """The same box at the origin (coordinates up to 1000) keeps float16
    tables: its frames equal those of the float16 cast on every pixel,
    with the same accepted taps on every try."""
    scene, cam = _box(0.0)
    r = _renderer(kind, scene, cam)
    assert rr._accept_dtype(r.scene_arrays) is torch.float16
    taps, img = _accepted_taps(monkeypatch, r)
    scene, cam = _box(0.0)
    r = _renderer(kind, scene, cam)
    monkeypatch.setattr(rr, "_accept_dtype", lambda arrays: torch.float16)
    f16_taps, f16_img = _accepted_taps(monkeypatch, r)
    np.testing.assert_array_equal(taps, f16_taps)
    assert (taps > 0).all()
    np.testing.assert_array_equal(img, f16_img)


@pytest.mark.parametrize("kind", ["single", "bands"])
def test_far_scene_f16_records_raise(kind):
    """f16 records would store inf positions: construction raises beyond
    65504, and so does update() after a move beyond it."""
    scene, cam = _box(70000.0)
    with pytest.raises(ValueError, match=r"65504.*x = 71000"):
        _renderer(kind, scene, cam, record_dtype="f16")
    scene, cam = _box(0.0)
    r = _renderer(kind, scene, cam, record_dtype="f16")
    m = np.diag([SCALE, SCALE, SCALE, 1.0]).astype(np.float32)
    m[0, 3] = 70000.0
    for i in range(len(scene.instance_mesh)):
        scene.set_transform(i, m)
    with pytest.raises(ValueError, match="65504"):
        r.update()
