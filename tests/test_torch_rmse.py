"""Converged-image RMSE harness of the port: tests/test_rmse.py with the
port alone (no JAX), on the CPU.

The same four tests, scene (the Cornell box at emission 18), camera,
resolution (32x32), frame counts and bars as tests/test_rmse.py, whose
docstring records what each bar established.  Oracles: the MIS-free
pure-NEE ``DiOracle`` for direct light, the quirk-free megakernel
``Renderer`` (``reference_mis_quirk=False``, pixel-aligned primaries) for
full transport.  This file holds the DI chain and the two megakernel
characterisations; tests/test_torch_rmse_full.py the full DI+GI bar and
the converged-mean check of tests/test_restir.py:166-180 (the two files
run on separate workers).
"""

import numpy as np

from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.render.di_oracle import DiOracle
from royaltracer_dx_tpu_torch.render.renderer import Renderer
from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
from royaltracer_dx_tpu_torch.scene.procedural import cornell_box
from royaltracer_dx_tpu_torch.utils.metrics import rel_mean, rmse
from test_torch_restir import one_torch_thread  # noqa: F401 (autouse)

W = 32
CAM = Camera(eye=(0.5, 0.5, 1.72), center=(0.5, 0.5, 0.0))


def oracle(max_bounces, frames=200, quirk=False):
    """The megakernel at pixel-aligned primaries (test_rmse.py:67-73)."""
    r = Renderer(cornell_box(emission=18.0), CAM,
                 RenderConfig(width=W, height=W, max_bounces=max_bounces,
                              aa_jitter=False, reference_mis_quirk=quirk),
                 device="cpu")
    for _ in range(frames):
        r.render()
    return r.radiance()


def restir(frames=100, **extra):
    """ReSTIR at pixel-aligned primaries (test_rmse.py:76-82)."""
    rr = RestirRenderer(cornell_box(emission=18.0), CAM,
                        RenderConfig(width=W, height=W, aa_jitter=False,
                                     **extra), device="cpu")
    for _ in range(frames):
        rr.render()
    return rr.radiance()


def test_di_chain_unbiased_vs_oracle():
    """DI-only ReSTIR converges to the DiOracle (test_rmse.py:85-102)."""
    o = DiOracle(cornell_box(emission=18.0), CAM,
                 RenderConfig(width=W, height=W, traversal="brute"),
                 device="cpu")
    for _ in range(600):
        o.render()
    a = o.radiance()
    b = restir(gi_bounces=0)
    assert 0.97 < rel_mean(b, a) < 1.03, (rel_mean(b, a), rmse(b, a))
    assert rmse(b, a) < 0.05, rmse(b, a)


def test_mis_quirk_overcounts_indirect():
    """The reference's emissive-hit MIS quirk inflates bounce-2 energy by
    tens of percent (test_rmse.py:115-129)."""
    a1 = oracle(max_bounces=1, frames=120)
    a2 = oracle(max_bounces=2, frames=120)
    q2 = oracle(max_bounces=2, frames=120, quirk=True)
    order2 = (a2 - a1).mean()
    order2_quirk = (q2 - a1).mean()
    assert order2_quirk > 1.3 * order2, (order2_quirk, order2)


def test_megakernel_self_convergence():
    """The oracle's accumulation variance shrinks with frame count
    (test_rmse.py:132-143)."""
    r = Renderer(cornell_box(emission=18.0), CAM,
                 RenderConfig(width=W, height=W, max_bounces=2,
                              aa_jitter=False, reference_mis_quirk=False),
                 device="cpu")
    snaps = []
    for f in range(1, 121):
        r.render()
        if f in (15, 120):
            snaps.append(r.radiance())
    ref = oracle(max_bounces=2, frames=240)
    assert rmse(snaps[1], ref) < 0.7 * rmse(snaps[0], ref)
    assert np.isfinite(ref).all()
