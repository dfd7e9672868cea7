"""The full DI+GI bar of the port's RMSE harness (tests/test_rmse.py:105-
112) and the converged-mean check of tests/test_restir.py:166-180, with
the port alone on the CPU; helpers and setting in tests/test_torch_rmse.py.
"""

from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.render.renderer import Renderer
from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
from royaltracer_dx_tpu_torch.scene.procedural import cornell_box
from royaltracer_dx_tpu_torch.utils.metrics import rel_mean, rmse
from test_torch_restir import one_torch_thread  # noqa: F401 (autouse)
from test_torch_rmse import CAM, oracle, restir


def test_full_pipeline_energy_correct():
    """Full DI+GI against the quirk-free 5-bounce oracle (the JAX package
    measured 0.983 / 0.038 at these frame counts)."""
    a = oracle(max_bounces=5, frames=250)
    b = restir(frames=120)
    r = rel_mean(b, a)
    assert 0.94 < r < 1.04, (r, rmse(b, a))
    assert rmse(b, a) < 0.08, rmse(b, a)


def test_restir_matches_megakernel_mean():
    """Converged ReSTIR and the megakernel agree in overall energy
    (loose; tests/test_restir.py:166-180, the megakernel with its quirk
    and jitter as there)."""
    mk = Renderer(cornell_box(emission=18.0), CAM,
                  RenderConfig(width=32, height=32, max_bounces=4),
                  device="cpu")
    rs = RestirRenderer(cornell_box(emission=18.0), CAM,
                        RenderConfig(width=32, height=32), device="cpu")
    for _ in range(8):
        mk.render()
        rs.render()
    m_ref = mk.radiance().mean()
    m_res = rs.radiance().mean()
    assert 0.3 * m_ref < m_res < 3.0 * m_ref
