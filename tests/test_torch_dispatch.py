"""The port's trace dispatch against the JAX package's decisions.

The port's ``restir.trace_mode`` must take the JAX package's decision
(``resolve_closest_mode`` / ``resolve_any_mode``, royaltracer_dx_tpu/ops/
restir.py:88-107) on every device, for every (scene size x batch) row of
tests/test_dispatch.py's tables and under each traversal; a CUDA scene
is a stub whose ``device`` is ``torch.device("cuda")`` (the decision reads
only sizes, so no card is needed).  The JAX side is computed by calling
the JAX functions on the same stub.  ``_wants_presort`` likewise.
"""

import types

import pytest
import torch

from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.ops import restir as jrestir

from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import restir as trestir

from test_dispatch import ANY_TABLE, CLOSEST_TABLE, FLAT_TABLE, scene_stub

DEVICES = [torch.device("cpu"), torch.device("cuda")]
DEVICE_IDS = ["cpu", "cuda"]


def port_stub(tris: int, device: torch.device):
    """The JAX stub with the port's extra attributes: a device and no
    LBVH or clusters."""
    s = scene_stub(tris)
    return types.SimpleNamespace(num_triangles=s.num_triangles,
                                 stream=s.stream, device=device, bvh=None,
                                 clusters=None), s


def decide(tris, n, coherent, closest, traversal, device):
    """(port's trace_mode, JAX's decision) for one batch."""
    port, jax_scene = port_stub(tris, device)
    cfg = RenderConfig(width=256, height=256, traversal=traversal)
    jcfg = JConfig(width=256, height=256, traversal=traversal)
    if closest:
        want = jrestir.resolve_closest_mode(jax_scene, jcfg, n, coherent)
    else:
        want = jrestir.resolve_any_mode(jax_scene, jcfg, n)
    return trestir.trace_mode(port, cfg, n, coherent, closest), want


@pytest.mark.parametrize("device", DEVICES, ids=DEVICE_IDS)
@pytest.mark.parametrize("tris,n,coherent,expected", CLOSEST_TABLE)
def test_closest_mode_follows_jax(tris, n, coherent, expected, device):
    got, want = decide(tris, n, coherent, True, "auto", device)
    assert got == want == expected


@pytest.mark.parametrize("device", DEVICES, ids=DEVICE_IDS)
@pytest.mark.parametrize("tris,n,expected", ANY_TABLE)
def test_any_mode_follows_jax(tris, n, expected, device):
    got, want = decide(tris, n, True, False, "auto", device)
    assert got == want == expected


# explicit traversals: "brute" everywhere (the JAX CLI's --traversal
# brute), "stream" on a scene with a stream accel, scattered and coherent
TRAVERSAL_TABLE = [
    ("brute", 2_200, 65_536, True, True),
    ("brute", 262_144, 2_073_600, False, True),
    ("brute", 1_000_000, 262_144, True, False),
    ("stream", 2_200, 65_536, True, True),
    ("stream", 2_200, 65_536, False, True),      # flat, scattered: brute
    ("stream", 8_192, 2_073_600, False, True),
    ("stream", 96_000, 262_144, False, True),
    ("stream", 262_144, 18_662_400, True, False),
]


@pytest.mark.parametrize("device", DEVICES, ids=DEVICE_IDS)
@pytest.mark.parametrize("traversal,tris,n,coherent,closest",
                         TRAVERSAL_TABLE)
def test_traversal_mode_follows_jax(traversal, tris, n, coherent, closest,
                                    device):
    got, want = decide(tris, n, coherent, closest, traversal, device)
    assert got == want


@pytest.mark.parametrize("device", DEVICES, ids=DEVICE_IDS)
@pytest.mark.parametrize("tris,flat,presort", FLAT_TABLE)
def test_presort_follows_jax(tris, flat, presort, device):
    port, jax_scene = port_stub(tris, device)
    assert trestir._is_flat(port) == jrestir._is_flat(jax_scene) == flat
    assert (trestir._wants_presort(port) == jrestir._wants_presort(jax_scene)
            == presort)


@pytest.mark.parametrize("device", DEVICES, ids=DEVICE_IDS)
def test_stream_without_accel_raises(device):
    """A "stream" decision on a scene without a stream accel is an error
    on both devices; a brute decision on such a scene is not."""
    port, _ = port_stub(1_000, device)
    assert port.stream is None
    cfg = RenderConfig(width=8, height=8, traversal="stream")
    with pytest.raises(ValueError, match="stream accel"):
        trestir.trace_mode(port, cfg, 64, True, True)
    assert trestir.trace_mode(port, RenderConfig(width=8, height=8), 64,
                              True, False) == "brute"
