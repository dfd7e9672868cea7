"""The NEE light pick of the port (ops/light_sampling.py) on the CPU: the
plain count pick against ``select_light``'s binary search, the kernel
wrapper's folding of strided picks and its argument checks, the pick
counts of a frame's telemetry record, and the packed light table built
once per baked scene.  The card's kernel is held against the plain form
in tests/test_torch_cuda.py (marker ``gpu``)."""

import numpy as np
import pytest
import torch

from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import light_sampling as ls
from royaltracer_dx_tpu_torch.render.renderer import Renderer
from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
from royaltracer_dx_tpu_torch.scene import procedural as proc
from royaltracer_dx_tpu_torch.scene.types import LightTriangles
from royaltracer_dx_tpu_torch.utils import telemetry

SHRINK = np.diag([0.2, 0.2, 0.2, 1.0]).astype(np.float32)


@pytest.fixture(autouse=True)
def _one_thread_fresh_record():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.reset()
    yield
    torch.set_num_threads(n)


def _cdf(weights) -> torch.Tensor:
    """The CDF scene/lights.py builds: a float32 cumulative sum of the
    normalised weights, the last forced to 1."""
    w = np.asarray(weights, np.float64)
    c = np.cumsum(w / w.sum()).astype(np.float32)
    c[-1] = 1.0
    return torch.as_tensor(c)


def _index_table(l_count: int) -> torch.Tensor:
    """An [L, 16] table whose row l holds l + 1000 k in column k, so that
    every plane of a pick names the row it came from."""
    row = torch.arange(l_count, dtype=torch.float32)[:, None]
    return row + 1000.0 * torch.arange(ls.RECORD, dtype=torch.float32)


def _lights(cdf: torch.Tensor) -> LightTriangles:
    n = cdf.shape[0]
    return LightTriangles(verts=torch.zeros((n, 3, 3)),
                          instance=torch.zeros(n, dtype=torch.int32),
                          weight=torch.zeros(n), cdf=cdf,
                          emission=torch.zeros((n, 3)),
                          total_weight=torch.zeros(()))


CDFS = {
    "one": [1.0],
    "two": [1.0, 3.0],
    "ties": [1.0, 0.0, 0.0, 2.0, 0.0, 1.0, 0.0],
    "zero_first": [0.0, 0.0, 1.0, 1.0],
    "atrium": list(np.random.default_rng(5).uniform(0.1, 2.0, 384)),
}


@pytest.mark.parametrize("name", sorted(CDFS))
def test_plain_pick_equals_select_light(name):
    """On a non-decreasing CDF (zero-weight lights repeat a value) the
    plain form's count of cdf[l] <= u over l < L - 1 is
    ``select_light``'s searchsorted (right) clipped to L - 1, for u at 0,
    1, every CDF value and its neighbours, and random u; every plane is
    row idx of the table."""
    cdf = _cdf(CDFS[name])
    l_count = cdf.shape[0]
    near = torch.cat([cdf, torch.nextafter(cdf, torch.tensor(0.0)),
                      torch.nextafter(cdf, torch.tensor(2.0))])
    u = torch.cat([torch.tensor([0.0, -0.0, 1.0, 0.5]), near,
                   torch.rand(1000, generator=torch.Generator().manual_seed(
                       l_count))]).to(torch.float32)
    want = ls.select_light(_lights(cdf), u).long()
    rec = ls.select_light_records(_index_table(l_count), cdf, u)
    assert len(rec) == ls.RECORD
    for k, plane in enumerate(rec):
        assert plane.shape == u.shape
        assert torch.equal(plane, want.to(torch.float32) + 1000.0 * k)


def test_plain_pick_of_nan_is_light_zero():
    """A NaN u compares false with every CDF value: light 0 (the rule the
    kernel keeps; searchsorted would sort NaN last)."""
    cdf = _cdf(CDFS["atrium"])
    u = torch.tensor([float("nan"), 0.99], dtype=torch.float32)
    rec = ls.select_light_records(_index_table(cdf.shape[0]), cdf, u)
    assert rec[0][0] == 0.0 and rec[0][1] > 0.0


@pytest.mark.parametrize("view", ["flat", "plane", "strided", "transposed",
                                  "unit_dims", "scalar", "three_d"])
def test_fold_addresses_every_lane_in_order(view):
    """``_fold``'s (rows, cols, row stride, col stride) reach each element
    of the view in row-major order, or give None where the strides do not
    fold to two dimensions (the wrapper then copies)."""
    base = torch.arange(3 * 6 * 10, dtype=torch.float32).reshape(18, 10)
    u = {"flat": base.reshape(-1),
         "plane": base,
         "strided": base[0::3],                 # nee_candidates_p's us[0::3]
         "transposed": base.t(),
         "unit_dims": base[None, 2:3, :, None],
         "scalar": base[4, 7],
         "three_d": base.reshape(3, 6, 10)[:, :4, :5]}[view]
    folded = ls._fold(u)
    if view == "three_d":
        assert folded is None
        return
    rows, cols, rs, cs = folded
    assert rows * cols == u.numel()
    lane = torch.arange(u.numel())
    r, c = lane // cols, lane % cols
    flat = base.reshape(-1)
    got = flat[u.storage_offset() + r * rs + c * cs]
    assert torch.equal(got, u.reshape(-1))


def test_kernel_wrapper_refuses_bad_arguments():
    """The wrapper's checks raise before any launch: a float64 u, a table
    that is not [L, 16], an empty CDF."""
    cdf = _cdf([1.0, 2.0, 3.0])
    table = _index_table(3)
    u = torch.rand(8)
    for args in ((table, cdf, u.double()), (table[:, :8], cdf, u),
                 (table[:2], cdf, u), (table[:0], cdf[:0], u),
                 (table, cdf[None], u)):
        with pytest.raises(ValueError):
            ls._pick(*args)
    assert ls.LAUNCHES["light_pick"] == 0


def _small_renderer(scene, **kw):
    cfg = RenderConfig(width=24, height=16, traversal="stream", **kw)
    return RestirRenderer(scene, Camera(eye=(0.5, 0.5, 1.72),
                                        center=(0.5, 0.5, 0.0)),
                          cfg, device="cpu")


@pytest.mark.parametrize("compaction", ["off", "on"])
def test_frame_counts_its_light_picks(compaction):
    """A frame's record counts one pick a NEE candidate: nee_samples_di in
    pass 1 DI and nee_samples a GI bounce; each DI pick takes every
    pixel, each GI pick the bounce's lanes (half of them when compaction
    runs the bounce on the front half)."""
    r = _small_renderer(proc.cornell_box(emission=18.0), nee_samples=2,
                        nee_samples_di=3, gi_bounces=2,
                        gi_compaction=compaction)
    r.render()
    counts = telemetry.last_frame()["counts"]
    cfg = r.cfg
    assert counts["light_pick.calls"] == (cfg.nee_samples_di
                                          + cfg.nee_samples * cfg.gi_bounces)
    p = cfg.num_pixels
    di = cfg.nee_samples_di * p
    gi = counts["light_pick.lanes"] - di
    assert cfg.nee_samples * cfg.gi_bounces * p // 2 <= gi
    assert gi <= cfg.nee_samples * cfg.gi_bounces * p
    if compaction == "off":
        assert gi == cfg.nee_samples * cfg.gi_bounces * p


def _counting_tables(monkeypatch):
    built = []
    real = ls.light_tables

    def counted(lights, object_to_world):
        built.append(object_to_world)
        return real(lights, object_to_world)

    monkeypatch.setattr(ls, "light_tables", counted)
    return built


def test_light_table_is_built_once_per_baked_scene(monkeypatch):
    """The packed table is built at a baked scene's first pick and kept
    for every later pick of that scene (16 a frame); ``update()`` bakes
    new arrays, whose first frame builds the table again, under the moved
    transforms: the moved instance's lights move, and the table equals
    one built afresh."""
    scene = proc.cornell_box(emission=18.0)
    scene.add_instance(0, SHRINK)
    r = _small_renderer(scene, gi_compaction="off")
    built = _counting_tables(monkeypatch)
    r.render()
    assert len(built) == 1
    r.render()
    assert len(built) == 1
    old = r.scene_arrays.light_table
    scene.set_transform(1, np.array([[1, 0, 0, 0.3], [0, 1, 0, 0.3],
                                     [0, 0, 1, 0.3], [0, 0, 0, 1]],
                                    np.float32) @ SHRINK)
    r.update()
    assert len(built) == 1
    r.render()
    assert len(built) == 2
    sa = r.scene_arrays
    new = sa.light_table
    assert new.shape == old.shape == (sa.lights.count, ls.RECORD)
    assert new.is_contiguous()
    assert torch.equal(new, torch.stack(
        ls.light_tables(sa.lights, sa.object_to_world), dim=1))
    moved = sa.lights.instance == 1
    assert bool(moved.any()) and bool((~moved).any())
    assert torch.equal(new[~moved], old[~moved])
    assert not torch.equal(new[moved, :9], old[moved, :9])


def test_megakernel_reads_the_cached_table(monkeypatch):
    """The megakernel Renderer picks from its scene's cached table too:
    one build over two frames of every bounce."""
    built = _counting_tables(monkeypatch)
    r = Renderer(proc.cornell_box(emission=18.0),
                 Camera(eye=(0.5, 0.5, 1.72), center=(0.5, 0.5, 0.0)),
                 RenderConfig(width=16, height=16, max_bounces=2),
                 device="cpu")
    r.render()
    r.render()
    assert len(built) == 1
