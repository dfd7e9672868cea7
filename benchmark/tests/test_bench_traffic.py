"""The traffic generator: the same seed gives the same inputs, and each
batch has its stated count (a tiny atrium and the menger scene)."""

import json
import os

import pytest
import torch

from harness import scenes, traffic
from harness.manifest import BENCH_DIR
from reference import scene as rscene


def _wavefront_spec(count=500):
    with open(os.path.join(BENCH_DIR, "traffic",
                           "trace_wavefront.json")) as fh:
        spec = json.load(fh)
    spec["batches"][1]["count"] = count
    return spec


@pytest.fixture(scope="module")
def atrium(tmp_path_factory):
    """A tiny atrium (9,536 triangles, lamps included) through the
    reference's own reader."""
    from royaltracer_dx_tpu_torch.scene.assets import generate_atrium

    path = str(tmp_path_factory.mktemp("atrium") / "atrium.obj")
    generate_atrium(path, detail=0.05)
    config = dict(scene={"kind": "obj_asset", "asset": "sponza_atrium"},
                  camera={"eye": [-9.5, 2.2, 0.0], "center": [6.0, 3.4, 0.0]},
                  render={"width": 64, "height": 48}, triangles=9536)
    return scenes.reference_scene(config, path, "cpu")


def test_wavefront_counts_and_determinism(atrium):
    sa, mats, cfg = atrium
    spec = _wavefront_spec()
    a = traffic.wavefront(2**31 + 77, spec, sa, mats, cfg)
    b = traffic.wavefront(2**31 + 77, spec, sa, mats, cfg)
    c = traffic.wavefront(2**31 + 78, spec, sa, mats, cfg)
    assert [x["name"] for x in a] == ["primary", "diffuse", "shadow"]
    assert [x["o"].shape[0] for x in a] == [64 * 48, 500, 2000]
    assert [x["query"] for x in a] == ["closest", "closest", "any"]
    for x, y in zip(a, b):
        assert torch.equal(x["o"], y["o"]) and torch.equal(x["d"], y["d"])
    assert not torch.equal(a[1]["o"], c[1]["o"])
    assert torch.equal(a[0]["d"], c[0]["d"])       # the camera's rays
    for x in a:
        n = torch.linalg.norm(x["d"], dim=-1)
        assert torch.allclose(n, torch.ones_like(n), atol=1e-5)
    assert (a[2]["t_max"] > 0).all()


def test_shadow_segments_end_on_the_lamps(atrium):
    sa, mats, cfg = atrium
    b = traffic.wavefront(5, _wavefront_spec(200), sa, mats, cfg)[2]
    end = b["o"] + b["d"] * (b["t_max"] + 10 * traffic.S_BIAS)[:, None]
    lit = sa.materials.ke[sa.tri_material.long()].sum(-1) > 0
    lamps = sa.tri_verts[lit]
    lo = lamps.amin(dim=(0, 1)) - 1e-2
    hi = lamps.amax(dim=(0, 1)) + 1e-2
    assert ((end >= lo) & (end <= hi)).all()


def test_frames_start_and_tiles_follow_the_seed():
    sa = rscene.bake(rscene.menger(2), "cpu")
    config = json.load(open(os.path.join(BENCH_DIR, "configs",
                                         "menger_l2.json")))
    config["render"] = {"width": 96, "height": 72}
    _, mats, cfg = scenes.reference_scene(config, None, "cpu")
    spec = dict(json.load(open(os.path.join(BENCH_DIR, "traffic",
                                            "static_frames.json"))),
                check_tile=6, check_grid=4)
    assert traffic.start_frame(9, spec) == traffic.start_frame(9, spec)
    assert 0 <= traffic.start_frame(2**32 + 5, spec) < spec["start_frame_span"]
    t1 = traffic.check_tiles(11, spec, sa, mats, cfg)
    assert t1 == traffic.check_tiles(11, spec, sa, mats, cfg)
    assert len(t1) == spec["check_tiles"]
    r = cfg.spatial_radius
    for x, y, w, h in t1:
        assert (w, h) == (6, 6)
        assert x > r and y > r and x + w + r < 96 and y + h + r < 72
