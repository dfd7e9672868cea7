"""The plain reference's ray queries on hand-made hits and misses, and its
scene reader against the port's on the same raw file."""

import numpy as np
import pytest
import torch

from reference import scene as rscene
from reference import trace
from reference.intersect import INF

# one triangle in the plane z = 0: (0,0), (1,0), (0,1)
TRI = torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])


def _rays(origins, dirs):
    o = torch.tensor(origins, dtype=torch.float32)
    d = torch.tensor(dirs, dtype=torch.float32)
    return tuple(o[:, c] for c in range(3)), tuple(d[:, c] for c in range(3))


def test_closest_hit_hand_cases():
    o, d = _rays([[0.25, 0.25, 1.0],     # straight down: hit at t = 1
                  [0.9, 0.9, 1.0],       # outside u + v <= 1: miss
                  [0.25, 0.25, 1.0],     # parallel to the plane: miss
                  [0.25, 0.25, -1.0],    # pointing away: t < 0, miss
                  [0.25, 0.25, 2.0]],    # beyond t_max = 1.5: miss
                 [[0, 0, -1], [0, 0, -1], [1, 0, 0], [0, 0, -1],
                  [0, 0, -1]])
    hit = trace.closest_hit(o, d, TRI, 1e-4, 1.5)
    assert hit.valid.tolist() == [True, False, False, False, False]
    assert hit.t[0] == 1.0 and hit.u[0] == 0.25 and hit.v[0] == 0.25
    assert (hit.t[1:] == INF).all() and (hit.tri == 0).all()


def test_closest_hit_keeps_the_first_of_equal_hits_and_the_nearest():
    tris = torch.cat([TRI + torch.tensor([0.0, 0.0, -0.5]), TRI, TRI])
    o, d = _rays([[0.2, 0.2, 1.0]], [[0, 0, -1]])
    hit = trace.closest_hit(o, d, tris, 1e-4, 10.0)
    assert hit.tri.item() == 1 and hit.t.item() == 1.0
    ties = trace.tie_count(o, d, tris, 1e-4, 10.0, hit.t)
    assert ties.item() == 2


def test_any_hit_and_dead_segments():
    o, d = _rays([[0.25, 0.25, 1.0]] * 3, [[0, 0, -1]] * 3)
    occ = trace.any_hit(o, d, TRI, torch.tensor([0.0, 0.0, 2.0]),
                        torch.tensor([2.0, 0.5, 1.0]))
    assert occ.tolist() == [True, False, False]


def test_bfloat16_moves_the_hit():
    tri = TRI * 3.0 + torch.tensor([0.0, 0.0, 0.0])
    o, d = _rays([[0.3333, 0.7777, 2.3456]], [[0, 0, -1]])
    t32 = trace.closest_hit(o, d, tri, 1e-4, 10.0).t
    t16 = trace.closest_hit(o, d, tri, 1e-4, 10.0, dtype=torch.bfloat16).t
    assert t32.item() == pytest.approx(2.3456, rel=1e-6)
    assert abs(t16.item() - t32.item()) > 1e-3


def test_reference_obj_reader_matches_the_port(tmp_path):
    """The same raw OBJ read by the reference and by the port gives the
    same world triangles, normals and materials."""
    from royaltracer_dx_tpu_torch.scene.assets import generate_atrium
    from royaltracer_dx_tpu_torch.scene.scene import Scene

    path = str(tmp_path / "atrium.obj")
    generate_atrium(path, detail=0.05)
    s = Scene()
    s.add_instance(s.add_obj(path))
    port = s.flatten(device="cpu")
    r = rscene.empty_scene()
    r.add_instance(rscene.load_obj(r, path))
    ref = rscene.bake(r, "cpu")
    assert torch.equal(ref.tri_verts, port.tri_verts)
    assert torch.equal(ref.tri_normals, port.tri_normals)
    assert torch.equal(ref.tri_material, port.tri_material)
    assert torch.equal(ref.materials.ke, port.materials.ke)
    assert torch.equal(ref.materials.lut, port.materials.lut)
    assert torch.equal(ref.lights.cdf, port.lights.cdf)


def test_reference_menger_matches_the_port():
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    s, _ = menger_scene(2)
    port = s.flatten(device="cpu")
    ref = rscene.bake(rscene.menger(2), "cpu")
    assert ref.num_triangles == port.num_triangles == 4802
    assert torch.equal(ref.tri_table, port.tri_table)
    assert np.allclose(ref.lights.verts.numpy(), port.lights.verts.numpy())


@pytest.mark.parametrize("render,ok", [
    ({"width": 64, "height": 48, "gi_bounces": 1}, True),
    ({"traversal": "bvh", "gi_compaction": "on"}, True),
    ({"exposure": 1.0}, True),
    ({"aa_jitter": False}, False),
    ({"samples_per_pixel": 4}, False),
    ({"no_such_key": 1}, False),
])
def test_reference_refuses_render_keys_it_does_not_model(render, ok):
    from reference.config import from_render

    if ok:
        cfg = from_render(render)
        assert all(getattr(cfg, k) == v for k, v in render.items())
    else:
        with pytest.raises(ValueError):
            from_render(render)


@pytest.mark.parametrize("side", ["program", "reference"])
def test_a_scene_with_other_triangles_than_stated_is_refused(side):
    import json
    import os

    from harness import scenes
    from harness.manifest import BENCH_DIR, ManifestError

    with open(os.path.join(BENCH_DIR, "configs", "menger_l2.json")) as fh:
        config = dict(json.load(fh), triangles=4801)
    with pytest.raises(ManifestError):
        if side == "program":
            scenes.program_scene(config)
        else:
            scenes.reference_scene(config, None, "cpu")
