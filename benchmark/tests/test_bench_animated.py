"""The animated cell (``kinds/animated_frames.py`` on ``scenes/
dragon_stage.py``) on the CPU at a small size: the CLI's dragon stage
with a 1,920-triangle dragon facing out, 64 x 48 pixels, 6-pixel check
tiles.  A sound run is correct; the control (the reference in bfloat16
in the program's place) and two faults of the moving loop (``update()``
skipped, so the program renders the rest pose while the reference
moves; the previous transform left at the current pose, so temporal
reuse reprojects the dragon to where it is now) are not.  The two sides'
scenes agree at the rest pose and at a turned one, the dragon faces the
camera, and the update's readers read the port's record and trace."""

import copy
import json

import numpy as np
import pytest
import torch

from harness import cells, check, manifest, program_trace
from harness.main import run_cell
from harness.manifest import load_plugin, load_reader
from reference import motion

SEED = 2**31 + 4242
CELL = "dragon-animate-1080p"
NU, NV = 40, 24


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A function giving the cell cut to the CPU size, its asset in a
    folder of its own; the camera and the pivot are the CLI's for the
    small dragon, as the configuration's are for the large one."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ROYALTRACER_ASSET_DIR",
                  str(tmp_path_factory.mktemp("assets")))
        from royaltracer_dx_tpu_torch.cli import build_scene
        from royaltracer_dx_tpu_torch.scene.assets import ensure_asset

        ensure_asset("dragon", nu=NU, nv=NV)
        scene, cam = build_scene("dragon")
        base = manifest.resolve(CELL)

        def make(amplitude_deg=None, check_tile=6):
            cell = copy.deepcopy(base)
            cfg = cell.config
            cfg["scene"] = dict(cfg["scene"], nu=NU, nv=NV)
            cfg["triangles"] = scene.num_triangles
            cfg["camera"] = dict(eye=list(cam.eye), center=list(cam.center))
            cfg["motion"] = dict(cfg["motion"], pivot=list(cam.center))
            if amplitude_deg is not None:
                cfg["motion"]["amplitude_deg"] = amplitude_deg
            cfg["render"] = dict(width=64, height=48)
            cell.traffic.update(check_tile=check_tile, check_grid=3)
            return cell

        yield make


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_cell_takes_the_moving_loop(small):
    cell = small()
    assert cell.traffic["kind"] == "animated_frames"
    assert cell.config["motion"]["instance"] == 0
    assert cell.config["triangles"] == 2 * NU * NV + 4
    full = manifest.resolve(CELL).config
    assert full["triangles"] == 871204 and full["reduced"] == []
    assert full["motion"]["pivot"] == full["camera"]["center"]


# the size at which a wrong previous transform moves pixels: a 30 degree
# swing and 16-pixel tiles (at 64 x 48 a 4 degree one moves the dragon by
# less than a pixel)
WIDE = dict(amplitude_deg=30.0, check_tile=16)


@pytest.mark.parametrize("size", ["cell", "wide"])
def test_sound_run_is_correct(small, size):
    res = run_cell(small(**(WIDE if size == "wide" else {})), SEED, 0.1,
                   False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and "setup_s" in res["metrics"]
    assert set(res["checks"]) == {"off_pct.start", "off_pct.last"}


@pytest.mark.parametrize("fault", ["control", "update_skipped",
                                   "prev_is_current"])
def test_faults_are_not_correct(small, monkeypatch, fault):
    """The control; ``update()`` skipped: the program renders the rest
    pose while the reference moves; the previous transform left equal to
    the current pose (``Scene.set_transform`` not rolling it), at the
    ``WIDE`` size: temporal reuse on the dragon reads the wrong pixels.
    The start, at rest on both sides, stays correct under either fault."""
    from royaltracer_dx_tpu_torch.render.restir_renderer import (
        RestirRenderer,
    )
    from royaltracer_dx_tpu_torch.scene.scene import Scene

    def prev_is_current(self, i, t):
        self.transforms[i] = np.asarray(t, np.float32)
        self.prev_transforms[i] = self.transforms[i]

    cell = small(**(WIDE if fault == "prev_is_current" else {}))
    if fault == "update_skipped":
        monkeypatch.setattr(RestirRenderer, "update",
                            lambda self, camera=None: None)
    if fault == "prev_is_current":
        monkeypatch.setattr(Scene, "set_transform", prev_is_current)
    c = cells.make(cell, SEED, "cpu")
    c.setup()
    c.window(0.1)
    c.free()
    assert c.last_k >= 2 and motion.angle_deg(c.last_k, c.motion) != 0.0
    numbers = c.check(control=fault == "control")
    correct, checks = check.verdict(numbers, cell.limits)
    assert not correct, checks
    if fault != "control":
        assert numbers["off_pct.start"] == 0.0, checks


def test_the_dragon_faces_the_camera(small):
    """The stage's dragon is the generated one turned inside out: every
    face reversed and every normal negated against the generator's file,
    so on nearly every camera ray that meets it the shading normals face
    the camera (on the generator's own file they face away)."""
    from reference import camera as rcam
    from reference import math3d as m3
    from reference import trace as rtrace

    from harness import scenes

    outward = load_plugin("scenes", "dragon_stage").outward
    cell = small()
    c = cells.make(cell, SEED, "cpu")
    _, _, c.path = scenes.program_scene(cell.config)
    src = c.path.replace("_outward.obj", ".obj")
    assert outward(src) == c.path

    def rows(p, tag):
        with open(p) as fh:
            return [ln.split()[1:] for ln in fh if ln.startswith(tag)]

    assert rows(c.path, "f ") == [f[:1] + f[:0:-1] for f in rows(src, "f ")]
    assert np.array_equal(np.asarray(rows(c.path, "vn "), np.float32),
                          -np.asarray(rows(src, "vn "), np.float32))
    sa, mats, rcfg = c.reference_at(0)
    o, d = rcam.generate_rays(mats, rcfg.width, rcfg.height)
    d = m3.normalize(d)
    hit = rtrace.closest_hit(tuple(o[:, k].contiguous() for k in range(3)),
                             tuple(d[:, k] for k in range(3)), sa.tri_verts)
    tri = hit.tri.clamp(0, sa.num_triangles - 1).long()
    on = hit.valid & (sa.tri_instance[tri] == 0)
    n = sa.tri_normals[tri[on]].sum(1)
    facing = (n * d[on]).sum(-1) < 0.0
    assert int(on.sum()) > 200
    assert float(facing.float().mean()) > 0.95


@pytest.mark.parametrize("k", [0, 2])
def test_both_sides_bake_the_same_stage(small, k):
    """The port's scene (the stage, moved to frame k's pose and
    updated) against the reference's own parse and bake at that pose:
    world triangles, normals, materials, instances, transforms and the
    light table equal."""
    from royaltracer_dx_tpu_torch.render.restir_renderer import bake

    cell = small()
    c = cells.make(cell, SEED, "cpu")
    from harness import scenes

    scene, _, c.path = scenes.program_scene(cell.config)
    mot = cell.config["motion"]
    if k:
        scene.set_transform(0, motion.pose(k - 1, mot))
        scene.set_transform(0, motion.pose(k, mot))
    got = bake(scene, scene.build_materials(device="cpu"),
               scenes.program_config(cell.config), "cpu")
    want = c.reference_at(k)[0]
    for f in ("tri_verts", "tri_normals", "tri_material", "tri_instance",
              "object_to_world", "prev_object_to_world"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("kd", "ks", "ni", "ke", "pr_pm_ps_pc", "lut"):
        assert torch.equal(getattr(got.materials, f),
                           getattr(want.materials, f)), f
    for f in ("verts", "instance", "weight", "cdf", "emission",
              "total_weight"):
        assert torch.equal(getattr(got.lights, f),
                           getattr(want.lights, f)), f


def test_update_readers_on_a_cpu_update(small, tmp_path, monkeypatch):
    """A frame, then a moved instance's update() under the CPU profiler:
    the host ms is the record's ``update`` span, the device ms 0 (no
    kernels on the CPU), so the roofline reads nothing; a program
    without the record or the range reads nothing and raises nothing."""
    from torch.profiler import ProfilerActivity, profile

    from royaltracer_dx_tpu_torch.utils import telemetry

    cell = small()
    telemetry.reset()
    c = cells.make(cell, SEED, "cpu")
    c.setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c.step()
    path = tmp_path / "cpu.trace.json"
    prof.export_chrome_trace(str(path))
    monkeypatch.setattr(program_trace, "trace_path", lambda: str(path))
    frame = dict(kind="frame", update_tris=cell.config["triangles"])
    rec = telemetry.last_update(profiled=False)
    want = [b - a for n, a, b in rec["spans"] if n == "update"][-1]
    assert load_reader("update_host_ms")(frame) == pytest.approx(want * 1e-6)
    assert program_trace.load()["ranges"]["rt.update"] == 1
    assert load_reader("update_device_ms")(frame) == 0.0
    assert load_reader("update_roofline")(frame) is None
    assert load_reader("update_host_ms")(dict(kind="wavefront")) is None
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if not e.get("name", "").startswith("rt.")]
    old = tmp_path / "old.trace.json"
    old.write_text(json.dumps({"traceEvents": ev}))
    monkeypatch.setattr(program_trace, "trace_path", lambda: str(old))
    monkeypatch.delattr(telemetry, "last_update")
    for name in ("update_host_ms", "update_device_ms", "update_roofline"):
        assert load_reader(name)(frame) is None


def test_update_roofline_on_a_hand_trace(tmp_path, monkeypatch):
    """2 ms of kernels launched inside ``rt.update``: the share is the
    least time of 871,204 triangles' update bytes over 2 ms."""
    ev = [dict(cat="user_annotation", name="rt.update", ph="X", ts=0,
               dur=100),
          dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=10, dur=1,
               args=dict(correlation=1)),
          dict(cat="kernel", name="k", ts=50, dur=2000.0,
               args=dict(correlation=1))]
    path = tmp_path / "hand.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    monkeypatch.setattr(program_trace, "trace_path", lambda: str(path))
    frame = dict(kind="frame", update_tris=871204)
    yardstick = load_plugin("metrics", "update_roofline")
    assert yardstick.update_bytes(871204) == (
        871204 * 180 + 24 * (16384 + 512))
    assert load_reader("update_device_ms")(frame) == pytest.approx(2.0)
    assert load_reader("update_roofline")(frame) == pytest.approx(
        100.0 * yardstick.update_bytes(871204) / 3.35e12 / 2e-3)


def test_the_pose_is_the_identity_at_rest_and_turns_about_the_pivot():
    mot = dict(instance=0, amplitude_deg=4.0, period_frames=8,
               pivot=[0.5, -1.0, 2.0])
    assert np.array_equal(motion.pose(0, mot), np.eye(4, dtype=np.float32))
    assert motion.angle_deg(2, mot) == pytest.approx(4.0)
    m = motion.pose(2, mot).astype(np.float64)
    p = np.array(mot["pivot"] + [1.0])
    np.testing.assert_allclose(m @ p, p, atol=1e-6)
    up = np.array([0.0, 1.0, 0.0, 0.0])
    np.testing.assert_allclose(m @ up, up, atol=1e-7)
    assert np.degrees(np.arctan2(m[0, 2], m[0, 0])) == pytest.approx(4.0,
                                                                    abs=1e-4)
