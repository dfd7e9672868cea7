"""The port's moving-object loop (``Scene.set_transform`` ->
``RestirRenderer.update()`` -> ``render()``) on a small dragon stage:
the benchmark's ``dragon_stage`` (the CLI's ``--scene dragon`` stage,
its dragon facing out) with a 384-triangle dragon, 32 x 24 pixels, the stream route, three frames turned as the benchmark's
``animated_frames`` traffic turns them.  Held against the benchmark's
plain reference (``benchmark/reference/``, its ``motion`` bake and its
frozen passes) to the check's tolerances; ``update()``'s world arrays
against a fresh bake of the pose; its spans and counts.  One torch
thread; imports neither JAX nor the JAX package."""

import json
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import check, traffic  # noqa: E402
from harness.manifest import load_plugin  # noqa: E402
from reference import camera as rcam  # noqa: E402
from reference import motion, passes  # noqa: E402
from reference.config import RenderConfig as RefConfig  # noqa: E402

from royaltracer_dx_tpu_torch.config import RenderConfig  # noqa: E402
from royaltracer_dx_tpu_torch.ops.stream_trace import (  # noqa: E402
    refit_stream_accel,
)
from royaltracer_dx_tpu_torch.render.restir_renderer import (  # noqa: E402
    RestirRenderer,
)
from royaltracer_dx_tpu_torch.utils import telemetry  # noqa: E402

W, H = 32, 24
NU, NV = 16, 12
START = 77_003


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """Frames k = 0, 1, 2 of the loop: the renderer, the state before
    frame 2, the motion, the stage's OBJ path and the renderer's first
    scene arrays."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ROYALTRACER_ASSET_DIR",
                      str(tmp_path_factory.mktemp("assets")))
            from royaltracer_dx_tpu_torch.cli import build_scene

            scene, path = load_plugin("scenes", "dragon_stage").program(dict(
                scene=dict(kind="dragon_stage", asset="dragon", nu=NU,
                           nv=NV), triangles=2 * NU * NV + 4))
            _, cam = build_scene("dragon")
        mot = dict(instance=0, amplitude_deg=4.0, period_frames=8,
                   pivot=list(cam.center))
        telemetry.reset()
        r = RestirRenderer(scene, cam,
                           RenderConfig(width=W, height=H,
                                        traversal="stream"), device="cpu")
        first = r.scene_arrays
        r.frame = START
        r.render()
        pre = None
        for k in (1, 2):
            pre = dict(last_di=r.last_di, last_gi=r.last_gi,
                       last_sdata=r.last_sdata, fb=r.fb, l1=r.l1,
                       prev_view=r._prev_view, prev_proj=r._prev_proj)
            scene.set_transform(0, motion.pose(k, mot))
            r.update()
            r.render()
        return dict(r=r, pre=pre, mot=mot, path=path, cam=cam, first=first)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_moving_frame_matches_the_plain_reference(loop):
    """Frame 2 (the dragon at 2.83 degrees, frame 1's pose as the
    previous transform) from the state before it, every pixel: none off
    beyond the check's tolerances, camera-ray ties left out."""
    r, cam = loop["r"], loop["cam"]
    stage = load_plugin("scenes", "dragon_stage")
    s = stage.reference({}, loop["path"])
    assert s.num_triangles == r.scene.num_triangles
    sa = motion.bake_at(s, loop["mot"], 2, "cpu")
    rcfg = RefConfig(width=W, height=H)
    mats = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
            for k, v in rcam.Camera(eye=tuple(cam.eye),
                                    center=tuple(cam.center)).matrices(
                W / H).items()}
    tiles = [(0, 0, W, H)]
    pix = passes.tile_pixels(rcfg, tiles, "cpu")
    ref = passes.frame_at(sa, mats, rcfg, loop["pre"], START + 2, tiles)
    got = check.program_pixels(dict(
        last_di=r.last_di, last_gi=r.last_gi, last_sdata=r.last_sdata,
        fb=r.fb, l1=r.l1), pix)
    tied = traffic.camera_ties(sa, mats, rcfg, pix)
    assert int((~tied).sum()) > W * H // 2
    on_dragon = (ref["last_sdata"]["obj"] == 0) & ~tied
    assert int(on_dragon.sum()) > 50
    # DI finds light on the dragon (on none when it faces into its tube)
    assert int((ref["last_di"]["w_sum"][on_dragon] > 0.0).sum()) > 0
    assert check.frame_off_pct(ref, got, tied) == 0.0


def test_update_equals_a_fresh_bake_of_the_pose(loop):
    """World triangles, normals, the triangle table, the light table,
    both transforms and the bounds after update() equal a first bake of
    the same scene; its stream accel equals the first accel refitted to
    the fresh triangles."""
    r = loop["r"]
    got = r.scene_arrays
    fresh = r.scene.flatten(r.materials, build_stream=True, device="cpu")
    for f in ("tri_verts", "tri_normals", "tri_table", "object_to_world",
              "prev_object_to_world"):
        assert torch.equal(getattr(got, f), getattr(fresh, f)), f
    assert not torch.equal(got.object_to_world, got.prev_object_to_world)
    assert got.bounds == fresh.bounds
    for f in ("verts", "instance", "weight", "cdf", "emission",
              "total_weight"):
        assert torch.equal(getattr(got.lights, f),
                           getattr(fresh.lights, f)), f
    want = refit_stream_accel(loop["first"].stream, fresh.tri_verts)
    for f in ("blk_tris", "blk_boxes", "top_lo", "top_hi", "perm"):
        assert torch.equal(getattr(got.stream, f), getattr(want, f)), f


def test_update_spans_and_counts(loop, tmp_path):
    """The record of the last update holds its parts and its one wait and
    counts every triangle and stream slot; under the profiler the parts
    are ``rt.update.*`` ranges inside ``rt.update``, outside any frame."""
    from torch.profiler import ProfilerActivity, profile

    r = loop["r"]
    rec = telemetry.last_update(profiled=False)
    names = [n for n, _, _ in rec["spans"]]
    assert names[-1] == "update"
    assert set(names) == {"update", "update.bake", "update.refit",
                          "update.lights", "update.table",
                          "sync.world_bounds"}
    assert rec["counts"] == dict(triangles=r.scene.num_triangles,
                                 stream_slots=r.scene_arrays.stream.perm
                                 .shape[0])
    assert rec["counts"]["triangles"] == 2 * NU * NV + 4
    r.scene.set_transform(0, motion.pose(3, loop["mot"]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.update()
    path = tmp_path / "update.json"
    prof.export_chrome_trace(str(path))
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("rt.")]
    outer = [x for x in ranges if x[2] == "rt.update"]
    assert len(outer) == 1
    inner = {x[2] for x in ranges if x[2] != "rt.update"}
    assert inner == {"rt.update.bake", "rt.update.refit", "rt.update.lights",
                     "rt.update.table", "rt.sync.world_bounds"}
    assert all(outer[0][0] <= a and b <= outer[0][1]
               for a, b, n in ranges)
    assert telemetry.last_update(profiled=True)["counts"] == rec["counts"]
