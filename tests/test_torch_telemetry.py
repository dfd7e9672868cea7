"""The port's telemetry (utils/telemetry.py): the spans of a frame, its
passes, trace batches, worklists and host waits; the batch and stream
counters; the record and its readers; profile mode's pass times,
booked at the pass spans' exits; and on the card, a scene update's spans,
waits and arrays.

CPU tests on 32 x 32 Cornell frames (stream traversal: the flat stream
route and brute force) on one torch thread.  The tests marked ``gpu``
need a card; this file imports neither JAX nor the JAX package, so run
them there with

    python -m pytest --noconftest tests/test_torch_telemetry.py -q
"""

import json
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import restir
from royaltracer_dx_tpu_torch.ops import stream_trace as tst
from royaltracer_dx_tpu_torch.parallel import shard as tshard
from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
from royaltracer_dx_tpu_torch.scene.procedural import cornell_box, menger_scene
from royaltracer_dx_tpu_torch.tools.brute_cases import grid_tris
from royaltracer_dx_tpu_torch.utils import telemetry

PASSES = ["pass1_di", "pass1_gi", "pass2_temporal", "pass3_spatial",
          "accumulate"]


@pytest.fixture(autouse=True)
def _one_thread_fresh_record():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.reset()
    yield
    torch.set_num_threads(n)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cfg(**kw):
    return RenderConfig(width=32, height=32, traversal="stream", **kw)


def _renderer(device="cpu", **kw):
    return RestirRenderer(cornell_box(emission=18.0),
                          Camera(eye=(0.5, 0.5, 1.72),
                                 center=(0.5, 0.5, 0.0)),
                          _cfg(**kw), device=device)


def _profiled(fn, path):
    """Run fn() under the CPU profiler; the exported Chrome trace.  A
    session's first range takes ~1 ms to open (the profiler's own set-up
    of the thread's events), so one range is opened before fn."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        fn()
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def _ranges(trace):
    """(start us, end us, name) of the trace's rt.* ranges, by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in trace["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("rt."))


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.fixture(scope="module")
def profiled_frame(tmp_path_factory):
    """One frame rendered unprofiled, then one under the CPU profiler:
    the trace and the record of the profiled frame."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        telemetry.reset()
        r = _renderer()
        r.render()
        trace = _profiled(r.render,
                          tmp_path_factory.mktemp("prof") / "frame.json")
        return trace, telemetry.last_frame(profiled=True)
    finally:
        torch.set_num_threads(n)


def test_frame_holds_the_pass_spans_in_order(profiled_frame):
    trace, _ = profiled_frame
    ranges = _ranges(trace)
    frames = [r for r in ranges if r[2] == "rt.frame"]
    assert len(frames) == 1
    passes = [r for r in ranges if r[2][3:] in PASSES]
    assert [r[2][3:] for r in passes] == PASSES
    assert all(_within(p, frames[0]) for p in passes)
    traces = [r for r in ranges if r[2].startswith("rt.trace.")
              and r[2] != "rt.trace.prepare"]
    assert {r[2] for r in traces} >= {"rt.trace.closest.stream",
                                      "rt.trace.closest.brute",
                                      "rt.trace.any.stream"}
    for t in traces:
        assert sum(_within(t, p) for p in passes) == 1, t
    streams = [t for t in traces if t[2].endswith(".stream")]
    prepares = [r for r in ranges if r[2] == "rt.trace.prepare"]
    assert len(prepares) == len(streams)
    for p in prepares:
        assert any(_within(p, s) for s in streams), p
    pack = [r for r in ranges if r[2] == "rt.pack_last"]
    assert len(pack) == 1 and _within(pack[0], passes[2])


def test_record_timestamps_match_the_profiler_ranges(profiled_frame):
    """Within 1 ms: the record's host clock is the profiler's (a range's
    ts plus the trace's baseTimeNanoseconds)."""
    trace, rec = profiled_frame
    assert rec["profiled"]
    base = trace.get("baseTimeNanoseconds", 0)
    ranges = _ranges(trace)
    assert len(rec["spans"]) == len(ranges)
    for name in {n for n, _, _ in rec["spans"]}:
        got = sorted((a, b) for n, a, b in rec["spans"] if n == name)
        want = sorted((a * 1e3 + base, b * 1e3 + base)
                      for a, b, n in ranges if n == "rt." + name)
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(got, want):
            assert abs(a - c) < 1e6 and abs(b - d) < 1e6


def test_profiler_off_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    r = _renderer()
    r.render()
    rec = telemetry.last_frame(profiled=False)
    names = [n for n, _, _ in rec["spans"]]
    assert set(PASSES) | {"frame", "pack_last", "trace.prepare",
                          "sync.occupancy"} <= set(names)
    assert all(b >= a for _, a, b in rec["spans"])
    assert rec["batches"] and rec["stream"]["pairs"] > 0
    assert telemetry.last_frame(profiled=True) is None


def test_frame_is_bit_identical_with_the_profiler_on_and_off(tmp_path):
    plain, traced = _renderer(), _renderer()
    for i in range(2):
        plain.render()
        _profiled(traced.render, tmp_path / f"f{i}.json")
    a, b = plain.state_dict(), traced.state_dict()
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _segments(n, seed=5):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * 2.0 - 1.0
    o[:, 2] = 0.4 + torch.rand(n, generator=g)
    d = torch.randn((n, 3), generator=g)
    d[:, 2] = -d[:, 2].abs() - 0.3
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.rand(n, generator=g) * 2.5 + 0.2
    t_max[::7] = -1.0
    return o, d, t_max


@pytest.mark.parametrize("query", ["closest", "any"])
def test_pair_counter_equals_the_kernels_stats(query):
    """The stream counter, outside a frame and in one, against the stats
    of direct stream_closest / stream_any calls on the same rows (the 70 x
    70 grid, 8 blocks)."""
    accel = tst.build_stream_accel(torch.as_tensor(grid_tris(70)))
    o, d, t_max = _segments(1000)
    t_min = torch.full((1000,), 1e-4)
    entry = tst.closest_hit_stream if query == "closest" else \
        tst.any_hit_stream
    kern = tst.stream_closest if query == "closest" else tst.stream_any
    entry(o, d, accel, t_min, t_max)
    outside = telemetry.outside_frames()["stream"]
    with telemetry.frame():
        entry(o, d, accel, t_min, t_max)
    inside = telemetry.last_frame()["stream"]
    rows, wl, went, cnt = tst.prepare_stream(o, d, accel, t_min, t_max, 64)
    _, _, stats = kern(rows, wl, went, cnt, accel.blk_tris, accel.blk_boxes)
    want = dict(zip(telemetry.STREAM_STATS, stats.sum(dim=0).tolist()))
    assert want["pairs"] > 0
    assert outside == want and inside == want
    assert telemetry.outside_frames()["stream"] == {
        k: 2 * v for k, v in want.items()}


def test_presort_spans_its_order_as_prepare(tmp_path):
    """On a windowed accel (more than 128 clusters) the presorted entry
    point spans both coherence_order and prepare_stream."""
    accel = tst.build_stream_accel(torch.as_tensor(grid_tris(70)))
    assert accel.num_blocks * tst.S > 128
    o, d, t_max = _segments(512)
    trace = _profiled(lambda: tst.any_hit_stream_xla(
        o, d, accel, torch.zeros(512), t_max, presort=True),
        tmp_path / "presort.json")
    assert [r[2] for r in _ranges(trace)] == ["rt.trace.prepare"] * 2


def test_batches_outside_frames_are_totalled():
    r = _renderer()
    o, d, t_max = _segments(300)
    restir.trace_closest(r.scene_arrays, o, d, r.cfg)
    restir.trace_closest(r.scene_arrays, o, d, r.cfg)
    restir.trace_occluded(r.scene_arrays, o, d, torch.zeros(300), t_max,
                          r.cfg)
    out = telemetry.outside_frames()
    assert out["batches"] == {"closest.stream": [2, 600],
                              "any.stream": [1, 300]}
    assert out["stream"]["pairs"] > 0
    assert telemetry.last_frame() is None


@pytest.mark.parametrize("compaction", ["on", "off"])
def test_host_waits_of_a_cpu_frame(compaction):
    """GI compaction reads the active count once a bounce; the frame's
    occupancy read ends it: gi_bounces + 1 sync spans with compaction,
    1 without."""
    r = _renderer(gi_compaction=compaction)
    r.render()
    syncs = [n for n, _, _ in telemetry.last_frame()["spans"]
             if n.startswith("sync.")]
    bounces = r.cfg.gi_bounces if compaction == "on" else 0
    assert sorted(syncs) == (["sync.gi_compaction"] * bounces
                             + ["sync.occupancy"])


def test_record_keeps_the_last_four_frames():
    for _ in range(telemetry.KEEP_FRAMES + 2):
        with telemetry.frame():
            with telemetry.span("pass1_di"):
                pass
    assert len(telemetry.RECORD.frames) == telemetry.KEEP_FRAMES
    assert telemetry.last_frame(profiled=True) is None
    assert [n for n, _, _ in telemetry.last_frame()["spans"]] == [
        "pass1_di", "frame"]


@pytest.mark.parametrize("temporal", [True, False])
def test_profile_mode_keys_are_unchanged(temporal):
    """The pass spans book profile mode's times under the keys the ticks
    had; the occupancy keys stay; the sharded renderer keeps its stage
    keys."""
    r = _renderer(temporal_reuse=temporal)
    r.profile = True
    r.render()
    want = {"pass1_di", "pass1_gi", "pass2_temporal", "pass3_spatial"}
    if temporal:
        want.add("pack_last")
    assert set(r.metrics["pass_times_s"]) == want
    assert all(v >= 0.0 for v in r.metrics["pass_times_s"].values())
    assert set(r.metrics["occupancy"]) == {"pass1_sampling"} | {
        f"gi_bounce{b}_active" for b in range(r.cfg.gi_bounces)}
    if not temporal:
        return
    s = tshard.ShardedRestirRenderer(
        cornell_box(emission=18.0),
        Camera(eye=(0.5, 0.5, 1.72), center=(0.5, 0.5, 0.0)), _cfg(),
        devices=["cpu"] * 2)
    s.profile = True
    s.render()
    assert set(s.metrics["pass_times_s"]) == {"pass1", "pass2_temporal",
                                              "pass3_spatial"}
    names = [n for n, _, _ in telemetry.last_frame()["spans"]]
    assert set(PASSES) <= set(names)
    assert names.count("sync.occupancy") == 2


@pytest.mark.gpu
def test_card_frame_waits_only_inside_sync_spans():
    """Under torch's sync debug mode every synchronising call of a card
    frame (compaction on, so the bounces read their counts) warns inside
    one of the frame's sync spans, and each sync span holds one.  (Setting
    the mode warns once itself: that warning is dropped.)"""
    dev = _card()
    r = _renderer(dev, gi_compaction="on")
    r.render()
    torch.cuda.synchronize()
    stamps = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda *a, **k: stamps.append(time.time_ns())
        torch.cuda.set_sync_debug_mode("warn")
        stamps.clear()
        try:
            r.render()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [(a, b) for n, a, b in telemetry.last_frame()["spans"]
             if n.startswith("sync.")]
    assert stamps and len(stamps) == len(syncs)
    for t in stamps:
        assert sum(a <= t <= b for a, b in syncs) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("query", ["closest", "any"])
def test_card_pair_counter_equals_the_kernels_stats(query):
    dev = _card()
    accel = tst.build_stream_accel(torch.as_tensor(grid_tris(70),
                                                   device=dev))
    o, d, t_max = (x.to(dev) for x in _segments(5000))
    t_min = torch.full((5000,), 1e-4, device=dev)
    rows, wl, went, cnt = tst.prepare_stream(o, d, accel, t_min, t_max, 64)
    kern = tst.stream_closest if query == "closest" else tst.stream_any
    with telemetry.frame():
        _, _, stats = kern(rows, wl, went, cnt, accel.blk_tris,
                           accel.blk_boxes)
    want = dict(zip(telemetry.STREAM_STATS, stats.sum(dim=0).tolist()))
    assert want["pairs"] > 0
    assert telemetry.last_frame()["stream"] == want
    plain = tst._stream_plain(rows.cpu(), wl.cpu(), went.cpu(), cnt.cpu(),
                              accel.blk_tris.cpu(), accel.blk_boxes.cpu(),
                              query == "any")
    assert torch.equal(plain[2], stats.cpu())


def _moving_renderer(device):
    """A level-2 Menger sponge under its light (two instances) whose
    sponge, instance 0, is then turned 3 degrees about the vertical axis:
    the next update() refits it."""
    scene, cam = menger_scene(2)
    r = RestirRenderer(scene, cam, _cfg(), device=device)
    th = np.radians(3.0)
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[2, 2] = np.cos(th)
    m[0, 2], m[2, 0] = np.sin(th), -np.sin(th)
    scene.set_transform(0, m)
    return r


def _update_outputs(sa) -> dict:
    out = {f: getattr(sa, f) for f in (
        "tri_verts", "tri_normals", "tri_material", "tri_instance",
        "tri_table", "object_to_world", "prev_object_to_world")}
    out.update({"lights." + f: getattr(sa.lights, f) for f in (
        "verts", "instance", "weight", "cdf", "emission", "total_weight")})
    out.update({"stream." + f: getattr(sa.stream, f) for f in (
        "blk_tris", "blk_boxes", "top_lo", "top_hi", "perm")})
    return out


@pytest.mark.gpu
def test_card_update_is_bit_identical_with_the_telemetry_on_and_off(
        tmp_path):
    """update() under the profiler (every span a ``record_function``
    range) and without it give the same arrays, bit for bit, and both
    equal the update's parts composed as the flatten before its spans
    composed them (the copies, ``_world_bake``, the stream refit, the
    light table, the bounds, the triangle table); the ``rt.update.*``
    ranges lie inside ``rt.update`` and kernels run inside it."""
    from royaltracer_dx_tpu_torch.scene import scene as tscene
    from royaltracer_dx_tpu_torch.scene.types import (
        SceneArrays,
        world_bounds,
    )

    dev = _card()
    plain, traced = _moving_renderer(dev), _moving_renderer(dev)
    first = plain.scene_arrays
    plain.update()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced.update()
        torch.cuda.synchronize()
    path = tmp_path / "update.json"
    prof.export_chrome_trace(str(path))
    sc = plain.scene
    xf = torch.as_tensor(np.stack(sc.transforms), device=dev)
    obj_tv, obj_tn, tm, ti = sc._object_static(dev)
    tv, tn = tscene._world_bake(obj_tv, obj_tn, ti, xf)
    parts = SceneArrays(
        tri_verts=tv, tri_normals=tn, tri_material=tm, tri_instance=ti,
        materials=plain.materials, lights=sc.build_lights(device=dev),
        object_to_world=xf,
        prev_object_to_world=torch.as_tensor(np.stack(sc.prev_transforms),
                                             device=dev),
        bounds=world_bounds(tv),
        stream=tst.refit_stream_accel(first.stream, tv)).with_tri_table()
    a = _update_outputs(plain.scene_arrays)
    b = _update_outputs(traced.scene_arrays)
    c = _update_outputs(parts)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k], c[k]), k
    assert plain.scene_arrays.bounds == parts.bounds
    assert not torch.equal(a["tri_verts"], first.tri_verts)
    trace = json.loads(path.read_text())
    ranges = _ranges(trace)
    outer = [r for r in ranges if r[2] == "rt.update"]
    assert len(outer) == 1
    assert {r[2] for r in ranges} == {
        "rt.update", "rt.update.bake", "rt.update.refit",
        "rt.update.lights", "rt.update.table", "rt.sync.transforms",
        "rt.sync.lights", "rt.sync.world_bounds"}
    assert all(_within(r, outer[0]) for r in ranges)
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    assert kernels
    rec = telemetry.last_update(profiled=True)
    assert rec["counts"] == dict(
        triangles=sc.num_triangles,
        stream_slots=plain.scene_arrays.stream.perm.shape[0])


@pytest.mark.gpu
def test_card_update_waits_only_inside_sync_spans():
    """Under torch's sync debug mode every synchronising call of a card
    update() warns inside one of its sync spans, and each sync span holds
    one: the two transform copies, the light table's copies and the world
    bounds' read."""
    dev = _card()
    r = _moving_renderer(dev)
    torch.cuda.synchronize()
    stamps = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda *a, **k: stamps.append(time.time_ns())
        torch.cuda.set_sync_debug_mode("warn")
        stamps.clear()
        try:
            r.update()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    spans = telemetry.last_update()["spans"]
    syncs = [(a, b) for n, a, b in spans if n.startswith("sync.")]
    assert stamps and len(stamps) == len(syncs)
    for t in stamps:
        assert sum(a <= t <= b for a, b in syncs) == 1
    names = [n for n, _, _ in spans if n.startswith("sync.")]
    assert names.count("sync.transforms") == 2
    assert names.count("sync.world_bounds") == 1
    assert set(names) == {"sync.transforms", "sync.lights",
                          "sync.world_bounds"}
