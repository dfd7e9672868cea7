"""The readers of the program's own spans and counters
(harness/program_trace.py and the metrics that read it): on a hand
trace whose kernels lie inside and outside ``rt.*`` ranges, matched by
correlation id, with synchronising runtime calls inside and outside the
frame; and on a frame the port renders on the CPU under the profiler."""

import json
import os

import pytest
import torch

from harness import program_trace
from harness.manifest import load_reader

PASSES = ("pass1_di", "pass1_gi", "pass2_temporal", "pass3_spatial")


def _range(name, ts, dur):
    return dict(cat="user_annotation", name=name, ph="X", ts=ts, dur=dur)


def _kernel(corr, launch_ts, dur):
    return [dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=launch_ts,
                 dur=1, args=dict(correlation=corr)),
            dict(cat="kernel", name=f"k{corr}", ts=launch_ts + 200, dur=dur,
                 args=dict(correlation=corr))]


def _runtime(name, ts):
    return dict(cat="cuda_runtime", name=name, ts=ts, dur=1,
                args=dict(correlation=900 + ts))


def _trace():
    ev = [_range("rt.frame", 0, 100), _range("rt.pass1_di", 10, 30),
          _range("rt.trace.closest.stream", 20, 10),
          _range("rt.pass2_temporal", 50, 40),
          _range("rt.sync.occupancy", 92, 6),
          _range("rt.sync.camera", 2, 1),
          _range("bench.prepare", 21, 2),
          _range("rt.frame", 300, 10)]        # a second frame, no work
    ev += _kernel(1, 15, 5.0)      # pass 1, outside the trace
    ev += _kernel(2, 25, 7.0)      # pass 1 and its trace
    ev += _kernel(3, 60, 11.0)     # pass 2
    ev += _kernel(4, 91, 13.0)     # frame, no pass
    ev += _kernel(5, 200, 17.0)    # outside every range
    ev.append(dict(cat="kernel", name="orphan", ts=30, dur=19.0,
                   args=dict(correlation=77)))     # no launch recorded
    ev += [_runtime("cudaStreamSynchronize", 2), _runtime("cudaMemcpy", 93),
           _runtime("cudaMemcpyAsync", 94),         # not synchronising
           _runtime("cudaStreamSynchronize", 150),  # outside the frames
           _runtime("cudaDeviceSynchronize", 305)]
    return {"traceEvents": ev}


def test_reduction_on_a_hand_trace():
    t = program_trace.reduce(_trace())
    ms = t["device_ms"]
    assert ms["rt.frame"] == pytest.approx((5 + 7 + 11 + 13) * 1e-3)
    assert ms["rt.pass1_di"] == pytest.approx(12e-3)
    assert ms["rt.trace.closest.stream"] == pytest.approx(7e-3)
    assert ms["rt.pass2_temporal"] == pytest.approx(11e-3)
    assert ms["rt.sync.occupancy"] == 0.0
    assert "bench.prepare" not in ms
    assert t["ranges"]["rt.frame"] == 2
    assert t["frame_syncs"] == {"cudaStreamSynchronize": 1, "cudaMemcpy": 1,
                                "cudaDeviceSynchronize": 1}
    assert t["frame_sync_spans"] == 2


@pytest.fixture
def hand_trace(tmp_path, monkeypatch):
    path = tmp_path / "cell.trace.json"
    path.write_text(json.dumps(_trace()))
    monkeypatch.setattr(program_trace, "trace_path", lambda: str(path))
    return path


def test_trace_readers_on_a_hand_trace(hand_trace):
    frame = dict(kind="frame")
    assert load_reader("pass1_di_device_ms")(frame) == pytest.approx(12e-3)
    assert load_reader("pass2_temporal_device_ms")(frame) == pytest.approx(
        11e-3)
    # a range the trace does not hold, and a wavefront, read nothing
    assert load_reader("pass3_spatial_device_ms")(frame) is None
    assert load_reader("pass1_di_device_ms")(dict(kind="wavefront")) is None
    assert load_reader("host_syncs_per_frame")(frame) == 3


def test_trace_readers_without_program_ranges(tmp_path, monkeypatch):
    """A trace of a program without the spans (no ``rt.*`` range), or no
    trace at all, reads nothing and raises nothing."""
    path = tmp_path / "old.trace.json"
    ev = [e for e in _trace()["traceEvents"]
          if not e["name"].startswith("rt.")]
    path.write_text(json.dumps({"traceEvents": ev}))
    monkeypatch.setattr(program_trace, "trace_path", lambda: str(path))
    frame = dict(kind="frame")
    for name in [p + "_device_ms" for p in PASSES] + ["host_syncs_per_frame"]:
        assert load_reader(name)(frame) is None
    monkeypatch.setattr(program_trace, "trace_path", lambda: None)
    assert load_reader("host_syncs_per_frame")(frame) is None


def test_trace_path_takes_this_process_traces(tmp_path):
    old = tmp_path / "a.trace.json"
    old.write_text("{}")
    os.utime(old, (1.0, 1.0))                  # written long before
    assert program_trace.trace_path(str(tmp_path)) is None
    new = tmp_path / "b.trace.json"
    new.write_text("{}")
    (tmp_path / "b.lean.json").write_text("{}")
    assert program_trace.trace_path(str(tmp_path)) == str(new)


def _record(spans, batches, pairs):
    return dict(profiled=False, spans=spans, batches=batches,
                stream=dict(blocks=0, clusters=0, pairs=pairs))


def test_record_readers_on_a_hand_record(monkeypatch):
    from royaltracer_dx_tpu_torch.utils import telemetry

    ms = 1_000_000
    rec = _record([("pass1_di", 0, 3 * ms), ("trace.closest.stream", ms,
                                             2 * ms),
                   ("pass1_gi", 3 * ms, 8 * ms),
                   ("sync.gi_compaction", 4 * ms, 5 * ms),
                   ("sync.occupancy", 9 * ms, 11 * ms)],
                  [("closest", "stream", 100), ("closest", "brute", 50),
                   ("any", "stream", 300)], 2000)
    monkeypatch.setattr(telemetry, "last_frame", lambda profiled=False: rec)
    monkeypatch.setattr(telemetry, "outside_frames", lambda: dict(
        batches={"closest.stream": [2, 400], "any.brute": [1, 50]},
        stream=dict(blocks=0, clusters=0, pairs=1000)))
    frame, wave = dict(kind="frame"), dict(kind="wavefront")
    assert load_reader("pass1_di_host_ms")(frame) == pytest.approx(3.0)
    assert load_reader("pass1_gi_host_ms")(frame) == pytest.approx(5.0)
    assert load_reader("pass3_spatial_host_ms")(frame) == 0.0
    assert load_reader("host_wait_ms")(frame) == pytest.approx(3.0)
    assert load_reader("stream_pairs_per_ray.frame")(frame) == 5.0
    assert load_reader("stream_pairs_per_ray.trace")(wave) == 2.5
    assert load_reader("stream_pairs_per_ray.trace")(frame) is None
    assert load_reader("host_wait_ms")(wave) is None
    monkeypatch.setattr(telemetry, "last_frame", lambda profiled=False: None)
    assert load_reader("pass1_di_host_ms")(frame) is None
    assert load_reader("stream_pairs_per_ray.frame")(frame) is None


def test_readers_on_a_cpu_frame(tmp_path, monkeypatch):
    """A 32 x 32 frame of the port on the CPU, once without the profiler
    (the record) and once under it (the trace): the pass spans' host ms
    and the pair count come from the record, the ranges from the trace
    (no kernels and no runtime calls on the CPU: 0 device ms, 0 syncs)."""
    from torch.profiler import ProfilerActivity, profile

    from royaltracer_dx_tpu_torch.camera import Camera
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render.restir_renderer import (
        RestirRenderer,
    )
    from royaltracer_dx_tpu_torch.scene.procedural import cornell_box
    from royaltracer_dx_tpu_torch.utils import telemetry

    torch.set_num_threads(1)
    telemetry.reset()
    r = RestirRenderer(cornell_box(emission=18.0),
                       Camera(eye=(0.5, 0.5, 1.72), center=(0.5, 0.5, 0.0)),
                       RenderConfig(width=32, height=32, traversal="stream"),
                       device="cpu")
    r.render()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render()
    path = tmp_path / "cpu.trace.json"
    prof.export_chrome_trace(str(path))
    monkeypatch.setattr(program_trace, "trace_path", lambda: str(path))
    frame = dict(kind="frame")
    rec = telemetry.last_frame(profiled=False)
    for p in PASSES:
        assert load_reader(p + "_device_ms")(frame) == 0.0
        host = load_reader(p + "_host_ms")(frame)
        want = [b - a for n, a, b in rec["spans"] if n == p]
        assert host == pytest.approx(want[0] * 1e-6) and host > 0.0
    assert load_reader("host_syncs_per_frame")(frame) == 0
    assert load_reader("host_wait_ms")(frame) > 0.0
    rays = sum(n for _, route, n in rec["batches"] if route == "stream")
    assert rays > 0 and rec["stream"]["pairs"] > 0
    assert load_reader("stream_pairs_per_ray.frame")(frame) == pytest.approx(
        rec["stream"]["pairs"] / rays)
    assert program_trace.load()["ranges"]["rt.frame"] == 1
