"""The program's own spans and counters, as the per-layer readers take
them: the ``rt.*`` ranges of the run's host-operation trace and the
port's in-memory record (``royaltracer_dx_tpu_torch.utils.telemetry``).

The trace is the newest ``benchmark_out/*.trace.json`` written after this
process started (the cell's ``_traced`` writes it just before the readers
run), parsed once.  From it:

* the device ms of the kernels launched inside each ``rt.*`` range, a
  kernel matched to its launch by correlation id, as ``profile.summarize``
  matches the prepare ranges (a kernel counts once for each range name it
  was launched inside: a pass's ms hold its traces and their prepare);
* the synchronising CUDA runtime calls (``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize``, ``cudaEventSynchronize``, synchronous
  ``cudaMemcpy``) made inside ``rt.frame``, and the ``rt.sync.*`` ranges
  there.

Where the program has no such range or record (a program without the
telemetry), every function returns None.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import time

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_CACHE: dict = {}


def _process_start() -> float:
    """This process's start on the wall clock (0 where /proc is absent,
    so that any trace is taken)."""
    from harness.main import process_age

    age = process_age()
    return time.time() - age if age > 0.0 else 0.0


def trace_path(out_dir: str | None = None) -> str | None:
    """The newest ``*.trace.json`` in ``out_dir`` (the harness's
    ``benchmark_out``) written after this process started."""
    if out_dir is None:
        from harness.cells import OUT_DIR

        out_dir = OUT_DIR
    start = _process_start()
    found = [(os.path.getmtime(p), p)
             for p in glob.glob(os.path.join(out_dir, "*.trace.json"))]
    found = [(t, p) for t, p in found if t >= start]
    return max(found)[1] if found else None


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(intervals, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= intervals[i][1]


def reduce(trace: dict) -> dict:
    """A Chrome trace (``traceEvents``; times in microseconds) reduced to
    dict(device_ms {range name: ms}, ranges {range name: count},
    frame_syncs {runtime call: count inside rt.frame}, frame_sync_spans
    (rt.sync.* ranges inside rt.frame))."""
    events = trace.get("traceEvents", trace)
    ranges: dict = {}
    for e in events:
        name = e.get("name", "")
        if (e.get("cat") == "user_annotation" and name.startswith("rt.")
                and "dur" in e):
            a = float(e["ts"])
            ranges.setdefault(name, []).append((a, a + float(e["dur"])))
    merged = {n: _union(v) for n, v in ranges.items()}
    starts = {n: [a for a, _ in v] for n, v in merged.items()}
    launches = {}
    for e in events:
        if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args",
                                                                     {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
    device_us = dict.fromkeys(merged, 0.0)
    for k in events:
        if k.get("cat") != "kernel" or "dur" not in k:
            continue
        t = launches.get(k.get("args", {}).get("correlation"))
        if t is None:
            continue
        for n in merged:
            if _inside(merged[n], starts[n], t):
                device_us[n] += float(k["dur"])
    frame = merged.get("rt.frame", [])
    fstarts = [a for a, _ in frame]
    syncs: dict = {}
    for e in events:
        if (e.get("cat") in _LAUNCH_CATS and e.get("name") in SYNC_CALLS
                and _inside(frame, fstarts, float(e["ts"]))):
            syncs[e["name"]] = syncs.get(e["name"], 0) + 1
    sync_spans = sum(1 for n, v in ranges.items() if n.startswith("rt.sync.")
                     for a, _ in v if _inside(frame, fstarts, a))
    return dict(device_ms={n: us * 1e-3 for n, us in device_us.items()},
                ranges={n: len(v) for n, v in ranges.items()},
                frame_syncs=syncs, frame_sync_spans=sync_spans)


def load(path: str | None = None) -> dict | None:
    """``reduce`` of the run's trace (or of ``path``), parsed once; None
    where there is no trace or it holds no ``rt.*`` range."""
    path = path or trace_path()
    if path is None or not os.path.exists(path):
        return None
    key = (path, os.path.getmtime(path))
    if key not in _CACHE:
        with open(path) as fh:
            _CACHE[key] = reduce(json.load(fh))
    out = _CACHE[key]
    return out if out["ranges"] else None


def range_device_ms(name: str, path: str | None = None) -> float | None:
    """Device ms of the kernels launched inside the ``rt.<name>`` ranges
    of the traced work; None where the trace has no such range."""
    t = load(path)
    if t is None or "rt." + name not in t["device_ms"]:
        return None
    return t["device_ms"]["rt." + name]


def frame_sync_calls(path: str | None = None) -> int | None:
    """The synchronising runtime calls inside ``rt.frame``; None where the
    trace has no frame range."""
    t = load(path)
    if t is None or "rt.frame" not in t["ranges"]:
        return None
    return sum(t["frame_syncs"].values())


def telemetry():
    """The port's telemetry module, or None where the program has none."""
    try:
        from royaltracer_dx_tpu_torch.utils import telemetry as tel
    except ImportError:
        return None
    return tel


def unprofiled_frame() -> dict | None:
    """The port's record of the last frame rendered without the profiler
    (the first frame of the traced work); None where there is none."""
    tel = telemetry()
    return tel.last_frame(profiled=False) if tel is not None else None


def span_host_ms(frame: dict | None, prefix: str) -> float | None:
    """The host ms of the spans of ``frame`` whose name is ``prefix`` or
    starts with ``prefix`` + ".", summed (0 where it has none); None
    where there is no frame."""
    if frame is None:
        return None
    return 1e-6 * sum(b - a for n, a, b in frame["spans"]
                      if n == prefix or n.startswith(prefix + "."))


def pairs_per_ray(record: dict | None, batches) -> float | None:
    """Ray-cluster pairs the stream kernels walked over the rays of the
    stream batches ``batches`` ((query, route, rays) triples)."""
    if record is None:
        return None
    rays = sum(r for _, route, r in batches if route == "stream")
    return record["stream"]["pairs"] / rays if rays else None
