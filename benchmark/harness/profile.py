"""One traced frame or wavefront under ``torch.profiler``, and the
reduction of its Chrome trace to what the per-layer readers take.

The traced work runs inside a ``record_function`` range ``bench.window``;
that range's host interval is the traced window, or, in a trace of CUDA
activity alone, the device's span between two marker memsets.  From the
trace:

* device activity: every ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
  event; ``busy_s`` is the length of their union inside the window;
* kernels by name (device seconds, launch count);
* the trace kernels (``TRACE_KERNEL``: the stream and brute-force
  kernels, their list and relist kernels included);
* the kernels launched from inside a ``bench.prepare`` range (worklists
  and presort), matched through the launch's correlation id;
* the idle gaps of the window, each named by the innermost host operation
  running at its midpoint.
"""

from __future__ import annotations

import bisect
import json
import os
import re

import torch

from harness.spans import PREPARE_RANGE

WINDOW_RANGE = "bench.window"
TRACE_KERNEL = re.compile(r"\b(stream_kernel|brute_\w*kernel)\b")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def run_traced(fn, path: str, host: bool = True):
    """Run ``fn()`` under the profiler, write the Chrome trace to ``path``
    and return fn's result.  With ``host`` the profiler records the host's
    operations too (CPU and CUDA activity; the window is the
    ``bench.window`` range), else CUDA activity alone, which slows the
    host least: a one-element memset just before and just after ``fn``
    then bounds the window on the device (``summarize(window="device")``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        mark = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if cuda and not host:
            mark.zero_()
        with record_function(WINDOW_RANGE):
            out = fn()
        if cuda:
            if not host:
                mark.zero_()
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return out


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def summarize(trace: dict, window: str = "range") -> dict:
    """The traced window's numbers from a Chrome trace (``traceEvents``;
    times in microseconds).  The window is the ``bench.window`` range
    (``window="range"``) or the span from the first device operation's
    start to the last one's end (``"device"``)."""
    events = trace.get("traceEvents", trace)
    device = [e for e in events if e.get("cat") in _DEVICE_CATS
              and "ts" in e and "dur" in e]
    if window == "device":
        if not device:
            raise ValueError("no device operation in the trace")
        w0 = min(float(e["ts"]) for e in device)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in device)
    else:
        ranges = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == WINDOW_RANGE]
        if not ranges:
            raise ValueError(f"no {WINDOW_RANGE} range in the trace")
        w0 = float(ranges[0]["ts"])
        w1 = w0 + float(ranges[0]["dur"])
    kernels = [e for e in device if e["cat"] == "kernel"
               and w0 <= float(e["ts"]) < w1]
    launches = {}
    for e in events:
        if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
    prep = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == PREPARE_RANGE)
    starts = [a for a, _ in prep]

    def in_prepare(k) -> bool:
        t = launches.get(k.get("args", {}).get("correlation"))
        if t is None:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= prep[i][1]

    by_name: dict = {}
    trace_us = prep_us = total_us = 0.0
    for k in kernels:
        dur = float(k["dur"])
        total_us += dur
        name = _short(k["name"])
        s, c = by_name.get(name, (0.0, 0))
        by_name[name] = (s + dur, c + 1)
        if TRACE_KERNEL.search(k["name"]):
            trace_us += dur
        elif in_prepare(k):
            prep_us += dur
    for e in device:
        if e["cat"] != "kernel" and w0 <= float(e["ts"]) < w1:
            name = e["cat"] + ":" + _short(e.get("name", ""))
            s, c = by_name.get(name, (0.0, 0))
            by_name[name] = (s + float(e["dur"]), c + 1)

    busy = _union((max(float(e["ts"]), w0),
                   min(float(e["ts"]) + float(e["dur"]), w1))
                  for e in device
                  if float(e["ts"]) < w1
                  and float(e["ts"]) + float(e["dur"]) > w0)
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != WINDOW_RANGE and "dur" in e]
    host.sort()
    hstarts = [h[0] for h in host]
    by_gap: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        best = None
        i = bisect.bisect_right(hstarts, mid)
        # the innermost host operation spanning the midpoint: the latest
        # started one that has not ended (nested ranges; 64 looked at)
        for j in range(i - 1, max(-1, i - 65), -1):
            s, t, n = host[j]
            if s <= mid <= t:
                best = (s, t, n)
                break
        label = ("host:" + _short(best[2]) if best
                 else "host:(between operations)")
        by_gap[label] = by_gap.get(label, 0.0) + (b - a)
    return dict(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
        kernel_s=total_us * 1e-6, launches=len(kernels),
        trace_kernel_s=trace_us * 1e-6, prepare_kernel_s=prep_us * 1e-6,
        device_ops=sorted(((n, s * 1e-6) for n, (s, _) in by_name.items()),
                          key=lambda x: -x[1])[:10],
        idle_gaps=sorted(((n, s * 1e-6) for n, s in by_gap.items()),
                         key=lambda x: -x[1])[:10])


def load_summary(path: str, window: str = "range") -> dict:
    with open(path) as fh:
        return summarize(json.load(fh), window)
