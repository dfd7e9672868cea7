"""What every kind of cell shares, and the look-up of a cell's kind.

A traffic file's ``kind`` is the file ``kinds/<kind>.py``, whose ``Cell``
(a ``BaseCell``) has ``setup()`` (the program's scene, its structures,
the inputs, and warm-up of every shape the window uses), ``window(seconds)``
(the measured loop; returns the end-to-end numbers), ``traced()`` (after
the window, the traced work; the context for the per-layer readers),
``free()``, ``check(control=False)`` (the comparison with the plain
reference; with ``control`` the reference in bfloat16 stands in the
program's place), ``attempted`` and ``describe()``.
"""

from __future__ import annotations

import os
import time

import torch

from harness import profile, scenes, spans, yardstick
from harness.manifest import ROOT, load_plugin

OUT_DIR = os.path.join(ROOT, "benchmark_out")


class BaseCell:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.path = None
        self._ref = None
        # seconds spent building the reference (not the program's set-up)
        self.reference_s = 0.0
        self.setup_parts = {}

    def reference(self):
        """(SceneArrays, camera arrays, RenderConfig) of the reference,
        built once."""
        if self._ref is None:
            t0 = time.perf_counter()
            self._ref = scenes.reference_scene(self.cell.config, self.path,
                                               self.device,
                                               self.cell.bench_dir)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.reference_s += time.perf_counter() - t0
        return self._ref

    def _traced(self, fn) -> dict:
        """Three more frames or wavefronts after the window: one with the
        spans alone (the prepare events, the batches for the yardstick);
        one under the profiler with CUDA activity alone (the device's busy
        and idle time, with the least host overhead); one under the
        profiler with host operations too (launches, the spans' kernels,
        the idle gaps named by what the host was doing)."""
        sp = spans.TraceSpans().install()
        try:
            fn()
            prepare_ms = sp.prepare_ms()
        finally:
            sp.remove()
        lean_path = os.path.join(OUT_DIR, f"{self.cell.name}.lean.json")
        profile.run_traced(fn, lean_path, host=False)
        lean = profile.load_summary(lean_path, window="device")
        ranges = spans.TraceSpans().install()
        path = os.path.join(OUT_DIR, f"{self.cell.name}.trace.json")
        try:
            profile.run_traced(fn, path)
        finally:
            ranges.remove()
        summary = profile.load_summary(path)
        least = yardstick.least_seconds(
            yardstick.build(self.reference()[0].tri_verts), sp.batches,
            self.seed)
        return dict(summary=summary, lean=lean, prepare_ms=prepare_ms,
                    least_s=least)


def make(cell, seed: int, device="cuda") -> BaseCell:
    kind = load_plugin("kinds", cell.traffic["kind"], cell.bench_dir)
    return kind.Cell(cell, seed, device)
