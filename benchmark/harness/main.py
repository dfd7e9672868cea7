"""One run of one cell: set-up, the measured window, the traced frame or
wavefront (``--trace 1``), the check against the plain reference, and the
result line."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "royaltracer_dx_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    the benchmark must not load, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def process_age() -> float:
    """Seconds since this process started, from /proc (0 where absent)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def card_info() -> dict:
    import torch

    p = torch.cuda.get_device_properties(0)
    info = dict(name=torch.cuda.get_device_name(0),
                sm_count=p.multi_processor_count,
                memory_bytes=p.total_memory)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
             "clocks.mem,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.splitlines()
        info["nvidia_smi"] = out[0].strip() if out else ""
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = "unavailable"
    return info


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             process_start: float | None = None) -> dict:
    """The result of one run (without printing), on ``device``."""
    import torch

    from harness import cells, check
    from harness.manifest import load_reader

    cuda = torch.device(device).type == "cuda"
    c = cells.make(cell, seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter() if process_start is None else process_start
    # the process started this long before ``start`` (the interpreter's
    # own start-up; 0 where /proc is absent)
    before = 0.0
    if process_start is not None:
        before = max(0.0, process_age() - (time.perf_counter() - start))
    imports = time.perf_counter() - start + before
    c.setup()
    if cuda:
        torch.cuda.synchronize()
    # the reference's own build, where set-up needed it for the inputs,
    # is not the program's set-up
    reference_s = c.reference_s
    setup_s = time.perf_counter() - start + before - reference_s
    e2e = c.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        # the card under the window's load: name, SMs, clocks, power limit
        print("card: " + json.dumps(card_info()), flush=True)
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=cell.chips, memory_peak_bytes=int(peak))
    metrics, breakdown, traced = {}, None, ""
    if trace:
        ctx = c.traced()
        for m in cell.per_layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        lean, s = ctx["lean"], ctx["summary"]
        dev.update(busy_s=lean["busy_s"], window_s=lean["window_s"])
        breakdown = dict(device_ops=[list(x) for x in lean["device_ops"]],
                         idle_gaps=[list(x) for x in s["idle_gaps"]])
        traced = (f"; traced: device window {lean['window_s']:.4f} s, busy "
                  f"{lean['busy_s']:.4f} s (CUDA activity alone), "
                  f"{s['window_s']:.4f} s and {s['busy_s']:.4f} s with "
                  "host operations")
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    c.free()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = c.check()
    correct, checks = check.verdict(numbers, cell.limits)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in c.setup_parts.items())
    print(f"timing: setup {setup_s:.3f} s (process start and imports "
          f"{imports:.3f}, {parts}; not counted: the reference's scene "
          f"{reference_s:.3f}), window {seconds:g} s, check "
          f"{time.perf_counter() - t0:.3f} s; {c.describe()}{traced}",
          file=sys.stderr)
    out = dict(correct=correct, attempted=c.attempted, failed=0,
               metrics=metrics, device=dev)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


class ForbiddenImport(RuntimeError):
    pass


def main(argv, process_start: float) -> int:
    from harness.manifest import ROOT

    os.environ.setdefault("USE_FLAX", "0")
    # build caches at fixed paths inside the checkout (the port keeps its
    # own nvcc builds in royaltracer_dx_tpu_torch/_build/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "benchmark_out",
                                                "cache", sub))
    args = _args(argv)
    from harness.manifest import ManifestError, resolve

    try:
        cell = resolve(args.workload)
    except ManifestError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    try:
        import royaltracer_dx_tpu_torch  # noqa: F401  (the program)
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA card visible; the benchmark runs only on "
              "the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          process_start=process_start)
    except ForbiddenImport as e:
        print(f"benchmark: forbidden modules loaded: {e.args[0]}",
              file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
