"""Readings that the limits of ``limits/<workload>.json`` are set from: for
each seed, one short run of the cell (set-up, a window of ``--seconds``,
the check of the program against the reference) and, on the first
``--control-seeds`` seeds, the control (the reference with every trace in
bfloat16, in the program's place) on the same pixels or rays.  Card only;
not run by the benchmark's own runs.

    python benchmark/control.py --workload sponza-frame-1080p \\
        --seeds 11 12 13 --control-seeds 3 --seconds 3 --out readings.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_BENCH, os.path.dirname(_BENCH)]


def readings(cell, seeds, control_seeds: int, seconds: float,
             device="cuda") -> list:
    import torch

    from harness import cells

    rows, ref = [], None
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        c = cells.make(cell, seed, device)
        c._ref = ref
        c.setup()
        c.window(seconds)
        c.free()
        if device != "cpu":
            torch.cuda.empty_cache()
        row = dict(seed=seed, program=c.check())
        ref = c._ref
        if i < control_seeds:
            row["control"] = c.check(control=True)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from harness.manifest import resolve

    if not torch.cuda.is_available():
        print("control: no CUDA card visible", file=sys.stderr)
        return 2
    cell = resolve(args.workload)
    rows = readings(cell, args.seeds, args.control_seeds, args.seconds)
    summary = {}
    for side in ("program", "control"):
        for r in rows:
            for k, v in r.get(side, {}).items():
                summary.setdefault(f"{side}.{k}", []).append(v)
    out = dict(workload=args.workload, rows=rows,
               lower={k[8:]: max(v) for k, v in summary.items()
                      if k.startswith("program.")},
               upper={k[8:]: min(v) for k, v in summary.items()
                      if k.startswith("control.")},
               limits=cell.limits)
    print(json.dumps({k: out[k] for k in ("workload", "lower", "upper",
                                          "limits")}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
