"""The benchmark of the port (royaltracer_dx_tpu_torch) on one CUDA card.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The cell is read from BENCHMARK.json at
the checkout's root; its configuration, traffic mix, limits and per-layer
metric readers are the files of those names under benchmark/.  The last
line of standard output is one JSON object (correct, attempted, failed,
metrics, device[, breakdown], checks); the numbers compared, each with
its limit, are also the last lines of standard error.  Exits 2 without a
result where the card or the cell's files are missing.
"""

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_BENCH, os.path.dirname(_BENCH)]   # the harness, the port

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], PROCESS_START))
