"""The cells on a CUDA card: each runs from the command line with a short
window, prints its result as the last line and is correct.  Skips
without a card.

    python -m pytest benchmark/tests/test_bench_card.py -q
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import manifest

WORKLOADS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 3 + trace), "--seconds", "2", "--trace",
         str(trace)], cwd=manifest.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    cell = manifest.resolve(workload)
    want = ({m["name"] for m in cell.per_layer} if trace else
            {m["name"] for m in cell.end_to_end})
    assert set(res["metrics"]) == want
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("with_program", [False, True])
def test_refuses_without_the_program_or_a_card(tmp_path, with_program):
    """In a directory that holds only BENCHMARK.json and benchmark/, or
    with no card visible, the command exits non-zero and prints
    nothing on standard output."""
    root = manifest.ROOT
    if with_program:
        cwd = root
    else:
        cwd = str(tmp_path)
        shutil.copytree(manifest.BENCH_DIR, os.path.join(cwd, "benchmark"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(root, "BENCHMARK.json"), cwd)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "menger-frame-1080p", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
