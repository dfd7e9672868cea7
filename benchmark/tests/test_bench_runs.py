"""Whole runs of the harness on the CPU at a small size (the look for a
card skipped): a sound run is correct; the timed path broken underneath
(a frame that leaves the state unchanged, half of every trace batch left
out, an answer altered where it is produced) and the control (the
reference in bfloat16 in the program's place) are not.  The import
check runs in a fresh process."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchsupport import small_cell
from harness import cells, check
from harness.main import run_cell

SEED = 2**31 + 4242


def _run(workload, config=None):
    return run_cell(small_cell(workload, config), SEED, 0.1, False,
                    device="cpu")


def _half_out(orig, miss):
    def fn(*a, **k):
        out = orig(*a, **k)
        return miss(out)
    return fn


@pytest.fixture
def broken(monkeypatch):
    """Install one fault in the port's timed path."""
    from royaltracer_dx_tpu_torch.ops import restir
    from royaltracer_dx_tpu_torch.ops.intersect import INF, Hit
    from royaltracer_dx_tpu_torch.render.restir_renderer import (
        RestirRenderer,
    )

    def install(kind):
        if kind == "state_unchanged":
            def render(self):
                self.frame += 1
                self.metrics = {}
            monkeypatch.setattr(RestirRenderer, "render", render)
            return

        def closest_miss(hit):
            n = hit.t.shape[0]
            k = torch.arange(n) >= n // 2 if kind == "half_out" else \
                torch.arange(n) % 10 == 3
            t = torch.where(k, INF if kind == "half_out" else hit.t * 1.01,
                            hit.t)
            return Hit(t=t, tri=hit.tri, u=hit.u, v=hit.v)

        def any_miss(occ):
            n = occ.shape[0]
            if kind == "half_out":
                return occ & (torch.arange(n) < n // 2)
            return occ ^ (torch.arange(n) % 10 == 3)

        monkeypatch.setattr(restir, "_closest_dispatch",
                            _half_out(restir._closest_dispatch, closest_miss))
        monkeypatch.setattr(restir, "_any_dispatch",
                            _half_out(restir._any_dispatch, any_miss))
    return install


CASES = [("menger-frame-1080p", None), ("sponza-trace-mix", "menger_l2")]


@pytest.mark.parametrize("workload,config", CASES)
def test_sound_run_is_correct(workload, config):
    res = _run(workload, config)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_out", "altered"])
def test_broken_frames_are_not_correct(broken, fault):
    broken(fault)
    res = _run("menger-frame-1080p")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["half_out", "altered"])
def test_broken_traces_are_not_correct(broken, fault):
    broken(fault)
    res = _run("sponza-trace-mix", "menger_l2")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload,config", CASES)
def test_control_fails_a_limit(workload, config):
    cell = small_cell(workload, config)
    c = cells.make(cell, SEED, "cpu")
    c.setup()
    c.window(0.1)
    c.free()
    correct, checks = check.verdict(c.check(control=True), cell.limits)
    assert not correct, checks


def test_no_jax_after_a_run():
    """A fresh process that runs the harness's CPU path holds no module
    whose top-level name is jax, jaxlib, flax or royaltracer_dx_tpu."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchsupport import small_cell\n"
        "from harness.main import run_cell, forbidden_modules\n"
        "r = run_cell(small_cell('sponza-trace-mix', 'menger_l2'), 3, 0.05,"
        " False, device='cpu')\n"
        "import json; print(json.dumps([r['correct'], forbidden_modules(),"
        " sorted({m.split('.')[0] for m in sys.modules})]))\n"
        % (here, os.path.dirname(here), os.path.dirname(os.path.dirname(here))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, bad, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and bad == []
    assert "royaltracer_dx_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "royaltracer_dx_tpu"} & set(tops)
