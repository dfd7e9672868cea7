"""Helpers of the benchmark's tests."""

import copy
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cell(workload: str, config: str | None = None):
    """A cell of BENCHMARK.json cut to a size that the CPU runs in
    seconds: 64 x 48 pixels, 6-pixel check tiles, 2,000 diffuse rays, 256
    checked rays; ``config`` swaps in another configuration file."""
    from harness import manifest

    cell = manifest.resolve(workload)
    if config is not None:
        with open(os.path.join(BENCH, "configs", config + ".json")) as fh:
            cell.config = dict(json.load(fh), name=config)
    cell.config = copy.deepcopy(cell.config)
    cell.config["render"] = dict(cell.config["render"], width=64, height=48)
    cell.traffic = copy.deepcopy(cell.traffic)
    if cell.traffic["kind"] == "frames":
        cell.traffic.update(check_tile=6, check_grid=3)
    else:
        for b in cell.traffic["batches"]:
            if "count" in b:
                b["count"] = 2000
        cell.traffic["check_rays"] = 256
    return cell
