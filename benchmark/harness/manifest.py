"""BENCHMARK.json and the files it names.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
harness finds everything by name:

* ``configs/<config>.json`` (the file the entry names), whose
  ``scene.kind`` is ``scenes/<kind>.py`` (``program(spec)`` and
  ``reference(spec, path)``);
* ``traffic/<traffic>.json``, whose ``kind`` is ``kinds/<kind>.py`` (a
  ``Cell`` class: set-up, window, traced work, check), and whose ray
  batches, where it has them, are ``rays/<rays>.py`` (``make``);
* ``limits/<workload>.json``;
* ``metrics/<metric>.py`` (a ``read(ctx)`` function) for each per-layer
  metric that lists the cell under its ``workloads``.

A new cell, configuration, scene kind, traffic mix or kind, ray kind or
metric is new files and new entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class ManifestError(RuntimeError):
    """A cell or a file it needs is missing or malformed."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file, with its name
    traffic: dict           # the traffic file, with its name
    limits: dict            # number compared -> limit
    end_to_end: list        # the entries of BENCHMARK.json this cell reports
    per_layer: list
    bench_dir: str = BENCH_DIR   # where its kinds and readers are found


def _load_json(path: str) -> dict:
    if not os.path.exists(path):
        raise ManifestError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as fh:
        return json.load(fh)


def load_manifest(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def resolve(workload: str, manifest: dict | None = None,
            bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``workload`` with its files read."""
    manifest = manifest if manifest is not None else load_manifest(
        os.path.dirname(bench_dir))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise ManifestError(f"unknown workload {workload!r} (have "
                            f"{sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    if w["config"] not in configs:
        raise ManifestError(f"{workload}: unknown config {w['config']!r}")
    entry = configs[w["config"]]
    config = _load_json(os.path.join(os.path.dirname(bench_dir),
                                      entry["file"]))
    config["name"] = entry["name"]
    for key in ("scene", "camera", "render", "triangles"):
        if key not in config:
            raise ManifestError(f"{entry['file']}: no {key!r}")
    plugin_path("scenes", config["scene"]["kind"], bench_dir)
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    traffic["name"] = w["traffic"]
    plugin_path("kinds", traffic["kind"], bench_dir)
    limits = _load_json(os.path.join(bench_dir, "limits",
                                      workload + ".json"))
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    for m in manifest["per_layer"]:
        if "workloads" not in m:
            raise ManifestError(f"per-layer metric {m['name']!r} lists no "
                                "workloads")
    per_layer = [m for m in manifest["per_layer"]
                 if workload in m["workloads"]]
    for m in per_layer:
        plugin_path("metrics", m["name"], bench_dir)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, bench_dir=bench_dir)


def plugin_path(folder: str, name: str, bench_dir: str = BENCH_DIR) -> str:
    path = os.path.join(bench_dir, folder, name + ".py")
    if not os.path.exists(path):
        raise ManifestError(f"missing {folder}/{name}.py")
    return path


def load_plugin(folder: str, name: str, bench_dir: str = BENCH_DIR):
    """The module ``<folder>/<name>.py`` (names may hold dots, so the file
    is loaded by its path)."""
    path = plugin_path(folder, name, bench_dir)
    tag = f"bench_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, bench_dir: str = BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return load_plugin("metrics", metric, bench_dir).read
