"""BENCHMARK.json resolves to its files, keeps to the benchmark contract's
shape, and takes a new configuration, traffic mix, cell and per-layer
metric as new files and entries only."""

import json
import os
import re
import shutil

import pytest

from harness import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    return manifest.load_manifest()


@pytest.mark.parametrize("workload",
                         [w["name"] for w in _bench()["workloads"]])
def test_every_workload_resolves_to_its_files(workload):
    cell = manifest.resolve(workload)
    assert cell.chips == 1
    assert isinstance(manifest.load_plugin("kinds", cell.traffic["kind"]).Cell,
                      type)
    kind = manifest.load_plugin("scenes", cell.config["scene"]["kind"])
    assert callable(kind.program) and callable(kind.reference)
    for b in cell.traffic.get("batches", []):
        assert callable(manifest.load_plugin("rays", b["rays"]).make)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(manifest.load_reader(m["name"]))
        assert m["moves"] in names


def test_manifest_keeps_the_contract_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in b["workloads"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == configs
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = list(e2e)
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        names.append(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    assert len(names) == len(set(names))
    layers = {m["layer"] for m in b["per_layer"]}
    assert layers == {"renderer", "passes", "trace dispatch and worklists",
                      "kernels", "device"}
    assert len(json.dumps(b)) < 64 * 1024


def test_configs_carry_source_assumed_reduced():
    for c in _bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"] and cfg["source"]
        assert cfg["render"] == {"width": 1920, "height": 1080}


SCRATCH_SCENE = '''"""Scene kind tiny_sponge: a one-level sponge under the light."""


def program(config):
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    return menger_scene(1)[0], None


def reference(config, path):
    from reference import scene as rscene

    return rscene.menger(1)
'''

SCRATCH_KIND = '''"""Cell kind frames_again: the frames kind, found by name."""
import os

from harness.manifest import load_plugin

_frames = load_plugin("kinds", "frames",
                      os.path.dirname(os.path.dirname(__file__)))


class Cell(_frames.Cell):
    pass
'''


def test_a_later_cell_is_files_and_entries_only(tmp_path):
    """A scratch configuration (of a new scene kind, with a render key),
    traffic mix (of a new kind), cell and per-layer metric in a copy of the
    manifest and its folders resolve and run correct on the CPU, the
    render key on both sides, and the existing files stay as they are."""
    from harness import cells
    from harness.main import run_cell

    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    b = _bench()
    (bench / "scenes" / "tiny_sponge.py").write_text(SCRATCH_SCENE)
    (bench / "kinds" / "frames_again.py").write_text(SCRATCH_KIND)
    (bench / "configs" / "sponge_l1.json").write_text(json.dumps(dict(
        json.load(open(bench / "configs" / "menger_l2.json")),
        scene={"kind": "tiny_sponge"}, triangles=242,
        render={"width": 64, "height": 48, "gi_bounces": 1})))
    (bench / "traffic" / "static_frames_short.json").write_text(json.dumps(
        dict(json.load(open(bench / "traffic" / "static_frames.json")),
             kind="frames_again", warmup_frames=1, check_tile=6,
             check_grid=3)))
    (bench / "limits" / "sponge-frame.json").write_text(
        json.dumps({"off_pct.start": 1.0, "off_pct.last": 1.0}))
    (bench / "metrics" / "frames_seen.py").write_text(
        "def read(ctx):\n    return len(ctx.get('frame_ms') or []) or None\n")
    b["configs"].append(dict(name="sponge_l1", source="scratch",
                             file="benchmark/configs/sponge_l1.json",
                             reduced=[], why="scratch"))
    b["workloads"].append(dict(name="sponge-frame", config="sponge_l1",
                               traffic="static_frames_short", chips=1,
                               why="scratch"))
    b["end_to_end"][0]["workloads"].append("sponge-frame")
    b["per_layer"].append(dict(name="frames_seen", unit="count",
                               better="higher", source="host_clock",
                               layer="renderer", moves="frame_ms",
                               workloads=["sponge-frame"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = manifest.resolve("sponge-frame", bench_dir=str(bench))
    assert cell.traffic["warmup_frames"] == 1
    assert [m["name"] for m in cell.per_layer][-1] == "frames_seen"
    reader = manifest.load_reader("frames_seen", str(bench))
    assert reader({"frame_ms": [1.0, 2.0]}) == 2
    c = cells.make(cell, 7, "cpu")
    assert type(c).__module__.endswith("frames_again")
    res = run_cell(cell, 2**31 + 11, 0.1, False, device="cpu")
    assert res["correct"], res["checks"]
    assert c.reference()[2].gi_bounces == 1
    from harness import scenes
    assert scenes.program_config(cell.config).gi_bounces == 1
    for p, data in before.items():
        assert p.read_bytes() == data


def test_per_layer_metric_without_workloads_is_refused():
    b = _bench()
    b["per_layer"].append(dict(name="unlisted", unit="ms", better="lower",
                               source="host_clock", layer="renderer",
                               moves="frame_ms"))
    with pytest.raises(manifest.ManifestError):
        manifest.resolve(b["workloads"][0]["name"], manifest=b)


def test_unknown_workload_is_refused():
    with pytest.raises(manifest.ManifestError):
        manifest.resolve("no-such-cell")
