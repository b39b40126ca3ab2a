"""BENCHMARK.json against the files the harness finds by name, and a cell
added as new files only."""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from azbench import harness
from azbench.tests import fixture

REPO = fixture.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fp:
        return json.load(fp)


def test_top_level_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["azbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in b[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for metric in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
    for metric in b["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    setup = [m for m in b["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    e2e = {m["name"] for m in b["end_to_end"]}
    for metric in b["per_layer"]:
        assert metric["moves"] in e2e
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]]
                         + [fixture.TRAIN_CELL["name"]])
def test_every_cell_resolves_to_its_files(cell):
    b = bench()
    b["workloads"].append(fixture.TRAIN_CELL)
    entry = harness._entry(b["workloads"], cell, "workload")
    config = harness._entry(b["configs"], entry["config"], "config")
    assert config["file"].startswith("azbench/configs/")
    with open(os.path.join(REPO, config["file"])) as fp:
        cfg = json.load(fp)
    assert os.path.isdir(os.path.join(REPO, cfg["weights"]))
    traffic = os.path.join(REPO, "azbench", "traffic",
                           entry["traffic"] + ".json")
    with open(traffic) as fp:
        driver = json.load(fp)["driver"]
    module = importlib.import_module(f"azbench.drivers.{driver}")
    for name in ("setup", "window", "check", "close"):
        assert callable(getattr(module, name))
    with open(os.path.join(REPO, "azbench", "limits", cell + ".json")) as fp:
        assert json.load(fp)
    if cell == fixture.TRAIN_CELL["name"]:
        return  # its metrics enter BENCHMARK.json with the cell
    reports = harness.cell_metrics(b, "end_to_end", cell)
    assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
    layers = harness.cell_metrics(b, "per_layer", cell)
    assert layers
    moved = {m["name"] for m in reports}
    for metric in layers:
        assert metric["moves"] in moved
        assert callable(harness.load_reader(REPO, metric["name"]))


def test_configurations_build_the_ports_config():
    from custom_alphazero_tpu_torch.config import from_json, validate

    for entry in bench()["configs"]:
        with open(os.path.join(REPO, entry["file"])) as fp:
            cfg = json.load(fp)
        assert cfg["name"] == entry["name"]
        assert cfg["reduced"] == entry["reduced"]
        validate(from_json(json.dumps(cfg["config"])))


NEW_METRIC = '''
def read(run):
    return run.values.get("positions", 0) / 2.0 or None
'''


def test_a_cell_added_as_new_files_runs(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files plus new entries in BENCHMARK.json, with no file edited."""
    root = fixture.tiny_root(str(tmp_path))
    bench_dir = os.path.join(root, "azbench")
    with open(os.path.join(bench_dir, "configs", "tiny-c4.json")) as fp:
        cfg = json.load(fp)
    cfg["name"] = "tiny-c4-wide"
    cfg["config"]["mcts"]["simulations"] = 6
    with open(os.path.join(bench_dir, "configs", "tiny-c4-wide.json"),
              "w") as fp:
        json.dump(cfg, fp)
    with open(os.path.join(bench_dir, "traffic", "selfplay_few.json"),
              "w") as fp:
        json.dump({"driver": "selfplay", "search_roots": 4}, fp)
    with open(os.path.join(bench_dir, "metrics", "fixture.half_positions.py"),
              "w") as fp:
        fp.write(NEW_METRIC)
    with open(os.path.join(bench_dir, "limits", "fixture-cell.json"),
              "w") as fp:
        json.dump({"selfplay_faults": 0, "ring_faults": 0,
                   "noise_mean_z": 6.0, "search_tv_mean": 0.01}, fp)
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        b = json.load(fp)
    b["configs"].append({"name": "tiny-c4-wide", "source": "test",
                         "file": "azbench/configs/tiny-c4-wide.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "fixture-cell", "config": "tiny-c4-wide",
                           "traffic": "selfplay_few", "chips": 1,
                           "why": "test"})
    b["end_to_end"][0]["workloads"].append("fixture-cell")
    b["per_layer"].append({"name": "fixture.half_positions", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "search",
                           "moves": "selfplay_positions_per_s",
                           "workloads": ["fixture-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(b, fp)
    out = harness.run_cell(root, "fixture-cell", seed=2**31 + 11,
                           seconds=0.5, trace=True, device="cpu")
    assert out["correct"], out["compared"]
    assert out["metrics"]["fixture.half_positions"]["value"] > 0
    assert list(out)[-1] == "compared"
