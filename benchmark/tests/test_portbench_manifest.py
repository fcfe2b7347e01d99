"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by its name."""

import json
import os
import re

import numpy as np
import pytest

from benchmark import inputs, run
from benchmark.tests.tiny import CELLS, bench_with_all_cells

ROOT = run.CHECKOUT
BENCH = run.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and names <= {
        "images_per_s", "latency_p80_s", "train_images_per_s", "setup_s"}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m
        for c in m["workloads"]:
            assert c in cells and c in e2e[m["moves"]], (m["name"], c)
        layers.setdefault(m["layer"], []).append(m["name"])
    for c in cells:
        assert c in e2e["setup_s"]
        assert sum(c in w for w in e2e.values()) >= 2
        assert any(c in m["workloads"] for m in BENCH["per_layer"])
        assert any(c in m["workloads"] and "mfu" in m["name"]
                   for m in BENCH["per_layer"])
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files_found_by_name(cell):
    w = run.cell_entry(bench_with_all_cells(BENCH), cell)
    assert len(w["why"]) <= 200
    cfg = inputs.load_json("configs", w["config"] + ".json")
    mix = inputs.load_json("traffic", w["traffic"] + ".json")
    assert mix["runner"] in ("serve_closed", "serve_open", "train_db")
    assert os.path.exists(os.path.join(ROOT, "benchmark", "limits",
                                       cell + ".json"))
    for m in run.cell_metrics(BENCH, cell, "per_layer"):
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
    assert cfg["name"] == w["config"]


@pytest.mark.parametrize("config", ["sd15", "sd21"])
def test_config_at_published_sizes(config):
    for entry in BENCH["configs"]:
        assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = inputs.load_json("configs", config + ".json")
    assert cfg["reduced"] == []
    counts = {m: sum(int(np.prod(s)) for _, s, _ in v)
              for m, v in inputs.model_shapes(cfg).items()}
    assert counts == cfg["parameters"]
    from benchmark import port
    port.port_configs(cfg)  # the port's objects agree with the file
