"""The benchmark's files keep to its format: BENCHMARK.json's keys, names,
units and bounds; every cell, configuration, driver and per-layer metric is a
file found by its name; each per-layer metric moves an end-to-end metric
that every cell it lists reports."""

import json
import os
import re

import pytest

from portbench import harness as H

BENCH = H.load_json(H.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert LINE.match(entry[key]), (entry["name"], key)
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    w, e2e, layer = H.cell_spec(BENCH, cell)
    wl = H.load_json(H.HERE, "workloads", f"{cell}.json")
    assert os.path.exists(os.path.join(H.HERE, "drivers", f"{wl['driver']}.py"))
    cfg = H.load_json(H.HERE, "configs", f"{w['config']}.json")
    assert set(cfg["reduced"]) <= set(cfg)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())
    if "views" in wl:
        table = H.load_json(H.HERE, "traffic", f"{wl['views']}.json")
        assert table["image"] == [480, 640] and table["pairs"]
        for row in table["pairs"]:
            assert len(row["K"]) == 9 and len(row["ext1"]) == len(row["ext2"]) == 16
            assert all(w is None or (len(w) == 4 and w[0] <= w[2] and w[1] <= w[3])
                       for w in (row["win1"], row["win2"]))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_file_and_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert callable(H.load_module("metrics", metric).read)
    for cell in m.get("workloads", CELLS):
        _, e2e, layer = H.cell_spec(BENCH, cell)
        assert m["moves"] in {x["name"] for x in e2e}, (metric, cell)
        assert metric in {x["name"] for x in layer}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_file(config):
    c = next(x for x in BENCH["configs"] if x["name"] == config)
    assert c["file"] == f"portbench/configs/{config}.json"
    data = H.load_json(H.ROOT, c["file"])
    assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
    assert any(w["config"] == config for w in BENCH["workloads"])
