"""BENCHMARK.json against the benchmark's contract, and every file under
``bench/configs``, ``bench/cells`` and ``bench/metrics`` found by name."""

from __future__ import annotations

import re

import pytest

from conftest import ROOT

from bench import run as R

SPEC = R.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for e in SPEC["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= e["bound"] <= 0.25
    for p in SPEC["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert p["source"] in SOURCES
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    for x in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must():
    setup = next(e for e in SPEC["end_to_end"] if e["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for w in SPEC["workloads"]:
        e2e = [e["name"] for e in SPEC["end_to_end"] if R.applies(e, w["name"], SPEC)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [p for p in SPEC["per_layer"] if R.applies(p, w["name"], SPEC)]
        assert layer
        for p in layer:
            assert p["moves"] in e2e


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    entry, cell, config = R.cell_files(SPEC, w["name"])
    assert entry is w and config["name"] == w["config"]
    assert (ROOT / "bench" / "modes" / f"{cell['mode']}.py").is_file()
    assert cell["limits"]


def test_every_file_is_named():
    """Each file under configs, cells and metrics belongs to an entry, and
    each entry's file is there."""
    configs = {c["name"] for c in SPEC["configs"]}
    assert {p.stem for p in (ROOT / "bench" / "configs").glob("*.json")} == configs
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"bench/configs/{c['name']}.json"
    cells = {w["name"] for w in SPEC["workloads"]}
    assert {p.name[:-5] for p in (ROOT / "bench" / "cells").glob("*.json")} == cells
    metrics = {p["name"] for p in SPEC["per_layer"]}
    assert {p.name[:-3] for p in (ROOT / "bench" / "metrics").glob("*.py")} == metrics


@pytest.mark.parametrize("name", [p["name"] for p in SPEC["per_layer"]])
def test_metric_readers_load(name):
    assert callable(R.metric_reader(name).read)


def test_configs_hold_their_widths():
    for c in SPEC["configs"]:
        f = R.load_json(ROOT / c["file"])
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"] == []
        assert f["model"]["name"] == c["name"]
        assert f["source"] and f["reference"]
        assert (ROOT / "bench" / "reference" / f"{f['reference']}.py").is_file()
