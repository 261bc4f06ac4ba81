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


#: ``model`` keys that hold a width, which no cut may change, besides every
#: key that ends in ``_dim`` or ``_rank``
WIDTHS = {"d_model", "d_ff", "d_state", "d_conv", "ssm_expand", "top_k"}


def config_faults(f: dict, entry: dict) -> list[str]:
    """What is wrong with configuration file ``f`` against its
    ``BENCHMARK.json`` entry: empty when nothing is. The file names its
    entry and its family's reference, has ``smoke`` widths over ``model``
    keys, and states its cuts: ``reduced`` as in the entry, each a ``model``
    key that is no width, and ``cut`` giving for each the published value,
    which the ``model`` value differs from, and one line on the deployment
    it stands for."""
    faults = []
    model, reduced, cut = f.get("model", {}), f.get("reduced"), f.get("cut") or {}
    if not f.get("name") == model.get("name") == entry["name"]:
        faults.append("the file and its model are not named as the entry")
    if not f.get("source") or not (
            ROOT / "bench" / "reference" / f"{f.get('reference')}.py").is_file():
        faults.append("no source, or no reference module of that name")
    if not f.get("smoke") or set(f["smoke"]) - set(model):
        faults.append("no smoke widths, or smoke keys that model lacks")
    if reduced != entry["reduced"]:
        faults.append(f"reduced {reduced} is not the entry's {entry['reduced']}")
    if set(cut) != set(reduced or ()):
        faults.append(f"cut names {sorted(cut)}, reduced {reduced}")
    for k in reduced or ():
        if k not in model:
            faults.append(f"reduced key {k} is not a model key")
        elif k in WIDTHS or k.endswith(("_dim", "_rank")):
            faults.append(f"reduced key {k} is a width")
        elif k in cut and cut[k].get("published") == model[k]:
            faults.append(f"{k} is cut to its published value {model[k]}")
        why = cut.get(k, {}).get("why")
        if k in cut and (not isinstance(why, str) or not why or "\n" in why):
            faults.append(f"cut {k} gives no one-line why")
    return faults


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_configs_hold_their_widths(c):
    assert config_faults(R.load_json(ROOT / c["file"]), c) == []


def cut_file() -> tuple[dict, dict]:
    """(a made-up file, its entry): yi-9b as the first of three pipeline
    stages, 16 of its 48 layers."""
    f = R.load_json(ROOT / "bench" / "configs" / "yi-9b.json")
    f["model"]["n_layers"] = 16
    f["reduced"] = ["n_layers"]
    f["cut"] = {"n_layers": {"published": 48, "why": "first of three pipeline stages"}}
    return f, {"name": "yi-9b", "reduced": ["n_layers"]}


def test_a_cut_configuration_passes():
    assert config_faults(*cut_file()) == []


def _same_as_published(f, entry):
    f["model"]["n_layers"] = 48


def _cut_lacks_a_key(f, entry):
    f["model"]["vocab_size"] = 8000
    f["reduced"] = entry["reduced"] = ["n_layers", "vocab_size"]


def _entry_differs(f, entry):
    entry["reduced"] = []


def _a_width(f, entry):
    f["model"]["d_ff"] = 5504
    f["reduced"] = entry["reduced"] = ["n_layers", "d_ff"]
    f["cut"]["d_ff"] = {"published": 11008, "why": "half the FFN"}


def _not_a_model_key(f, entry):
    f["reduced"] = entry["reduced"] = ["num_hidden_layers"]
    f["cut"] = {"num_hidden_layers": {"published": 48, "why": "first of three stages"}}


@pytest.mark.parametrize("spoil,fault", [
    (_same_as_published, "cut to its published value"),
    (_cut_lacks_a_key, "cut names"),
    (_entry_differs, "is not the entry's"),
    (_a_width, "is a width"),
    (_not_a_model_key, "is not a model key"),
], ids=["same_as_published", "cut_lacks_a_key", "entry_differs", "a_width",
        "not_a_model_key"])
def test_a_spoilt_cut_is_refused(spoil, fault):
    f, entry = cut_file()
    spoil(f, entry)
    assert any(fault in x for x in config_faults(f, entry)), config_faults(f, entry)
