"""Every file that BENCHMARK.json names loads, and the file keeps to the
benchmark's contract: its keys, names, units and bounds; every
configuration used and stated; every metric read by a reader of its own and
reported where it says."""

import json
import re

import pytest
from conftest import BENCH, CELLS, ROOT

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|per_tok|mlp")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:1] == ["python3"] and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_text():
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in every:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(entry):
    assert entry["file"].startswith("portbench/configs/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for key in entry["reduced"]:
        assert not WIDTH.search(key), key
        assert cfg["published"][key] != cfg[key]
    for key, value in cfg.get("published", {}).items():
        assert key in entry["reduced"] or cfg[key] == value


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_and_reports(name):
    cell = spec.load_cell(name, BENCH)
    assert cell.kind.run and cell.model.forward
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_and_cells(metric):
    assert callable(spec.metric_reader(metric["name"]))
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        reported = {m["name"] for m in spec.load_cell(cell, BENCH).end_to_end}
        assert metric["moves"] in reported


@pytest.mark.parametrize("name", CELLS)
def test_mix_states_only_what_the_run_takes(name):
    # the program's row Adagrad takes a rate and an epsilon, and starts its
    # accumulators at a value of its own (reference.ADAGRAD_INIT)
    mix = spec.load_cell(name, BENCH).mix
    if "optimizer" in mix:
        assert set(mix["optimizer"]["embed"]) == {"name", "lr", "eps"}
