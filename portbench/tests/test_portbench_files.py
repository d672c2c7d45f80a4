"""Every data file of the benchmark loads, names what it should, and keeps
to the contract's characters, units and cross-references."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def test_benchmark_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units_use_the_allowed_characters(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_from_its_files(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    c = harness.load_cell(cell)
    assert (c.config_name, c.traffic_name, c.chips) == (
        w["config"], w["traffic"], w["chips"])
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert (harness.HERE / "drivers" / f"{c.driver}.py").is_file()
    conf = next(x for x in SPEC["configs"] if x["name"] == w["config"])
    assert conf["file"] == f"portbench/configs/{w['config']}.json"
    assert c.config["name"] == conf["name"]
    assert sorted(c.config["reduced"]) == sorted(conf["reduced"])
    assert (harness.HERE / c.config["reference"]).is_file()
    assert c.limits and all(v >= 0 for v in c.limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in harness.metrics_for(SPEC, "end_to_end", cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(SPEC, "per_layer", cell)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_layer_metric_has_a_reader_and_its_cells_report_what_it_moves(
        metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    assert callable(harness.load_module("metrics", metric).read)
    assert m["moves"] in E2E
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        e2e = {x["name"] for x in harness.metrics_for(SPEC, "end_to_end",
                                                      cell)}
        assert m["moves"] in e2e, (metric, cell)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)


def test_scoring_lengths_are_the_mix_own_and_cover_its_lengths():
    from portbench import generate

    mix = harness.load_cell("qwen3-14b-score").traffic
    draw = generate.prompt_lengths(mix["lengths"], int(mix["prompts"]),
                                   int(mix["length_seed"]))
    assert draw == generate.prompt_lengths(mix["lengths"],
                                           int(mix["prompts"]),
                                           int(mix["length_seed"]))
    assert set(draw) == set(mix["lengths"])
    assert len(draw) == int(mix["prompts"])
