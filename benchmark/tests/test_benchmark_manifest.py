"""``BENCHMARK.json`` against the contract it is written to, and against
the files the harness finds by name: every configuration, traffic mix and
metric is a file of its own, so that a new one is a new file and a new
entry."""

from __future__ import annotations

import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])


def test_names_are_unique_and_plain():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_units_and_directions():
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    conf = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert conf["file"].startswith("benchmark/configs/")
    assert (harness.ROOT / conf["file"]).is_file()
    assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    cell = harness.cell(w["name"])
    assert cell["t"]["kind"] in ("serve", "train")
    assert cell["c"]["name"] == w["config"]


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_its_reader(m):
    assert callable(harness.reader(m["name"]))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(w["name"], MAN, False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert harness.metrics_of(w["name"], MAN, True), w["name"]


def test_per_layer_metrics_move_what_their_cells_report():
    for m in MAN["per_layer"]:
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        for cell in m.get("workloads", []):
            e2e = {x["name"] for x in harness.metrics_of(cell, MAN, False)}
            assert m["moves"] in e2e, (m["name"], cell)


def test_every_configuration_is_used_and_has_its_limits():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for conf in MAN["configs"]:
        c = harness.load_json(harness.ROOT / conf["file"])
        assert c["name"] == conf["name"]
        kinds = {harness.cell(w["name"])["t"]["kind"]
                 for w in MAN["workloads"] if w["config"] == conf["name"]}
        assert kinds <= set(c["limits"])
