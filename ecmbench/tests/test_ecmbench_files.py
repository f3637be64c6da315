"""Every configuration, cell, metric and kernel count that BENCHMARK.json
names is a file of its own, found by name, and the file keeps to the
benchmark's contract."""

import json
import os
import re
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ebhelp  # noqa: E402
from harness import spec  # noqa: E402

BENCH = spec.load_benchmark(ebhelp.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ecmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ebhelp.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = spec.find_cell(ebhelp.ROOT, cell)
    assert c.chips in (1, 4)
    assert int(c.config["n"]) > 1
    for key in ("b1", "b2", "warm_b1", "warm_b2", "devices",
                "check_curves"):
        assert key in c.traffic
    assert c.traffic["devices"] == c.chips
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) == 2
    assert {n.split(".")[0] for n in names} == {"curves_per_s", "setup_s"}
    moved = {m["moves"] for m in c.per_layer}
    assert c.per_layer and moved <= names


def test_configs():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
        assert c["file"].startswith("ecmbench/")
        with open(os.path.join(ebhelp.ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"]
        assert set(c["reduced"]) == set(data["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_found_by_name(metric):
    assert callable(spec.metric_reader(metric["name"]).read)
    assert set(metric["workloads"]) <= set(CELLS)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("kernel", ["K1", "K5", "K10", "K15"])
def test_kernel_count_found_by_name(kernel):
    k = spec.kernel_count(kernel)
    assert re.compile(k.PATTERN) and callable(k.bound_s)


def test_names_units_bounds():
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)
