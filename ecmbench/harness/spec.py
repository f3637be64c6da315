"""The benchmark's data, found by name.

BENCHMARK.json, at the root of the checkout, names every configuration,
cell and metric; each has a file of its own here:

  configs/<config>.json      the deployment: N, curve family, engine rule
  workloads/<cell>.json      the cell's traffic: bounds, devices, warm-up
                             bounds, curves the reference checks
  metrics/<metric>.py        a per-layer metric's reader: read(run)
  kernels/<K>.py             a kernel's work count for its roofline

A later cell, configuration, metric or kernel count is a new file and a
new entry; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: str, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration and
    traffic files, and the metrics it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "workloads", name + ".json")) as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def _load(path: str, modname: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CACHE: Dict[str, ModuleType] = {}


def metric_reader(name: str) -> ModuleType:
    """metrics/<name>.py, whose read(run) gives the metric or None."""
    key = "metric:" + name
    if key not in _CACHE:
        _CACHE[key] = _load(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                            "ecmbench_metric_" + name.replace(".", "_"))
    return _CACHE[key]


def kernel_count(name: str) -> ModuleType:
    """kernels/<name>.py: the kernel's PATTERN (its name in a device
    trace) and bound_s(run), the least seconds its window's work needs."""
    key = "kernel:" + name
    if key not in _CACHE:
        _CACHE[key] = _load(os.path.join(BENCH_DIR, "kernels", name + ".py"),
                            "ecmbench_kernel_" + name)
    return _CACHE[key]
