"""The harness end to end on the CPU at a tiny N and tiny bounds, and the
contract of its last line."""

import json
import os
import shutil
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ebhelp  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("engine", ["digit", "rns"])
def test_tiny_run_is_correct(engine):
    out = ebhelp.run_tiny(ebhelp.tiny_cell(engine))
    assert out["correct"] is True
    assert out["attempted"] == 4 and out["failed"] == 0
    assert set(out["metrics"]) == {"curves_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["info"]["engine"] == engine
    assert all(c["value"] == 0 for c in out["checks"].values())


def test_last_line_contract():
    out = ebhelp.run_tiny(ebhelp.tiny_cell(), trace=True)
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(out["device"])
    # the per-layer metrics a trace reads from program spans; the CPU has
    # no device trace, so its metrics are left out, never 0
    assert {"driver.build_s", "stage1.ns_per_curve_op",
            "stage2.ns_per_curve_pair"} <= set(out["metrics"])
    assert "kernel.stage1_roofline" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "ecmbench/run.py", "--workload",
                        "c124.b2x100", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=ebhelp.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_bare_checkout_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder has
    no program to run: a non-zero exit and no result."""
    shutil.copy(os.path.join(ebhelp.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(ebhelp.BENCH, tmp_path / "ecmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "ecmbench/run.py", "--workload",
                        "c124.b2x100", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_sample_takes_edges_and_every_card():
    from harness import judge
    picks = judge.sample(7, batches=3, batch=100, devices=4, count=8)
    assert (0, 0) in picks and (2, 99) in picks and len(picks) == 8
    for d in range(4):
        assert any(d * 25 <= col < (d + 1) * 25 for _b, col in picks)


@pytest.mark.cuda
def test_cell_on_card():
    """c124.b2x100 for a short window on the card: correct, on the GPU."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run([sys.executable, "ecmbench/run.py", "--workload",
                        "c124.b2x100", "--seed", str(ebhelp.SEED),
                        "--seconds", "5", "--trace", "0"], cwd=ebhelp.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


def test_trace_reading():
    """Device time is the union of the card's operations, the spans' own
    marks on the device left out; each stretch of an idle gap goes to the
    innermost span over it."""
    from torch.autograd import DeviceType
    from harness import devtrace

    class Ev:
        def __init__(self, name, a, b, kind):
            self.name, self.device_type, self.device_index = name, kind, 0
            self.time_range = type("T", (), {"start": a, "end": b})()

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [Ev("ecmbench:window", 0, 100, cpu),
              Ev("ecmbench:batch", 0, 60, cpu),
              Ev("ecmbench:build curves", 0, 10, cpu),
              Ev("ecmbench:stage 2", 40, 60, cpu),
              Ev("ecmbench:batch", 0, 60, gpu),
              Ev("k1", 10, 40, gpu), Ev("k5", 45, 55, gpu),
              Ev("k1", 70, 90, gpu)]
    prof = type("P", (), {"events": lambda self: events})()
    t = devtrace.read(prof, 100e-6, 1)
    assert t.busy_s == pytest.approx(60e-6)
    assert t.kernels == {"k1": (2, pytest.approx(50e-6)),
                         "k5": (1, pytest.approx(10e-6))}
    assert t.idle_gaps == {"build curves": pytest.approx(10e-6),
                           "stage 2": pytest.approx(10e-6),
                           "between batches": pytest.approx(20e-6)}
    assert t.seconds(r"^k1$") == pytest.approx(50e-6)
