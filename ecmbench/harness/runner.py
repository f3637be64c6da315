"""One run of one cell: set-up, the window, the trace's reading, the
judge, and the result line.  run.py calls run() after its guards; the
tests call it on the CPU."""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

from . import judge, spec, window


class RunView:
    """What a per-layer metric reads (metrics/<name>.py): the window's
    program spans (ECMDriver.timings) and counters, its work, its kernel
    launches and, in a traced run, its device trace."""

    def __init__(self, drv, win, batch: int):
        self.engine = drv.engine
        p = drv.ctx.p
        self.nw, self.w = p.nw, p.w
        self.mersenne = ((drv.ctx.mersenne_e, drv.ctx.mersenne_c)
                         if drv.ctx.is_mersenne else None)
        self.K = drv.rhost.K if drv.engine == "rns" else None
        self.devices = len(drv.devices)
        self.batch = batch
        self.curves_per_device = batch // self.devices
        self.batches = len(win.batches)
        self.curves = batch * self.batches
        self.timings = dict(drv.timings)
        self.counters = dict(drv.counters)
        self.launches = win.launches
        self.trace = win.trace
        self.stage1_dups = self.stage1_adds = 0
        for b, mark in zip(win.batches, drv.stage1_marks):
            c0 = b["counters_before"]
            self.stage1_dups += mark.get("ptdups", 0) - c0.get("ptdups", 0)
            self.stage1_adds += mark.get("ptadds", 0) - c0.get("ptadds", 0)
        self.paired = self.counters.get("paired", 0)

    def roofline(self, kernel: Optional[str]) -> Optional[float]:
        """100 x the least time the window's work of `kernel` needs
        (kernels/<kernel>.py) over its device seconds; None without a
        trace or where the kernel did not run."""
        if kernel is None or self.trace is None:
            return None
        k = spec.kernel_count(kernel)
        secs = self.trace.seconds(k.PATTERN)
        if secs <= 0:
            return None
        return 100.0 * k.bound_s(self) / secs


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            t_start: float, device: str = "cuda") -> dict:
    """Set-up and the window of one run: a driver as a user's job builds
    it, the cell's shapes warmed on a small job of its own at the same
    batch, then whole batches; the program's state is freed before this
    returns what the judge and the metrics read."""
    cfg, tr = cell.config, cell.traffic
    n = int(cfg["n"])
    engine = cfg.get("engine", "auto")
    devices = int(tr.get("devices", 1))
    tmp = tempfile.mkdtemp(prefix="ecmbench_")
    try:
        warm = window.make_driver(n, tr["warm_b1"], tr["warm_b2"], device,
                                  devices, engine, tmp)
        batch = window.batch_width(warm, tr.get("batch"))
        warm.run_batch(window.sigmas(seed, "warm", batch), 0)
        window.sync(warm)
        del warm
        drv = window.make_driver(n, tr["b1"], tr["b2"], device, devices,
                                 engine, tmp, spans=trace)
        window.sync(drv)
        setup_s = time.perf_counter() - t_start
        win = window.run_window(drv, seed, batch, seconds, trace)
        peak = 0
        if device == "cuda":
            peak = max(torch.cuda.max_memory_allocated(d)
                       for d in dict.fromkeys(drv.devices))
        view = RunView(drv, win, batch)
        state = {"n": n, "seed": seed, "batch": batch, "devices": devices,
                 "setup_s": setup_s, "peak": peak, "win": win, "view": view,
                 "engine": drv.engine, "nw": drv.ctx.p.nw,
                 "stage2_values": drv.stage2_values, "plans": drv.plans,
                 "factors": list(drv.factors), "do_stage2": drv.do_stage2}
        del drv
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return state


def check(state: dict, cell: spec.Cell, controls=("",),
          workers: Optional[int] = None) -> Dict[str, tuple]:
    """{kind: (the numbers compared, sampled curves found wrong, curves
    checked)} of a measured run: kind "" judges the program's answers; a
    control kind ("stage1", "stage2") puts the reference with that
    guarantee broken (reference/ecm.py) in the program's place."""
    tr, n, win = cell.traffic, state["n"], state["win"]
    picks = judge.sample(state["seed"], len(win.batches), state["batch"],
                         state["devices"], int(tr["check_curves"]))
    answers = judge.program_answers(win, state["stage2_values"],
                                    state["plans"], state["factors"], picks)
    refs = judge.reference_answers(n, tr["b1"], answers, workers=workers)
    out = {}
    for kind in controls:
        got = answers
        if kind:
            got = judge.as_program(n, answers, judge.reference_answers(
                n, tr["b1"], answers, control=kind, workers=workers))
        numbers, wrong = judge.compare(n, tr["b1"], tr["b2"], win,
                                       state["stage2_values"],
                                       state["plans"], state["factors"],
                                       got, refs, state["do_stage2"])
        out[kind] = (numbers, wrong, len(picks))
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda",
        workers: Optional[int] = None) -> dict:
    """The result line's object of one run (run.py prints it), with the
    numbers compared under "checks", last."""
    state = measure(cell, seed, seconds, trace, t_start, device)
    win, view = state["win"], state["view"]
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"curves_per_s": view.curves / win.seconds,
                  "setup_s": state["setup_s"]}
        # a metric named <base>.<cells> (curves_per_s.x4) is <base> in
        # the cells it lists
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    t_ref = time.perf_counter()
    numbers, wrong, checked = check(state, cell, workers=workers)[""]
    t_ref = time.perf_counter() - t_ref
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": state["devices"], "memory_peak_bytes": int(state["peak"])}
    if win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
    out = {"correct": judge.correct(numbers), "attempted": view.curves,
           "failed": numbers["curves_missing"] + wrong,
           "metrics": metrics, "device": dev}
    if win.trace is not None:
        out["breakdown"] = win.trace.breakdown()
    out["info"] = {"engine": state["engine"], "nw": state["nw"],
                   "batch": state["batch"], "batches": len(win.batches),
                   "batch_s": [b["seconds"] for b in win.batches],
                   "window_s": win.seconds, "checked": checked,
                   "reference_s": t_ref}
    out["checks"] = {k: {"value": numbers[k], "limit": judge.LIMITS[k]}
                     for k in judge.LIMITS}
    return out


def jax_modules() -> list:
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared whole."""
    banned = {"jax", "jaxlib", "flax", "tpu_ecm"}
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & banned)
