#!/usr/bin/env python3
"""The host's span tree of benchmark cells, and what the span log costs.

For each cell of BENCHMARK.json (--cells), a driver built as the
benchmark builds it (ecmbench/harness/window.py: the cell's N, bounds,
engine rule and card batch, its sigmas drawn from --seed) runs one warm
batch at the cell's warm bounds, then --batches pairs of batches at the
cell's bounds on two drivers, one with RunConfig.span_log off and one
with it on, in turns (off, on, on, off, ...; both sides of a pair on the
same sigmas).  Prints, per cell:

  - each key's time a batch (ECMDriver.timings over the batches) and its
    self time a batch (its spans less their children's, from the span
    log of the logged driver); the self time of `batch` is what no key
    covers;
  - the median seconds a batch with the log off and on;
  - the recorder's own cost: microseconds a span with the log off and on,
    timed over --spans empty spans on this host.

One JSON object a cell goes to --out (default build/span_tree.json).
Runs on the card ("cuda", every card of the
cell) or, to rehearse, on the CPU at the sizes given by --cpu-batch and
--bounds (warm bounds 50 and 500).

    python3 tools/span_tree_card.py --cells c124.b2x100,c351.b2x100
    python3 tools/span_tree_card.py --device cpu --cells c124.b2x100 \\
        --cpu-batch 4 --bounds 200 4000 --batches 1
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "ecmbench"))


def self_times(log) -> dict:
    """{key: seconds} of each key's spans less their children's."""
    out = {}
    for key, _p, a, b in log:
        out[key] = out.get(key, 0.0) + (b - a) / 1e9
    for _k, parent, a, b in log:
        if parent is not None:
            out[parent] -= (b - a) / 1e9
    return out


def recorder_cost(count: int) -> dict:
    """Microseconds a span of the recorder, log off and on."""
    from tpu_ecm_torch.utils.spans import SpanRecorder
    res = {}
    for name, log in (("off", False), ("on", True)):
        rec = SpanRecorder(log=log)
        t0 = time.perf_counter()
        for _ in range(count):
            with rec.span("k"):
                pass
        res[name] = (time.perf_counter() - t0) / count * 1e6
    return res


def run_cell(name: str, args) -> dict:
    from harness import spec, window
    from tpu_ecm_torch import driver as ecm_driver
    from tpu_ecm_torch.parallel.mesh import Sharder

    cell = spec.find_cell(REPO, name)
    cfg, tr = cell.config, dict(cell.traffic)
    if args.device == "cpu":
        tr.update(b1=args.bounds[0], b2=args.bounds[1], warm_b1=50,
                  warm_b2=500, batch=args.cpu_batch)
    devices = int(tr.get("devices", 1))
    tmp = tempfile.mkdtemp(prefix="span_tree_")

    def make(b1, b2, log):
        sharder = None
        if devices > 1:
            sharder = Sharder([f"cuda:{i}" if args.device == "cuda"
                               else "cpu" for i in range(devices)])
        return ecm_driver.ECMDriver(ecm_driver.RunConfig(
            n=int(cfg["n"]), curves=1, b1=b1, b2=b2, device=args.device,
            engine=cfg.get("engine", "auto"), cache_dir=None,
            sharder=sharder, verbose=0, stop_on_factor=False,
            span_log=log, save_b1_path=os.path.join(tmp, "save_b1.txt"),
            checkpoint_path=os.path.join(tmp, "checkpoint.txt"),
            results_path=os.path.join(tmp, "ecm_results.txt")))

    warm = make(tr["warm_b1"], tr["warm_b2"], False)
    batch = window.batch_width(warm, tr.get("batch"))
    warm.run_batch(window.sigmas(args.seed, "warm", batch), 0)
    window.sync(warm)
    del warm
    drv = {False: make(tr["b1"], tr["b2"], False),
           True: make(tr["b1"], tr["b2"], True)}
    secs = {False: [], True: []}
    for i in range(args.batches):
        sig = window.sigmas(args.seed, i, batch)
        for log in ((False, True) if i % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            drv[log].run_batch(sig, i * batch)
            window.sync(drv[log])
            secs[log].append(time.perf_counter() - t0)
    on = drv[True]
    n = args.batches
    return {
        "cell": name, "engine": on.engine, "batch": batch, "batches": n,
        "per_batch": {k: v / n for k, v in on.timings.items()},
        "self_per_batch": {k: v / n for k, v in
                           self_times(on.span_log).items()},
        "spans_per_batch": len(on.span_log) / n,
        "numinv_per_batch": on.counters.get("numinv", 0) / n,
        "batch_s_off": secs[False], "batch_s_on": secs[True],
        "median_off": statistics.median(secs[False]),
        "median_on": statistics.median(secs[True]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="c124.b2x100,c351.b2x100,c124.b2gmp")
    ap.add_argument("--seed", type=int, default=(1 << 32) + 26)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--spans", type=int, default=200_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cpu-batch", type=int, default=4)
    ap.add_argument("--bounds", type=int, nargs=2, default=(200, 4000))
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "span_tree.json"))
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no card: torch.cuda.is_available() is False")
        return 1
    head = {"device": (torch.cuda.get_device_name(0)
                       if args.device == "cuda" else "cpu"),
            "recorder_us": recorder_cost(args.spans)}
    print(json.dumps(head))
    cells = []
    for name in args.cells.split(","):
        r = run_cell(name, args)
        cells.append(r)
        print(f"{name}: {r['batches']} x {r['batch']} curves, median "
              f"{r['median_off']:.4f} s a batch with the log off, "
              f"{r['median_on']:.4f} on; {r['spans_per_batch']:.0f} spans "
              f"a batch")
        for k in sorted(r["per_batch"], key=lambda k: -r["per_batch"][k]):
            print(f"  {k:18s} {r['per_batch'][k]:10.4f} s/batch, self "
                  f"{r['self_per_batch'].get(k, 0.0):10.4f}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({**head, "cells": cells}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
