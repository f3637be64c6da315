"""The system under test and its window: tpu_ecm_torch's ECMDriver, built
as a user's job builds it, driven batch by batch through run_batch.

BenchDriver is ECMDriver with the benchmark's hooks around the calls into
its layers: it keeps what the judge reads (each batch's stage-2 products
as the gcd harvest receives them, the stage-2 plan the batch replayed, the
stage-1 op counters at the end of stage 1) and, in a traced run, names
each host phase with a record_function span for the device trace.  It
changes no argument and no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import time
from typing import Dict, List, Optional

import torch

from tpu_ecm_torch import driver as ecm_driver
from tpu_ecm_torch.limbs import kernels as digit_kernels
from tpu_ecm_torch.parallel.mesh import Sharder

from . import devtrace

SIGMA_LO, SIGMA_HI = 6, 1 << 32


class BenchDriver(ecm_driver.ECMDriver):

    def __init__(self, cfg, spans: bool = False):
        super().__init__(cfg)
        self.spans = spans
        self.stage2_values: List[List[int]] = []
        self.plans: List[dict] = []
        self.stage1_marks: List[Dict[str, int]] = []

    def _span(self, name: str):
        if not self.spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function(devtrace.SPAN_PREFIX + name)

    def _build_curves(self, *a, **k):
        with self._span("build curves"):
            return super()._build_curves(*a, **k)

    def _init_state(self, *a, **k):
        with self._span("pack state"):
            return super()._init_state(*a, **k)

    def _extract_point(self, *a, **k):
        with self._span("read back"):
            return super()._extract_point(*a, **k)

    def _write_save(self, *a, **k):
        with self._span("savefile"):
            return super()._write_save(*a, **k)

    def _check_batch(self, vals, sigmas, stage, bound, base_idx):
        if stage == 1 and bound == self.cfg.b1:
            self.stage1_marks.append(dict(self.counters))
        elif stage == 2:
            self.stage2_values.append(list(vals))
        with self._span("gcd"):
            return super()._check_batch(vals, sigmas, stage, bound, base_idx)

    def _run_stage2(self, *a, **k):
        with self._span("stage 2"):
            return super()._run_stage2(*a, **k)

    def _iter_pairmaps(self, sp):
        chunks = []
        for item in super()._iter_pairmaps(sp):
            chunks.append((item[0], item[1], item[2]))
            yield item
        self.plans.append({"D": sp.D, "U": sp.U, "chunks": chunks})


def sigmas(seed: int, salt: int, count: int) -> List[int]:
    """count sigmas in [6, 2^32) drawn from (seed, salt)."""
    rng = random.Random(f"{seed}:{salt}")
    return [rng.randrange(SIGMA_LO, SIGMA_HI) for _ in range(count)]


def make_driver(n: int, b1: int, b2: int, device: str, devices: int,
                engine: str, tmp: str, spans: bool = False) -> BenchDriver:
    """The driver a user's job builds: engine "auto" unless the config
    names one, no probe cache kept, its files under tmp."""
    sharder = None
    if devices > 1:
        sharder = Sharder([f"{device}:{i}" if device == "cuda" else device
                           for i in range(devices)])
    cfg = ecm_driver.RunConfig(
        n=n, curves=1, b1=b1, b2=b2, device=device, engine=engine,
        cache_dir=None, sharder=sharder, verbose=0, stop_on_factor=False,
        save_b1_path=os.path.join(tmp, "save_b1.txt"),
        checkpoint_path=os.path.join(tmp, "checkpoint.txt"),
        results_path=os.path.join(tmp, "ecm_results.txt"))
    return BenchDriver(cfg, spans=spans)


def batch_width(drv: BenchDriver, override: Optional[int]) -> int:
    """Curves a batch: the engine's card batch on every card (as
    ECMDriver.run takes it), or the traffic's own on the CPU."""
    if override:
        return int(override)
    per = min(ecm_driver.card_batch(drv.engine, drv.ctx.p.nw, d)
              for d in drv.devices)
    return per * len(drv.devices)


def sync(drv: BenchDriver) -> None:
    for d in dict.fromkeys(drv.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    batches: List[dict] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    trace: Optional[devtrace.DeviceTrace] = None


def _launches() -> Dict[str, int]:
    return dict(digit_kernels.launches)


def run_window(drv: BenchDriver, seed: int, batch: int, seconds: float,
               trace: bool) -> Window:
    """Whole batches back to back: a batch starts only while the batches
    so far predict it ends within `seconds` (the first always runs).  The
    window's time runs from the first batch's start to the last's end,
    after a synchronise; everything a batch does is inside it."""
    win = Window()
    l0 = _launches()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    try:
        with drv._span("window"):
            t0 = time.perf_counter()
            while True:
                i = len(win.batches)
                sig = sigmas(seed, i, batch)
                c0 = dict(drv.counters)
                tb = time.perf_counter()
                with drv._span("batch"):
                    residues = drv.run_batch(sig, i * batch)
                sync(drv)
                te = time.perf_counter()
                win.batches.append({"sigmas": sig, "residues": residues,
                                    "counters_before": c0,
                                    "seconds": te - tb})
                if (te - t0) + (te - tb) > seconds:
                    break
            win.seconds = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    l1 = _launches()
    win.launches = {k: l1[k] - l0.get(k, 0) for k in l1}
    if prof is not None:
        win.trace = devtrace.read(prof, win.seconds, len(drv.devices))
    return win
