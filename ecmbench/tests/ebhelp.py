"""Shared set-up of the benchmark's tests: the import paths of a run
(the benchmark's folder and the checkout's root) and a cell small enough
for the CPU, where the port runs its kernels' plain versions."""

import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import runner, spec  # noqa: E402

# P35 * P36, the port's own small test number (chip_smoke.N71)
N71 = 34359738421 * 68719476767
SEED = (1 << 32) + 15


def tiny_cell(engine: str = "digit", devices: int = 1, batch: int = 4,
              n: int = N71, check: int = 4) -> spec.Cell:
    like = spec.find_cell(ROOT, "c124.b2x100" if devices == 1
                          else "c124.b2x100.x4")
    return spec.Cell(
        name="tiny", chips=devices, config={"n": str(n), "engine": engine},
        traffic={"b1": 200, "b2": 4000, "warm_b1": 50, "warm_b2": 500,
                 "devices": devices, "batch": batch, "check_curves": check},
        end_to_end=like.end_to_end, per_layer=like.per_layer)


def run_tiny(cell: spec.Cell, trace: bool = False, seed: int = SEED) -> dict:
    """One run of a tiny cell on the CPU, its window one batch; its
    metrics those of c124.b2x100 (one device) or of the x4 cell."""
    return runner.run(cell, seed, 0.01, trace, time.perf_counter(),
                      device="cpu", workers=1)
