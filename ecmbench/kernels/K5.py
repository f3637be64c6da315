"""K5, the digit engine's stage-2 stream replay (tpu_ecm_torch/csrc/
replay.cu): its name in a device trace and the least time the window's
replay needs.

One product (acc *= Pa - Pb) a live entry of the plan a curve; pads are
not counted.  The product's multiply-adds are K1's (frozen from
chip_smoke.py's _product_macs).  Bytes: each launch reads
and writes acc, nw int32 digits a curve, and reads its entries' indices,
4 bytes an entry; the Pa and Pb rows an entry names are left out, which
can only lower the bound (the operations bound it by two orders).
"""

import importlib.util
import os

from harness import peaks

_spec = importlib.util.spec_from_file_location(
    "ecmbench_kernel_K1_for_K5",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "K1.py"))
K1 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(K1)

PATTERN = r"(?<![A-Za-z0-9_])replay_lanes_kernel"
LAUNCHES = "replay"


def bound_s(run) -> float:
    macs = (run.batch * run.paired
            * K1.product_macs(run.nw, False, run.mersenne, run.w))
    nbytes = (run.launches.get(LAUNCHES, 0) * 2 * run.nw * 4
              * run.curves_per_device + 4 * run.paired * run.devices)
    return peaks.bound_s(macs / peaks.IMAD_PER_S, nbytes)
