"""K15, the RNS engine's stage-2 stream replay (tpu_ecm_torch/csrc/
rns_replay.cu): its name in a device trace and the least time the
window's replay needs.

One RNS product a live entry of the plan a curve, counted as K10 counts
one (frozen from chip_smoke.py's _rns_bound).  Bytes: each
launch reads and writes acc, 2K + 1 int32 residues a curve, and reads its
entries, 4 bytes each; the Pa and Pb rows are left out, which can only
lower the bound.
"""

import importlib.util
import os

from harness import peaks

_spec = importlib.util.spec_from_file_location(
    "ecmbench_kernel_K10_for_K15",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "K10.py"))
K10 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(K10)

PATTERN = r"(?<![A-Za-z0-9_])rns_replay_kernel"
LAUNCHES = "rns_replay"


def bound_s(run) -> float:
    rows = 2 * run.K + 1
    nbytes = (run.launches.get(LAUNCHES, 0) * 2 * rows * 4
              * run.curves_per_device + 4 * run.paired * run.devices)
    return peaks.bound_s(K10.products_s(run.K, run.batch * run.paired),
                         nbytes)
