"""K10, the RNS engine's stage-1 tape (tpu_ecm_torch/csrc/rns_tape.cu):
its name in a device trace and the least time the window's stage-1 work
needs.

Frozen from chip_smoke.py's _rns_bound and _tape_products:
a DUP is 5 RNS products, an ADD 6; an RNS product at K channels a base is
two base-extension dots of K x (K+1) multiply-adds, run as exact u8
splits (four int8 products a multiply-add) at the int8 tensor peak, and
beside them 7K + 4 modular channel products of three int32 multiply-adds
each at the int32 peak; the larger of the two.  The count follows today's
algorithm (u8 splits of the dots, limbs/rns.py's mont_mul); another split
or another base extension makes it stale, and PERF.md says so.  Bytes:
each launch reads and writes slot 0's (X, Z) planes and reads the curve
constant, 2K + 1 int32 residues a curve each, and each device reads the
tape once, 20 bytes an op.
"""

from harness import peaks

PATTERN = r"(?<![A-Za-z0-9_])rns_tape_kernel"
LAUNCHES = "rns_tape"


def products_s(K: int, products: float) -> float:
    """Seconds `products` RNS products (one curve each) take at the
    card's peaks."""
    t_dots = products * 2 * K * (K + 1) * 4 * 2 / peaks.TENSOR_INT8_OPS_PER_S
    t_chan = products * 3 * (7 * K + 4) / peaks.IMAD_PER_S
    return max(t_dots, t_chan)


def bound_s(run) -> float:
    products = run.batch * (5 * run.stage1_dups + 6 * run.stage1_adds)
    rows = 2 * run.K + 1
    nbytes = (run.launches.get(LAUNCHES, 0) * 5 * rows * 4
              * run.curves_per_device
              + 20 * (run.stage1_dups + run.stage1_adds) * run.devices)
    return peaks.bound_s(products_s(run.K, products), nbytes)
