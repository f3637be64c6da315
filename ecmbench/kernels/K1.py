"""K1, the digit engine's stage-1 tape (tpu_ecm_torch/csrc/tape.cu): its
name in a device trace and the least time the window's stage-1 work needs.

Frozen from chip_smoke.py's _product_macs and _tape_products: a DUP is 3 products and 2 squares, an ADD 4 and 2; a product of
nw-digit numbers is nw^2 int32 multiply-adds of schoolbook columns (a
square nw(nw+1)/2), then REDC's nw^2 + nw, or the fold's passes for a
modulus 2^e - c.  The count follows today's kernel algorithm (schoolbook
plus REDC columns); a kernel that multiplies otherwise (Karatsuba, another
reduction) makes it stale, and PERF.md says so.  Bytes: each launch reads
and writes slot 0's (X, Z) planes and reads the curve constant, nw int32
digits a curve each, and each device reads the tape once, 20 bytes an op.
"""

from harness import peaks

PATTERN = r"(?<![A-Za-z0-9_])tape_lanes_kernel"
LAUNCHES = "tape"


def product_macs(nw: int, sqr: bool, mersenne=None, w: int = 0) -> int:
    """int32 multiply-adds of one digit product (sqr: a square) of one
    curve."""
    cols = nw * (nw + 1) // 2 if sqr else nw * nw
    if mersenne is None:
        return cols + nw * nw + nw
    e, c = mersenne
    cl = max(1, (abs(c).bit_length() + w - 1) // w)
    hi = 2 * nw - e // w
    return cols + cl * (2 * hi + min(nw, hi))


def tape_products(dups: int, adds: int):
    """(products, squares) of DUP and ADD ops."""
    return 3 * dups + 4 * adds, 2 * (dups + adds)


def bound_s(run) -> float:
    muls, sqrs = tape_products(run.stage1_dups, run.stage1_adds)
    macs = run.batch * (
        muls * product_macs(run.nw, False, run.mersenne, run.w)
        + sqrs * product_macs(run.nw, True, run.mersenne, run.w))
    nbytes = (run.launches.get(LAUNCHES, 0) * 5 * run.nw * 4
              * run.curves_per_device
              + 20 * (run.stage1_dups + run.stage1_adds) * run.devices)
    return peaks.bound_s(macs / peaks.IMAD_PER_S, nbytes)
