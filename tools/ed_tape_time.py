#!/usr/bin/env python3
"""Time K9, the Edwards stage-1 tape kernel (limbs/kernels.ed_tape), on the
card at chip_smoke.py's main-path depths: the first 256 ops of the
flagship's Edwards tape (B1=1e5) over three launches of 100 ops, on random
reduced planes, at the flagship (416-bit N, REDC, nw=36) and at M1277 (the
fold, nw=118), 2048 curves each.  Before timing, a 32-op prefix is held
against curve/edops.run_tape on the first 16 curves, digit for digit.
Then, per op, a 256-op tape of ED_DBL alone and one of ED_ADD alone (table
rows 0..Tp-1 in turn), to split an op's cost between the two programs.

    python3 tools/ed_tape_time.py [--root DIR] [--reps N]

--root runs the tree at DIR (its tpu_ecm_torch and chip_smoke.py, e.g. a
`git archive` of another commit unpacked into build/), so that two
versions of the kernel can be timed on one card in one call.  Prints the
card (nvidia-smi name and power limit), the kernel's ptxas lines, and one
JSON line: ms per 256-op tape (mean of N calls after a warm one) at each
depth, and us per op of the DBL-only and ADD-only tapes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="the tree whose kernel is timed (default: this one)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    from tpu_ecm_torch.curve import edops, edwards
    from tpu_ecm_torch.limbs import build, kernels
    from tpu_ecm_torch.limbs.torch_ops import device_ctx
    from tpu_ecm_torch.primes import primes_range
    if not torch.cuda.is_available():
        print("ed_tape_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    build.library()
    print(f"tree {root}; {chip_smoke.smi_line()}", flush=True)
    for line in chip_smoke._ptxas_lines("ed_tape"):
        print("  ptxas:", line, flush=True)
    b1 = chip_smoke.FLAGSHIP["b1"]
    tape = np.ascontiguousarray(
        edwards.stage1_tape(primes_range(0, b1), b1)[0][:256])
    tp = 1 << (edwards.DEFAULT_W - 2)
    rng = np.random.default_rng(20261017)
    out = {}
    for label, n, mers in (("flagship", chip_smoke.N416, None),
                           ("M1277", chip_smoke.M1277, (1277, 1))):
        ctx = chip_smoke._make_ctx(n, mers)
        d = device_ctx(ctx, "cuda")
        nw, b = ctx.p.nw, 2048
        acc = chip_smoke._rand_planes(rng, ctx, (4, nw, b))
        table = chip_smoke._rand_planes(rng, ctx, (tp, 3, nw, b))
        got = kernels.ed_tape(acc.clone(), tape[:32], table, d)
        want = edops.run_tape(acc[..., :16].contiguous(), tape[:32],
                              table[..., :16].contiguous(), d)
        if not torch.equal(got[..., :16], want):
            raise AssertionError(f"K9 differs from its plain version at "
                                 f"{label}")
        run = lambda: chip_smoke._sliced_tape(kernels, kernels.ed_tape, acc,
                                              tape, table, d, 100)
        run()
        _, ms = chip_smoke._timed(run, args.reps)
        per_op = {}
        for name, alone in (("dbl", [[edwards.ED_DBL, 0]] * 256),
                            ("add", [[edwards.ED_ADD, i % tp]
                                     for i in range(256)])):
            alone = np.asarray(alone, np.int32)
            kernels.ed_tape(acc.clone(), alone, table, d)
            _, t = chip_smoke._timed(
                lambda: kernels.ed_tape(acc.clone(), alone, table, d),
                args.reps)
            per_op[name] = t * 1e3 / alone.shape[0]
        out[label] = dict(nw=nw, curves=b, ops=int(tape.shape[0]),
                          launches=3, ms=ms, us_per_dbl=per_op["dbl"],
                          us_per_add=per_op["add"])
        print(f"  K9 at {label} (nw={nw}, B={b}): {ms:.3f} ms per "
              f"{tape.shape[0]}-op tape; {per_op['dbl']:.2f} us per ED_DBL, "
              f"{per_op['add']:.2f} us per ED_ADD alone", flush=True)
    print(json.dumps({"ed_tape": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
