#!/usr/bin/env python3
"""Time K10, the RNS stage-1 tape kernel (limbs/rns_kernels.tape), on the
card at chip_smoke.py's main-path depth: the first 256 ops of the rns
job's stage-1 tape (B1=25,000) over three launches of 100 ops, on random
canonical residues, at row 21's 2397-bit N (K=200, 8 curves a block, the
weights in shared memory), at the crossover's 1536-bit N (K=128) and at a
2700-bit N (K=224, past the shared-memory limit: 4 curves a block, the
weights from the global table), 1024 curves each.  Before timing, a 32-op
prefix is held against rns_exec.run_tape on the first 16 curves, residue
for residue.  Then, per op, a 256-op tape of DUPs alone and one of ADDs
alone.

    python3 tools/k10_time.py [--root DIR] [--reps N]

--root runs the tree at DIR (its tpu_ecm_torch and chip_smoke.py, e.g. a
`git archive` of another commit unpacked into build/), so that two
versions of the kernel can be timed on one card in one call.  Prints the
card (nvidia-smi name and power limit), the kernel's ptxas lines, and one
JSON line: ms per 256-op tape (mean of N calls after a warm one) at each
depth, and us per op of the DUP-only and ADD-only tapes.
"""

from __future__ import annotations

import argparse
import json
import os
import random
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
    from tpu_ecm_torch.curve import prac
    from tpu_ecm_torch.limbs import build, rns, rns_exec, rns_kernels
    from tpu_ecm_torch.primes import primes_range
    if not torch.cuda.is_available():
        print("k10_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    build.library()
    print(f"tree {root}; {chip_smoke.smi_line()}", flush=True)
    for line in chip_smoke._ptxas_lines("rns_tape_kernel"):
        print("  ptxas:", line, flush=True)
    b1 = chip_smoke.RNS_JOB["b1"]
    tape = np.ascontiguousarray(
        prac.stage1_tape(primes_range(0, b1), b1)[:256], dtype=np.int32)
    gen = torch.Generator(device="cuda").manual_seed(20261017)
    n2700 = random.Random(2700).getrandbits(2700) | 1 | (1 << 2699)
    out = {}
    for label, n in (("row21", chip_smoke.row21_n()),
                     ("1536", chip_smoke.n1536()), ("2700", n2700)):
        ctx = chip_smoke._make_ctx(n)
        rc = rns.device_ctx(rns.make_rns(ctx, cw=rns.choose_cw(ctx.p.nbits)),
                            "cuda")
        b = 1024
        pts = chip_smoke._rand_residues(gen, rc, (6, 2, rc.rows, b))
        sc = chip_smoke._rand_residues(gen, rc, (rc.rows, b))
        got = rns_kernels.tape(pts.clone(), tape[:32], sc, rc)
        want = rns_exec.run_tape(pts[..., :16].contiguous(), tape[:32],
                                 sc[..., :16].contiguous(), rc)
        if not torch.equal(got[..., :16], want):
            raise AssertionError(f"K10 differs from its plain version at "
                                 f"{label}")
        run = lambda t: chip_smoke._sliced_tape(rns_kernels,
                                                rns_kernels.tape, pts, t, sc,
                                                rc, 100)
        run(tape)
        _, ms = chip_smoke._timed(lambda: run(tape), args.reps)
        per_op = {}
        for name, alone in (("dup", [[0, 1, 1, 0, 0]] * 256),
                            ("add", [[1, 2, 1, 2, 0]] * 256)):
            t = np.asarray(alone, np.int32)
            run(t)
            per_op[name] = chip_smoke._timed(lambda: run(t),
                                             args.reps)[1] * 1e3 / 256
        # a tree from before the tensor-core K10 has no tape_geometry
        geometry = getattr(rns_kernels, "tape_geometry", None)
        tile = geometry(rc.K, b).tile if geometry else 4
        out[label] = dict(K=rc.K, tile=tile, ms_per_256_ops=ms,
                          us_per_dup=per_op["dup"], us_per_add=per_op["add"])
        print(f"{label} (K={rc.K}, B={b}, T={tile}): {ms:.3f} ms per "
              f"256-op tape; {per_op['dup']:.2f} us per DUP, "
              f"{per_op['add']:.2f} us per ADD", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
