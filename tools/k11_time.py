#!/usr/bin/env python3
"""Time K11, the RNS stage-2 differential-add chain (limbs/rns_kernels.chain),
on the card at chip_smoke.py's main-path depth: one chain of the Pa group
the memory rule picks for the rns job's 1024 curves (B1=25,000,
B2=2,500,000; 4,096 rows on an H100 80GB), on random canonical residues,
at row 21's 2397-bit N (K=200, 8 curves a block, the weights in shared
memory, two products a pass), at the crossover's 1536-bit N (K=128), at
K=216 (synthetic tables: 8 curves a block, one product a pass) and at a
2700-bit N (K=224, past the shared-memory limit: 4 curves a block, the
weights from the global table, two products a pass), 1024 curves each.
Before timing, 8 rows of each are held against rns_kernels.chain_plain on
the first 16 curves, residue for residue.

    python3 tools/k11_time.py [--root DIR] [--reps N]

--root runs the tree at DIR (its tpu_ecm_torch and chip_smoke.py, e.g. a
`git archive` of another commit unpacked into build/), so that two
versions of the kernel can be timed on one card in one call (a tree
without chain_geometry prints no geometry).  Prints the card (nvidia-smi
name and power limit), the kernel's ptxas lines, and one JSON line: ms
per chain (mean of N calls after a warm one) and us per row at each K.
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
    import torch

    import chip_smoke
    from tpu_ecm_torch.limbs import build, rns, rns_kernels
    from tpu_ecm_torch.stage2 import exec as s2, plan
    if not torch.cuda.is_available():
        print("k11_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    build.library()
    print(f"tree {root}; {chip_smoke.smi_line()}", flush=True)
    for line in chip_smoke._ptxas_lines("rns_chain_kernel"):
        print("  ptxas:", line, flush=True)
    geometry = getattr(rns_kernels, "chain_geometry", None)

    def real(n):
        ctx = chip_smoke._make_ctx(n)
        return rns.device_ctx(rns.make_rns(ctx, cw=rns.choose_cw(
            ctx.p.nbits)), "cuda")

    gen = torch.Generator(device="cuda").manual_seed(20261017)
    b = 1024
    rc21 = real(chip_smoke.row21_n())
    job = chip_smoke.RNS_JOB
    sp = plan.make_stage2_params(
        job["b1"], job["b2"],
        nw=chip_smoke._make_ctx(chip_smoke.row21_n()).p.nw, batch=b)
    rows = s2.pa_group_for_memory(rc21.rows * b * 4, sp.num_pb,
                                  torch.cuda.mem_get_info()[0])
    print(f"chain: {rows} rows (the Pa group), B={b}", flush=True)
    n2700 = random.Random(2700).getrandbits(2700) | 1 | (1 << 2699)

    out = {}
    for label, make in (
            ("row21", lambda: rc21),
            ("1536", lambda: real(chip_smoke.n1536())),
            ("216", lambda: chip_smoke.synthetic_rns(216, 216, "cuda")),
            ("2700", lambda: real(n2700))):
        rc = make()
        p1, p2, pd = (chip_smoke._rand_residues(gen, rc, (2, rc.rows, b))
                      for _ in range(3))
        cut = lambda t: t[..., :16].contiguous()
        want = rns_kernels.chain_plain(cut(p1), cut(p2), cut(pd), 8, rc)
        got = rns_kernels.chain(p1, p2, pd, 8, rc)
        if not torch.equal(got[..., :16], want):
            raise AssertionError(f"K11 differs from its plain version at "
                                 f"{label}")
        run = lambda: rns_kernels.chain(p1, p2, pd, rows, rc)
        run()
        _, ms = chip_smoke._timed(run, args.reps)
        geo = geometry(rc.K, b) if geometry else None
        out[label] = dict(K=rc.K, geometry=geo and geo._asdict(), rows=rows,
                          ms=ms, us_per_row=1e3 * ms / rows)
        shown = (f"T={geo.tile} H={geo.halves}" if geo else "its geometry")
        print(f"{label} (K={rc.K}, B={b}) {shown}: {ms:.3f} ms per chain, "
              f"{1e3 * ms / rows:.3f} us per row", flush=True)
        del p1, p2, pd, got, want
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
