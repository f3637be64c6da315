#!/usr/bin/env python3
"""Time K12 and K13, the RNS stage-2 batch inversion
(limbs/rns_kernels.prefix and apply_inverse), on the card at
chip_smoke.py's main-path depth: one stack of the Pa group the memory
rule picks for the rns job's 1024 curves (B1=25,000, B2=2,500,000; 4,096
rows on an H100 80GB), on random canonical residues, at row 21's 2397-bit
N (K=200, 8 curves a block, the weights in shared memory; K13 two
products a pass), at the crossover's 1536-bit N (K=128), at K=216
(synthetic tables: K13 one product a pass) and at a 2700-bit N (K=224,
past the shared-memory limit: 4 curves a block, the weights from the
global table), 1024 curves each.  Before timing, 8 rows of each are held
against rns_kernels.prefix_plain and apply_inverse_plain on the first 16
curves, residue for residue.

    python3 tools/k13_time.py [--root DIR] [--reps N]

--root runs the tree at DIR (its tpu_ecm_torch and chip_smoke.py, e.g. a
`git archive` of another commit unpacked into build/), so that two
versions of the kernels can be timed on one card in one call (a tree
without prefix_geometry and apply_inverse_geometry prints no geometry).
Prints the card (nvidia-smi name and power limit), the kernels' ptxas
lines, and one JSON line: ms per stack (mean of N calls after a warm one)
and us per row of each kernel at each K.
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
                    help="the tree whose kernels are timed (default: this "
                         "one)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from tpu_ecm_torch.limbs import build, rns, rns_kernels
    from tpu_ecm_torch.stage2 import exec as s2, plan
    if not torch.cuda.is_available():
        print("k13_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    build.library()
    print(f"tree {root}; {chip_smoke.smi_line()}", flush=True)
    for kernel in ("rns_prefix_kernel", "rns_apply_inverse_kernel"):
        for line in chip_smoke._ptxas_lines(kernel):
            print(f"  ptxas {kernel}:", line, flush=True)
    geometry = {"prefix": getattr(rns_kernels, "prefix_geometry", None),
                "apply_inverse": getattr(rns_kernels,
                                         "apply_inverse_geometry", None)}

    def real(n):
        ctx = chip_smoke._make_ctx(n)
        return rns.device_ctx(rns.make_rns(ctx, cw=rns.choose_cw(
            ctx.p.nbits)), "cuda")

    gen = torch.Generator(device="cuda").manual_seed(20261018)
    b = 1024
    rc21 = real(chip_smoke.row21_n())
    job = chip_smoke.RNS_JOB
    sp = plan.make_stage2_params(
        job["b1"], job["b2"],
        nw=chip_smoke._make_ctx(chip_smoke.row21_n()).p.nw, batch=b)
    rows = s2.pa_group_for_memory(rc21.rows * b * 4, sp.num_pb,
                                  torch.cuda.mem_get_info()[0])
    print(f"stacks: {rows} rows (the Pa group), B={b}", flush=True)
    n2700 = random.Random(2700).getrandbits(2700) | 1 | (1 << 2699)

    out = {}
    for label, make in (
            ("row21", lambda: rc21),
            ("1536", lambda: real(chip_smoke.n1536())),
            ("216", lambda: chip_smoke.synthetic_rns(216, 216, "cuda")),
            ("2700", lambda: real(n2700))):
        rc = make()
        R = lambda *shape: chip_smoke._rand_residues(gen, rc,
                                                     shape + (rc.rows, b))
        xs, zs, pres = R(rows), R(rows), R(rows)
        one, tinv = R(), R()
        cut = lambda t: t[..., :16].contiguous()
        calls = {
            "prefix": (lambda n: rns_kernels.prefix(zs[:n], one, rc),
                       lambda n: rns_kernels.prefix_plain(
                           cut(zs[:n]), cut(one), rc)),
            "apply_inverse": (
                lambda n: rns_kernels.apply_inverse(
                    xs[:n], zs[:n], pres[:n], tinv, rc),
                lambda n: rns_kernels.apply_inverse_plain(
                    cut(xs[:n]), cut(zs[:n]), cut(pres[:n]), cut(tinv),
                    rc))}
        for name, (kern, plain) in calls.items():
            if not torch.equal(kern(8)[..., :16], plain(8)):
                raise AssertionError(f"{name} differs from its plain "
                                     f"version at {label}")
            kern(rows)
            _, ms = chip_smoke._timed(lambda: kern(rows), args.reps)
            geo = geometry[name] and geometry[name](rc.K, b)
            out[f"{name}/{label}"] = dict(
                K=rc.K, geometry=geo and geo._asdict(), rows=rows, ms=ms,
                us_per_row=1e3 * ms / rows)
            shown = (f"T={geo.tile} H={geo.halves}" if geo
                     else "its geometry")
            print(f"{name} at {label} (K={rc.K}, B={b}) {shown}: "
                  f"{ms:.3f} ms per stack, {1e3 * ms / rows:.3f} us per row",
                  flush=True)
        del xs, zs, pres, one, tinv
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
