#!/usr/bin/env python3
"""Time K6 and K7, the digit engine's gather and shared-Pa-row replays
(limbs/kernels.replay_gather, replay_parow), on the card at chip_smoke.py's
main-path depths: the first replay call of the flagship job (the 416-bit
N, REDC, nw=36, B=2048) and of the mersenne job (M1277, the fold, nw=118,
B=2048), each in its mode (K6: [T, 2] pairs in 16-entry steps; K7: the
shared-Pa-row steps), over the Pa group the memory rule picks and the
job's whole Pb table, on random reduced planes.  Before timing, the
call's first 64 steps are held against kernels.replay_gather_plain and
replay_parow_plain on the first 16 curves, digit for digit.

    python3 tools/k6_time.py [--root DIR] [--reps N]

--root runs the tree at DIR (its tpu_ecm_torch and chip_smoke.py, e.g. a
`git archive` of another commit unpacked into build/), so that two
versions of the kernels can be timed on one card in one call.  Prints the
card (nvidia-smi name and power limit), the kernels' ptxas lines, and one
JSON line: ms per call (mean of N calls after a warm one), ms per live
entry and the share of the multiply-add bound (chip_smoke._digit_macs of
one product per live entry over chip_smoke.IMAD_PER_S) of each kernel at
each depth.
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
                    help="the tree whose kernels are timed (default: this "
                         "one)")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    from tpu_ecm_torch.limbs import build, kernels, layout
    from tpu_ecm_torch.limbs.torch_ops import device_ctx
    from tpu_ecm_torch.stage2 import exec as s2
    if not torch.cuda.is_available():
        print("k6_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    build.library()
    print(f"tree {root}; {chip_smoke.smi_line()}", flush=True)
    # the one-thread kernels and the lane-core templates, by mangled name
    for name in ("replay_gather_kernel", "replay_gather_lanes_kernel",
                 "replay_parow_kernel", "replay_parow_lanes_kernel"):
        for line in chip_smoke._ptxas_lines(f"_Z{len(name)}{name}"):
            print(f"  ptxas {name}:", line, flush=True)

    rng = np.random.default_rng(20261018)
    e, b, cut = s2.REPLAY_E, 2048, 16
    out = {}
    for label, n, mers, job in (
            ("flagship", chip_smoke.N416, None, chip_smoke.FLAGSHIP),
            ("M1277", chip_smoke.M1277, (1277, 1),
             chip_smoke.MERSENNE_JOB)):
        ctx = chip_smoke._make_ctx(n, mers)
        d = device_ctx(ctx, "cuda")
        nw = ctx.p.nw
        depth = chip_smoke.main_path_depth(nw, nw, b, job)
        pairs, steps = depth["calls"]["gather"], depth["calls"]["parow"]
        R = lambda *shape: chip_smoke._rand_planes(rng, ctx,
                                                   shape + (nw, b))
        one = torch.from_numpy(layout.broadcast_int(
            ctx.r_mod_n, ctx.p.w, nw, b)).cuda()
        acc, pa_ext = R(), torch.cat([R(depth["rows"]), one[None]])
        pbx = R(depth["pb_rows"])
        pbx[0] = 0
        c = lambda t: t[..., :cut].contiguous()
        macs = chip_smoke._digit_macs(ctx, 1, 0) * b
        res = {}
        for name, call, live, head, plain, run in (
                ("replay_gather", pairs, int((pairs[:, 1] > 0).sum()),
                 pairs[:64 * e],
                 lambda h: kernels.replay_gather_plain(
                     c(acc), c(pa_ext), c(pbx), h, e, d),
                 lambda x: kernels.replay_gather(acc, pa_ext, pbx, x, d,
                                                 e=e)),
                ("replay_parow", steps, int((steps[:, 1:] > 0).sum()),
                 steps[:64],
                 lambda h: kernels.replay_parow_plain(
                     c(acc), c(pa_ext), c(pbx), h, c(one), d),
                 lambda x: kernels.replay_parow(acc, pa_ext, pbx, x, one,
                                                d))):
            got = run(head)
            if not torch.equal(got[..., :cut], plain(head)):
                raise AssertionError(f"{name} differs from its plain "
                                     f"version at {label}")
            run(call)
            _, ms = chip_smoke._timed(lambda: run(call), args.reps)
            bound = live * macs / chip_smoke.IMAD_PER_S * 1e3
            res[name] = dict(ms=ms, live=live, slots=int(
                call.shape[0] if name == "replay_gather"
                else steps[:, 1:].size), ms_per_entry=ms / live,
                bound_ops_ms=bound, share=bound / ms)
            print(f"{label} (nw={nw}, B={b}) {name}: {ms:.3f} ms per call, "
                  f"{live} live entries, {ms / live:.6f} ms per live "
                  f"entry, {100 * bound / ms:.2f}% of the multiply-add "
                  f"bound {bound:.4f} ms", flush=True)
        out[label] = dict(nw=nw, rows=depth["rows"],
                          pb_rows=depth["pb_rows"], **res)
        del acc, pa_ext, pbx, got
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
