#!/usr/bin/env python3
"""Time K8, the digit engine's resident-slab replay
(limbs/kernels.replay_resident), on the card at chip_smoke.py's main-path
depths and at three slab heights: the first resident call of the
flagship job (the 416-bit N, REDC, nw=36) and of the mersenne job (M1277,
the fold, nw=118), over the Pa group the memory rule picks and the job's
whole Pb table, on random reduced planes, at each batch of --batch.  The
heights: the largest slab a block holds ("largest",
kernels.ResidentSmem.max_rows), the largest at which two blocks fit an SM
("two", from the kernel's occupancy entry point, where the tree has one)
and 16 rows ("16", where it fits).  Before timing, the call's first 64
steps are held against kernels.replay_resident_plain on the first 16
curves, digit for digit.

    python3 tools/k8_time.py [--root DIR] [--batch B ...] [--heights H ...]
                             [--reps N]

--root runs the tree at DIR (its tpu_ecm_torch and chip_smoke.py, e.g. a
`git archive` of another commit unpacked into build/), so that two
versions of the kernel can be timed on one card in one call.  Prints the
card (nvidia-smi name and power limit), the kernel's ptxas lines, and one
JSON line: for each batch, depth and height the slab height, slabs,
slots, live entries, ms per call (mean of N calls after a warm one), ms
per live entry, the share of the multiply-add bound (chip_smoke.
_digit_macs of one product per live entry over chip_smoke.IMAD_PER_S) and,
where the tree reports them, the shared memory a block, blocks per SM and
whether the height is the default (kernels.resident_slab_rows at B).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def head(call, steps: int, e: int):
    """The first `steps` steps of a K8 call: its entries and the segments
    that hold them, cut at the last."""
    import numpy as np
    segs = [(lo, s0, min(s0 + n, steps) - s0)
            for lo, s0, n in call.slabs.tolist() if s0 < steps]
    return call.entries[:steps * e], np.asarray(segs, np.int32)


def heights(kernels, nw: int, want) -> dict:
    """name -> slab rows of the heights in `want` that this tree takes."""
    lane_core = hasattr(kernels, "resident_smem")
    top = (kernels.resident_smem(nw, "cuda").max_rows if lane_core
           else kernels.resident_slab_rows(nw, "cuda"))
    out = {"largest": top}
    if lane_core:
        out["two"] = next(cap for cap in range(top, 0, -1)
                          if kernels.resident_blocks_per_sm(nw, cap,
                                                            "cuda") >= 2)
    if 16 <= top:
        out["16"] = 16
    return {k: v for k, v in out.items() if k in want}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="the tree whose kernel is timed (default: this "
                         "one)")
    ap.add_argument("--batch", type=int, nargs="+", default=[2048, 4224])
    ap.add_argument("--heights", nargs="+", default=["largest", "two", "16"],
                    choices=["largest", "two", "16"])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    from tpu_ecm_torch.limbs import build, kernels
    from tpu_ecm_torch.limbs.torch_ops import device_ctx
    from tpu_ecm_torch.stage2 import exec as s2, plan
    if not torch.cuda.is_available():
        print("k8_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    build.library()
    print(f"tree {root}; {chip_smoke.smi_line()}", flush=True)
    for name in ("replay_resident_kernel", "replay_resident_lanes_kernel"):
        for line in chip_smoke._ptxas_lines(f"_Z{len(name)}{name}"):
            print(f"  ptxas {name}:", line, flush=True)

    rng = np.random.default_rng(20261018)
    e, cut = s2.REPLAY_E, 16
    lane_core = hasattr(kernels, "resident_smem")
    out = {}
    for b in args.batch:
        for label, n, mers, job in (
                ("flagship", chip_smoke.N416, None, chip_smoke.FLAGSHIP),
                ("M1277", chip_smoke.M1277, (1277, 1),
                 chip_smoke.MERSENNE_JOB)):
            ctx = chip_smoke._make_ctx(n, mers)
            d = device_ctx(ctx, "cuda")
            nw = ctx.p.nw
            sp = plan.make_stage2_params(job["b1"], job["b2"], nw=nw,
                                         batch=b)
            g = s2.pa_group_for_memory(nw * b * 4, sp.num_pb,
                                       s2.device_free_bytes("cuda"))
            R = lambda *shape: chip_smoke._rand_planes(rng, ctx,
                                                       shape + (nw, b))
            acc, pa_ext, pbx = R(), R(g + 1), R(sp.num_pb)
            pbx[0] = 0
            c = lambda t: t[..., :cut].contiguous()
            macs = chip_smoke._digit_macs(ctx, 1, 0) * b
            res = {}
            for hname, cap in heights(kernels, nw, args.heights).items():
                call = chip_smoke._first_calls(job, sp, g, cap)["resident"]
                run = lambda ent, sl: kernels.replay_resident(
                    acc, pa_ext, pbx, ent, sl, cap, d, e=e)
                ent, sl = head(call, 64, e)
                want = kernels.replay_resident_plain(
                    c(acc), c(pa_ext), c(pbx), ent, sl, cap, e, d)
                if not torch.equal(run(ent, sl)[..., :cut], want):
                    raise AssertionError(f"K8 differs from its plain "
                                         f"version at {label}, B={b}, "
                                         f"cap={cap}")
                run(call.entries, call.slabs)
                _, ms = chip_smoke._timed(
                    lambda: run(call.entries, call.slabs), args.reps)
                live = int((call.entries[:, 1] > 0).sum())
                bound = live * macs / chip_smoke.IMAD_PER_S * 1e3
                r = dict(cap=cap, slabs=int(call.slabs.shape[0]),
                         slots=int(call.entries.shape[0]), live=live, ms=ms,
                         ms_per_entry=ms / live, bound_ops_ms=bound,
                         share=bound / ms)
                if lane_core:
                    sm = kernels.resident_smem(nw, "cuda")
                    r.update(smem_bytes=sm.static + sm.block_bytes(cap),
                             blocks_per_sm=kernels.resident_blocks_per_sm(
                                 nw, cap, "cuda"),
                             default=cap == kernels.resident_slab_rows(
                                 nw, b, "cuda"))
                res[hname] = r
                print(f"B={b} {label} (nw={nw}) K8 at {hname} ({cap} rows, "
                      f"{r['slabs']} slabs, {r['slots']} slots): "
                      f"{ms:.3f} ms per call, {live} live entries, "
                      f"{ms / live:.6f} ms per live entry, "
                      f"{100 * bound / ms:.2f}% of the multiply-add bound "
                      f"{bound:.4f} ms"
                      + (f"; {r['smem_bytes']} bytes shared a block, "
                         f"{r['blocks_per_sm']} blocks per SM"
                         + ("; the default" if r["default"] else "")
                         if lane_core else ""), flush=True)
            out[f"{label} B={b}"] = dict(nw=nw, rows=g, pb_rows=sp.num_pb,
                                         **res)
            del acc, pa_ext, pbx
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
