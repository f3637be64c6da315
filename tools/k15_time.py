#!/usr/bin/env python3
"""Time K15, the RNS stage-2 stream replay (limbs/rns_kernels.replay), on
the card at chip_smoke.py's main-path depth: the rns job's first replay
call (B1=25,000, B2=2,500,000: 65,536 entries over the Pa group the
memory rule picks and the job's whole Pb table), on random canonical
residues, at row 21's 2397-bit N (K=200, 8 curves a block, the weights in
shared memory), at the crossover's 1536-bit N (K=128), at K=216
(synthetic tables) with T = 8 and with T = 4 asked for, and at a 2700-bit
N (K=224, past the shared-memory limit: 4 curves a block, the weights
from the global table), 1024 curves each.  Before timing, the call's
first 1,024 entries are held against rns_kernels.replay_plain on the
first 16 curves, residue for residue.  Beside each, K14
(rns_kernels.replay_gather) on the same entries (the same call in gather
form, 16-entry steps) on the same tensors, and the ratio of their ms per
live entry.  Last, at row 21, K15 on the same call with every Pb row 1
(no Pb row from HBM), to show what its Pb loads cost.

    python3 tools/k15_time.py [--root DIR] [--reps N]

--root runs the tree at DIR (its tpu_ecm_torch and chip_smoke.py, e.g. a
`git archive` of another commit unpacked into build/), so that two
versions of the kernel can be timed on one card in one call (a tree
without replay_geometry times K15 at its one geometry).  Prints the card
(nvidia-smi name and power limit), the kernels' ptxas lines, and one JSON
line: ms per call (mean of N calls after a warm one) and ms per live
entry of K15 and K14 at each depth and geometry, and K15's ms with the Pb
rows replaced.
"""

from __future__ import annotations

import argparse
import contextlib
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
    from tpu_ecm_torch.limbs import build, rns, rns_kernels
    from tpu_ecm_torch.stage2 import exec as s2
    if not torch.cuda.is_available():
        print("k15_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    build.library()
    print(f"tree {root}; {chip_smoke.smi_line()}", flush=True)
    for kernel in ("rns_replay_kernel", "rns_replay_gather_kernel"):
        for line in chip_smoke._ptxas_lines(kernel):
            print(f"  ptxas {kernel}:", line, flush=True)
    geometry = getattr(rns_kernels, "replay_geometry", None)

    @contextlib.contextmanager
    def forced(tile):
        """replay_geometry giving the launch at `tile` while active."""
        rns_kernels.replay_geometry = lambda K, b: geometry(K, b, tile=tile)
        try:
            yield
        finally:
            rns_kernels.replay_geometry = geometry

    def real(n):
        ctx = chip_smoke._make_ctx(n)
        return rns.device_ctx(rns.make_rns(ctx, cw=rns.choose_cw(
            ctx.p.nbits)), "cuda")

    def timed(run):
        run()
        return chip_smoke._timed(run, args.reps)[1]

    gen = torch.Generator(device="cuda").manual_seed(20261018)
    e, b = s2.REPLAY_E, 1024
    rc21 = real(chip_smoke.row21_n())
    depth = chip_smoke.main_path_depth(
        chip_smoke._make_ctx(chip_smoke.row21_n()).p.nw, rc21.rows, b,
        chip_smoke.RNS_JOB)
    idx, pairs = depth["calls"]["stream"], depth["calls"]["gather"]
    count = int(idx[0])
    live = int((pairs[:, 1] > 0).sum())
    ent = idx[1:1 + count].view(np.uint32)
    changes = int((np.diff(ent >> 16, prepend=-1) != 0).sum())
    print(f"call: {count} stream entries ({changes} Pa row changes), "
          f"{pairs.shape[0]} gather slots with {live} live, Pa group "
          f"{depth['rows']} rows, {depth['pb_rows']} Pb rows", flush=True)
    n2700 = random.Random(2700).getrandbits(2700) | 1 | (1 << 2699)

    out = {}
    for label, make, variants in (
            ("row21", lambda: rc21, ()),
            ("1536", lambda: real(chip_smoke.n1536()), ()),
            ("216", lambda: chip_smoke.synthetic_rns(216, 216, "cuda"),
             (4,)),
            ("2700", lambda: real(n2700), ())):
        rc = make()
        R = lambda *shape: chip_smoke._rand_residues(gen, rc,
                                                     shape + (rc.rows, b))
        acc, pa_ext, pbx = R(), R(depth["rows"] + 1), R(depth["pb_rows"])
        pbx[0] = 0
        head = np.concatenate([[1024], idx[1:1025]]).astype(np.int32)
        cut = lambda t: t[..., :16].contiguous()
        want = rns_kernels.replay_plain(cut(acc), cut(pa_ext), cut(pbx),
                                        head, rc)
        geo = geometry(rc.K, b) if geometry else None
        res = {}
        for tile in (geo.tile,) + variants if geo else (None,):
            own = geo is None or tile == geo.tile
            with contextlib.nullcontext() if own else forced(tile):
                got = rns_kernels.replay(acc, pa_ext, pbx, head, rc)
                if not torch.equal(got[..., :16], want):
                    raise AssertionError(f"K15 T={tile} differs from its "
                                         f"plain version at {label}")
                ms = timed(lambda: rns_kernels.replay(acc, pa_ext, pbx, idx,
                                                      rc))
            key = "picked" if own else f"T{tile}"
            res[key] = dict(ms=ms, ms_per_entry=ms / count)
            print(f"{label} (K={rc.K}, B={b}) K15 {key}: {ms:.3f} ms per "
                  f"call, {ms / count:.6f} per live entry", flush=True)
        ms = timed(lambda: rns_kernels.replay_gather(acc, pa_ext, pbx, pairs,
                                                     rc, e=e))
        k15 = res["picked"]["ms_per_entry"]
        res["k14"] = dict(ms=ms, ms_per_entry=ms / live,
                          k15_over_k14=k15 / (ms / live))
        print(f"{label} (K={rc.K}, B={b}) K14 on the same entries: "
              f"{ms:.3f} ms per call, {ms / live:.6f} per live entry; K15 "
              f"takes {100 * k15 / (ms / live):.1f}% of it", flush=True)
        if label == "row21":
            pb1 = np.concatenate([[count], ((ent >> 16) << 16) | 1]).astype(
                np.uint32).view(np.int32)
            ms = timed(lambda: rns_kernels.replay(acc, pa_ext, pbx, pb1, rc))
            res["pb_1"] = dict(ms=ms)
            print(f"{label} (K={rc.K}, B={b}) K15 every Pb row 1: {ms:.3f} "
                  f"ms per call", flush=True)
        out[label] = dict(K=rc.K, geometry=geo and geo._asdict(), **res)
        del acc, pa_ext, pbx, got, want
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
