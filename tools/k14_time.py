#!/usr/bin/env python3
"""Time K14, the RNS stage-2 gather replay (limbs/rns_kernels.replay_gather),
on the card at chip_smoke.py's main-path depth: the rns job's first replay
call (B1=25,000, B2=2,500,000: 65,536 entries in 16-entry steps over the
Pa group the memory rule picks and the job's whole Pb table), on random
canonical residues, at row 21's 2397-bit N (K=200, 8 curves a block, the
weights in shared memory, two products a pass), at the crossover's
1536-bit N (K=128) and at a 2700-bit N (K=224, past the shared-memory
limit: 4 curves a block, the weights from the global table), 1024 curves
each.  Before timing, the call's first 1,024 entries are held against
rns_kernels.replay_gather_plain on the first 16 curves, residue for
residue.  Then, on the same call at K=216 (synthetic tables), T = 4 with
two products a pass beside the T = 8 with one that gather_geometry picks
there (the number of products a pass follows from K and the tile).
Last, at row 21, the same
call with its rows replaced, to show what the gathers cost: every entry
(0, 0) (the same two rows throughout: no row comes from HBM), the Pa rows
kept and every Pb row 1, and every Pa row 0 with the Pb rows kept.

    python3 tools/k14_time.py [--root DIR] [--reps N]

--root runs the tree at DIR (its tpu_ecm_torch and chip_smoke.py, e.g. a
`git archive` of another commit unpacked into build/), so that two
versions of the kernel can be timed on one card in one call (a tree
without gather_geometry times its one geometry).  Prints the card
(nvidia-smi name and power limit), the kernel's ptxas lines, and one JSON
line: ms per call (mean of N calls after a warm one), ms per live entry
and the bytes the call's gathers move per ms (two rows per entry slot) at
each depth and geometry, and ms per call with the rows replaced.
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
        print("k14_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    build.library()
    print(f"tree {root}; {chip_smoke.smi_line()}", flush=True)
    for line in chip_smoke._ptxas_lines("rns_replay_gather_kernel"):
        print("  ptxas:", line, flush=True)
    geometry = getattr(rns_kernels, "gather_geometry", None)

    @contextlib.contextmanager
    def forced(tile):
        """gather_geometry giving the launch at `tile` while active."""
        rns_kernels.gather_geometry = lambda K, b: geometry(K, b, tile=tile)
        try:
            yield
        finally:
            rns_kernels.gather_geometry = geometry

    def real(n):
        ctx = chip_smoke._make_ctx(n)
        return rns.device_ctx(rns.make_rns(ctx, cw=rns.choose_cw(
            ctx.p.nbits)), "cuda")

    gen = torch.Generator(device="cuda").manual_seed(20261017)
    e, b = s2.REPLAY_E, 1024
    rc21 = real(chip_smoke.row21_n())
    depth = chip_smoke.main_path_depth(
        chip_smoke._make_ctx(chip_smoke.row21_n()).p.nw, rc21.rows, b,
        chip_smoke.RNS_JOB)
    pairs = depth["calls"]["gather"]
    live = int((pairs[:, 1] > 0).sum())
    print(f"call: {pairs.shape[0]} slots, {live} live entries, Pa group "
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
        head = pairs[:1024]
        cut = lambda t: t[..., :16].contiguous()
        want = rns_kernels.replay_gather_plain(cut(acc), cut(pa_ext),
                                               cut(pbx), head, e, rc)
        gathered = pairs.shape[0] * 2 * rc.rows * b * 4
        geo = geometry(rc.K, b) if geometry else None
        res = {}
        for tile in (geo.tile,) + variants if geo else (None,):
            own = geo is None or tile == geo.tile
            at = geo and (geometry(rc.K, b, tile=tile) if tile else geo)
            with contextlib.nullcontext() if own else forced(tile):
                got = rns_kernels.replay_gather(acc, pa_ext, pbx, head, rc,
                                                e=e)
                if not torch.equal(got[..., :16], want):
                    raise AssertionError(f"K14 T={tile} differs "
                                         f"from its plain version at "
                                         f"{label}")
                run = lambda: rns_kernels.replay_gather(acc, pa_ext, pbx,
                                                        pairs, rc, e=e)
                run()
                _, ms = chip_smoke._timed(run, args.reps)
            key = "picked" if own else f"T{at.tile}H{at.halves}"
            res[key] = dict(ms=ms, ms_per_entry=ms / live,
                            gathered_gb_per_s=gathered / ms / 1e6)
            print(f"{label} (K={rc.K}, B={b}) {key}: "
                  f"{ms:.3f} ms per call, {ms / live:.6f} per live entry, "
                  f"gathers {gathered / ms / 1e6:.0f} GB/s", flush=True)
        if label == "row21":
            ones = np.ones(pairs.shape[0], np.int32)
            for name, p in (("rows_0_0", 0 * pairs),
                            ("pb_1", np.stack([pairs[:, 0], ones], 1)),
                            ("pa_0", np.stack([0 * ones, pairs[:, 1]], 1))):
                p = np.ascontiguousarray(p)
                run = lambda: rns_kernels.replay_gather(acc, pa_ext, pbx, p,
                                                        rc, e=e)
                run()
                _, ms = chip_smoke._timed(run, args.reps)
                res[name] = dict(ms=ms)
                print(f"{label} (K={rc.K}, B={b}) entries {name}: "
                      f"{ms:.3f} ms per call", flush=True)
        out[label] = dict(K=rc.K, geometry=geo and geo._asdict(), **res)
        del acc, pa_ext, pbx, got, want
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
