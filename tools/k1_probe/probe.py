"""Where K1's time goes on the card.

    python3 tools/k1_probe/probe.py      # from the repository root, on a GPU

1. K1's time per tape op through limbs/kernels.tape, at B = 128 and
   B = 2048, on tapes of DUPs only and of ADDs only, at the flagship's
   416-bit N (REDC, nw = 36), at M1277 (the fold, nw = 118) and at a random
   odd 1277-bit N (REDC, nw = 118).  A time per op that does not fall as B
   grows shows warps bound by their own latency or instruction rate, not
   by the card's width.
2. sections.cu beside this file, built by nvcc into build/k1_probe/: the
   cycles (clock64, first warp) of the a*b columns and of the reduction of
   a pair of products, of the whole product step and of one sum, at the
   same three geometries.

The card's name and power limit come first, as nvidia-smi gives them.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_ecm_torch.limbs import build, kernels  # noqa: E402


def tape_of(op: int, n: int) -> np.ndarray:
    """n DUPs (op 0: slot 1 := 2*slot 1) or n ADDs (op 1: slot 2 := slot 1
    + slot 2 with difference slot 0)."""
    t = np.zeros((n, 5), np.int32)
    t[:] = (0, 1, 1, 0, 0) if op == 0 else (1, 2, 1, 2, 0)
    return t


def per_op() -> None:
    rng = np.random.default_rng(1)
    redc1277 = random.Random(1277).getrandbits(1277) | 1 | (1 << 1276)
    for label, ctx in (("N416 REDC", cs._make_ctx(cs.N416)),
                       ("M1277 fold", cs._make_ctx(cs.M1277, (1277, 1))),
                       ("1277-bit REDC", cs._make_ctx(redc1277))):
        for b in (128, 2048):
            for op, name in ((0, "DUP"), (1, "ADD")):
                us = cs._tape_ms_per_op(rng, ctx, tape_of(op, 64), b) * 1e3
                print(f"{label} nw={ctx.p.nw} B={b} {name}: {us:.2f} us per "
                      f"op, geometry {kernels.tape_geometry(ctx.p.nw, b)}",
                      flush=True)


def sections() -> None:
    out_dir = os.path.join(REPO, "build", "k1_probe")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, "sections")
    subprocess.run([build.nvcc_path(), *build.ARCH, "-std=c++17", "-O3",
                    f"-DTPUECM_NW_MAX={build.NW_MAX}",
                    f"-DTPUECM_CL_MAX={build.CL_MAX}", "-I", build.CSRC,
                    "-o", exe, os.path.join(HERE, "sections.cu")],
                   check=True)
    subprocess.run([exe], check=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    per_op()
    sections()
    return 0


if __name__ == "__main__":
    sys.exit(main())
