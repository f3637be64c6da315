"""Where K10's time goes on the card.

    python3 tools/k10_probe/probe.py      # from the repository root, on a GPU

sections.cu beside this file, built by nvcc into build/k10_probe/ against
csrc/rns_mma.cuh: the cycles (clock64, thread 0 of every block, averaged)
of the five sections of one RNS product as K10 runs it (phase A, the first
extension dot, phase C, the second dot, phase E, each to the barrier that
ends it), and of one dot's mma alone on fragments loaded once, at K=200
(row 21) and K=128 (1536 bits), B=1024, 8 curves a block.  The card's
name and power limit come first, as nvidia-smi gives them.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from tpu_ecm_torch.limbs import build  # noqa: E402


def main() -> int:
    print(cs.smi_line(), flush=True)
    out_dir = os.path.join(REPO, "build", "k10_probe")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, "sections")
    subprocess.run([build.nvcc_path(), *build.ARCH, "-std=c++17", "-O3",
                    "-Xptxas", "-v", "-I", build.CSRC, "-o", exe,
                    os.path.join(HERE, "sections.cu")], check=True)
    subprocess.run([exe], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
