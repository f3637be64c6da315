"""RNS engine curve operations and host packing: the twin of
tpu_ecm/limbs/rns_exec.py:41-128.

The stage-1 tapes of curve/prac.py replay over a register file of S=6
points [S, 2, 2K+1, B] of residue planes, with every product an RNS
Montgomery product (limbs/rns.py).  run_tape here is the plain version of
the RNS stage-1 kernel K10 (csrc/rns_tape.cu, limbs/rns_kernels.tape).

Value bounds (rns.py: products give <= V, add/sub <= 2V, products take
<= 2V): the Montgomery-curve formulas below nest at most one add/sub
between products, so the engine is Suyama/Montgomery-only.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..curve.ops import NUM_SLOTS, OP_ADD, OP_DUP
from . import rns

# curves a block of every RNS kernel at K <= 222 (csrc/rns_mma.cuh,
# rns_mma_tile: the u8 weight planes resident in shared memory)
TILE = 8


def default_batch(device: torch.device) -> int:
    """Curves per batch on a card.  Each RNS kernel (csrc/rns_mma.cuh) runs
    one block per tile of TILE curves, and at K <= 222 a block keeps the
    four u8 weight planes in shared memory (213,024 bytes at K = 200), so
    one block fills an SM: SMs*TILE curves give every SM one block (1056 on
    an H100 SXM), and a larger batch only adds waves.  (Past K = 222 a
    block takes 4 curves and reads the weights from the global table; the
    batch stays the same.)"""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * TILE


# ---------------------------------------------------------------------------
# curve ops on [2, rows, B] points (formulas: curve/ops.py)
# ---------------------------------------------------------------------------

def xdbl(X: torch.Tensor, Z: torch.Tensor, s_const: torch.Tensor,
         rc: rns.RnsCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    s_, d_ = rns.addsub(X, Z, rc)
    v = rns.mont_sqr(d_, rc)
    u = rns.mont_sqr(s_, rc)
    x2 = rns.mont_mul(u, v, rc)
    w_ = rns.sub(u, v, rc)
    t = rns.mont_mul(w_, s_const, rc)
    z2 = rns.mont_mul(rns.add(t, v, rc), w_, rc)
    return x2, z2


def xadd(pa: torch.Tensor, pb: torch.Tensor, pd: torch.Tensor,
         rc: rns.RnsCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """pa + pb with difference pd; points [2, rows, B]."""
    s1, d1 = rns.addsub(pa[0], pa[1], rc)
    s2, d2 = rns.addsub(pb[0], pb[1], rc)
    u = rns.mont_mul(d1, s2, rc)
    v = rns.mont_mul(s1, d2, rc)
    sp, dm = rns.addsub(u, v, rc)
    t1 = rns.mont_sqr(sp, rc)
    t2 = rns.mont_sqr(dm, rc)
    return rns.mont_mul(t1, pd[1], rc), rns.mont_mul(t2, pd[0], rc)


def run_tape(pts: torch.Tensor, tape: np.ndarray, s_const: torch.Tensor,
             rc: rns.RnsCtx) -> torch.Tensor:
    """K10's plain version: replay a [T, 5] (op, dst, a, b, c) tape over
    the [S, 2, rows, B] file, in place.  Inputs are read before dst is
    written, so dst may alias any input slot."""
    for op, dst, ia, ib, ic in np.asarray(tape).tolist():
        pa = pts[ia]
        if op == OP_DUP:
            newpt = torch.stack(xdbl(pa[0], pa[1], s_const, rc))
        elif op == OP_ADD:
            newpt = torch.stack(xadd(pa, pts[ib], pts[ic], rc))
        else:
            newpt = pa.clone()
        pts[dst] = newpt
    return pts


# ---------------------------------------------------------------------------
# host packing / extraction
# ---------------------------------------------------------------------------

def init_state(host: rns.RnsHost, xs: List[int], zs: List[int],
               ss: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical ints -> ([S, 2, rows, B] register file, [rows, B] curve
    constant), in the RNS Montgomery domain (R = P)."""
    pack = lambda vals: host.pack([host.to_mont_int(v) for v in vals])
    pts = np.zeros((NUM_SLOTS, 2, host.rows, len(xs)), dtype=np.int32)
    pts[0, 0] = pack(xs)
    pts[0, 1] = pack(zs)
    return pts, pack(ss)


def extract_point(host: rns.RnsHost, pts, slot: int = 0
                  ) -> Tuple[List[int], List[int]]:
    """Slot residues -> canonical (X, Z) ints mod n (Montgomery factor P
    divided out): the savefile normalisation step."""
    arr = pts[slot]
    arr = arr.cpu().numpy() if isinstance(arr, torch.Tensor) \
        else np.asarray(arr)
    xs = [host.from_mont_int(v) for v in host.unpack(arr[0])]
    zs = [host.from_mont_int(v) for v in host.unpack(arr[1])]
    return xs, zs
