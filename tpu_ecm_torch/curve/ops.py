"""Montgomery-curve x-only point operations and the plain tape replay: the
twin of tpu_ecm/curve/ops.py.

Stage-1 chains are planned on the host per prime into an (op, dst, a, b, c)
tape (curve/prac.py) and replayed over a register file of S=6 points
[S, 2, NW, B].  run_tape here is the plain version of the stage-1 kernel
(csrc/tape.cu, limbs/kernels.tape).

Formulas (6-mul differential add, 5-mul duplicate):
  ADD(P1,P2 | diff D):  U=(X1-Z1)(X2+Z2), V=(X1+Z1)(X2-Z2)
                        X+ = Zd*(U+V)^2,  Z+ = Xd*(U-V)^2
  DUP(P):               V=(X-Z)^2, U=(X+Z)^2, X2 = U*V
                        W = U-V,  Z2 = (V + s*W)*W      [s = (A+2)/4]
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..limbs import torch_ops
from ..limbs.torch_ops import DeviceCtx

# tape opcodes
OP_DUP = 0
OP_ADD = 1
OP_NOP = 2   # dst := pts[a] (padding; by convention dst = NUM_SLOTS-1, a = 0)

NUM_SLOTS = 6  # P + {A,B,C,T} + 1 spare for renaming


def xdbl(X: torch.Tensor, Z: torch.Tensor, s_const: torch.Tensor,
         ctx: DeviceCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    # every mulmod operand is pre-safe: mulmod outputs, stored points and
    # s_const directly, add/sub results through the normalizing *_n ops
    s_, d_ = torch_ops.addsubmod_n(X, Z, ctx)
    v = torch_ops.sqrmod(d_, ctx, pre=True)
    u = torch_ops.sqrmod(s_, ctx, pre=True)
    x2 = torch_ops.mulmod(u, v, ctx, pre=True)
    w_ = torch_ops.submod_n(u, v, ctx)
    t = torch_ops.mulmod(w_, s_const, ctx, pre=True)
    z2 = torch_ops.mulmod(torch_ops.addmod_n(t, v, ctx), w_, ctx, pre=True)
    return x2, z2


def xadd(X1, Z1, X2, Z2, Xd, Zd, ctx: DeviceCtx
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    s1, d1 = torch_ops.addsubmod_n(X1, Z1, ctx)
    s2, d2 = torch_ops.addsubmod_n(X2, Z2, ctx)
    u = torch_ops.mulmod(d1, s2, ctx, pre=True)
    v = torch_ops.mulmod(s1, d2, ctx, pre=True)
    sp, dm = torch_ops.addsubmod_n(u, v, ctx)
    t1 = torch_ops.sqrmod(sp, ctx, pre=True)
    t2 = torch_ops.sqrmod(dm, ctx, pre=True)
    xo = torch_ops.mulmod(t1, Zd, ctx, pre=True)
    zo = torch_ops.mulmod(t2, Xd, ctx, pre=True)
    return xo, zo


def tape_step(pts: torch.Tensor, entry, s_const: torch.Tensor,
              ctx: DeviceCtx) -> torch.Tensor:
    """Execute one tape entry (op, dst, a, b, c) on the [S, 2, NW, B] file,
    in place.  All inputs are read before dst is written, so dst may alias
    any input slot."""
    op, dst, ia, ib, ic = (int(x) for x in entry)
    pa = pts[ia]
    if op == OP_DUP:
        newpt = torch.stack(xdbl(pa[0], pa[1], s_const, ctx))
    elif op == OP_ADD:
        pb, pd = pts[ib], pts[ic]
        newpt = torch.stack(xadd(pa[0], pa[1], pb[0], pb[1], pd[0], pd[1],
                                 ctx))
    else:
        newpt = pa.clone()
    pts[dst] = newpt
    return pts


def run_tape(pts: torch.Tensor, tape: np.ndarray, s_const: torch.Tensor,
             ctx: DeviceCtx) -> torch.Tensor:
    """Replay a [T, 5] int32 tape over the point register file, in place."""
    for entry in np.asarray(tape).tolist():
        tape_step(pts, entry, s_const, ctx)
    return pts
