"""Twisted Edwards a=-1 extended-coordinate point operations and the plain
tape replay: the twin of tpu_ecm/curve/edops.py.  run_tape here is the
plain version of the Edwards stage-1 kernel K9 (csrc/ed_tape.cu,
limbs/kernels.ed_tape); both give the digits of the JAX package's
edops.run_tape and Pallas _ed_tape_kernel.

State: accumulator [4, NW, B] (X, Y, Z, T planes, Montgomery form) and a
window table of 2^(w-2) precomputed odd multiples in cached mixed-add form
[Tp, 3, NW, B]: (Y-X, Y+X, 2d*T), Z normalized to 1 on the host.

Formulas (Hisil-Wong-Carter-Dawson 2008, a=-1):
  DBL: A=X^2 B=Y^2 C=2Z^2 E=(X+Y)^2-A-B G=B-A F=G-C H=-(A+B)
       X3=EF Y3=GH Z3=FG [T3=EH]            -> 3M+4S (+1M when T is needed)
  mixed ADD (Z2=1, cached):
       A=(Y1-X1)k0 B=(Y1+X1)k1 C=T1*k2 D=2Z1
       E=B-A H=B+A F=D-C G=D+C
       X3=EF Y3=GH Z3=FG                    -> 6M (T3 is never needed: wNAF
       tapes separate adds by >= w-1 doublings, and only adds read T)
  negated ADD (digit < 0): swap k0/k1, negate C; no extra products.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..limbs import torch_ops
from ..limbs.torch_ops import DeviceCtx
from .edwards import ED_ADD, ED_DBL, ED_DBLT, ED_NOP, ED_SUB

# the largest opcode a tape may hold (the padding no-op)
MAX_OP = ED_NOP


def edbl(acc: torch.Tensor, ctx: DeviceCtx, want_t: bool) -> torch.Tensor:
    X, Y, Z, T = acc[0], acc[1], acc[2], acc[3]
    A = torch_ops.sqrmod(X, ctx, pre=True)
    B = torch_ops.sqrmod(Y, ctx, pre=True)
    C1 = torch_ops.sqrmod(Z, ctx, pre=True)
    C = torch_ops.addmod_n(C1, C1, ctx)
    E0 = torch_ops.sqrmod(torch_ops.addmod_n(X, Y, ctx), ctx, pre=True)
    E = torch_ops.submod_n(torch_ops.submod_n(E0, A, ctx), B, ctx)
    G = torch_ops.submod_n(B, A, ctx)
    F = torch_ops.submod_n(G, C, ctx)
    H = -torch_ops.addmod_n(A, B, ctx)
    X3 = torch_ops.mulmod(E, F, ctx, pre=True)
    Y3 = torch_ops.mulmod(G, H, ctx, pre=True)
    Z3 = torch_ops.mulmod(F, G, ctx, pre=True)
    T3 = torch_ops.mulmod(E, H, ctx, pre=True) if want_t else T
    return torch.stack([X3, Y3, Z3, T3])


def eadd(acc: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor,
         k2: torch.Tensor, ctx: DeviceCtx, negate: bool) -> torch.Tensor:
    X, Y, Z, T = acc[0], acc[1], acc[2], acc[3]
    s1, d1 = torch_ops.addsubmod_n(Y, X, ctx)     # Y1+X1, Y1-X1
    ka, kb = (k1, k0) if negate else (k0, k1)
    A = torch_ops.mulmod(d1, ka, ctx, pre=True)
    B = torch_ops.mulmod(s1, kb, ctx, pre=True)
    C = torch_ops.mulmod(T, k2, ctx, pre=True)
    if negate:
        C = -C
    D = torch_ops.addmod_n(Z, Z, ctx)
    H, E = torch_ops.addsubmod_n(B, A, ctx)       # B+A, B-A
    G, F = torch_ops.addsubmod_n(D, C, ctx)       # D+C, D-C
    X3 = torch_ops.mulmod(E, F, ctx, pre=True)
    Y3 = torch_ops.mulmod(G, H, ctx, pre=True)
    Z3 = torch_ops.mulmod(F, G, ctx, pre=True)
    return torch.stack([X3, Y3, Z3, T])


def tape_step(acc: torch.Tensor, op: int, arg: int, table: torch.Tensor,
              ctx: DeviceCtx) -> torch.Tensor:
    """One (op, arg) entry; ED_NOP (and any other opcode) keeps acc."""
    if op in (ED_DBL, ED_DBLT):
        return edbl(acc, ctx, want_t=op == ED_DBLT)
    if op in (ED_ADD, ED_SUB):
        tab = table[arg]
        return eadd(acc, tab[0], tab[1], tab[2], ctx, negate=op == ED_SUB)
    return acc


def run_tape(acc: torch.Tensor, tape: np.ndarray, table: torch.Tensor,
             ctx: DeviceCtx) -> torch.Tensor:
    """Replay a [T, 2] int32 Edwards tape over the accumulator, in place;
    returns acc."""
    cur = acc
    for op, arg in np.asarray(tape).reshape(-1, 2).tolist():
        cur = tape_step(cur, op, arg, table, ctx)
    if cur is not acc:
        acc.copy_(cur)
    return acc


def to_montgomery_pair(acc: torch.Tensor, ctx: DeviceCtx
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X:Y:Z:T) -> (U, W) = (Z+Y, Z-Y): the projective x-coordinate on the
    birationally equivalent Montgomery curve (feeds stage 2 and the save
    files)."""
    return torch_ops.addsubmod_n(acc[2], acc[1], ctx)
