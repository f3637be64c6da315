"""Stage 1: power the curve batch by all prime powers <= B1 — the twin of
tpu_ecm/stage1.py.

The host plans one ADD/DUP tape per prime chunk (leading 2^k doublings +
PRAC chains with the prime-power repeat rule) and the stage-1 kernel
(limbs/kernels.tape) replays it over the [S, 2, NW, B] register file.  Prime
chunking follows the reference's PRIME_RANGE protocol so checkpoints land at
the same prime boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np
import torch

from tpu_ecm.params import MontyCtx
from tpu_ecm.primes import PrimeStream

from .curve import ops, prac
from .limbs import kernels, layout
from .limbs.torch_ops import DeviceCtx


@dataclasses.dataclass
class Stage1State:
    """Device state for a batch of curves: point register file + curve const."""
    pts: torch.Tensor       # [S, 2, NW, B]
    s_const: torch.Tensor   # [NW, B]  (A+2)/4 in Montgomery form


def init_state(ctx: MontyCtx, xs: List[int], zs: List[int], ss: List[int],
               device) -> Stage1State:
    p = ctx.p
    b = len(xs)
    pts = np.zeros((ops.NUM_SLOTS, 2, p.nw, b), dtype=np.int32)
    pts[0, 0] = layout.pack_batch(xs, p.w, p.nw)
    pts[0, 1] = layout.pack_batch(zs, p.w, p.nw)
    s_const = layout.pack_batch(ss, p.w, p.nw)
    return Stage1State(pts=torch.from_numpy(pts).to(device),
                       s_const=torch.from_numpy(s_const).to(device))


@dataclasses.dataclass
class Stage1Chunk:
    lo: int
    hi: int
    last_prime: int      # largest prime consumed (for checkpoint labels)
    is_final: bool
    ptadds: int = 0      # ADD steps executed (ecm_work counters)
    ptdups: int = 0
    numprimes: int = 0


def run_stage1(state: Stage1State, dctx: DeviceCtx, b1: int,
               stream: PrimeStream
               ) -> Iterator[Tuple[Stage1Chunk, Stage1State]]:
    """Yield (chunk, state) after each prime chunk; the caller checkpoints
    between chunks.  The point file is updated in place."""
    first = True
    for lo, hi, primes in stream.chunks(0, b1):
        sel = primes[primes < b1]
        tape = prac.stage1_tape(sel, b1, include_two=first)
        first = False
        if tape.shape[0]:
            kernels.tape(state.pts, tape, state.s_const, dctx)
        last_prime = int(sel[-1]) if sel.size else 2
        ops_col = tape[:, 0] if tape.shape[0] else np.zeros(0, np.int32)
        yield Stage1Chunk(lo=lo, hi=hi, last_prime=last_prime,
                          is_final=hi >= b1,
                          ptadds=int(np.count_nonzero(ops_col == ops.OP_ADD)),
                          ptdups=int(np.count_nonzero(ops_col == ops.OP_DUP)),
                          numprimes=int(sel.size)), state


def extract_point(state: Stage1State, ctx: MontyCtx
                  ) -> Tuple[List[int], List[int]]:
    """(X, Z) of slot 0 as canonical integers (mod n, out of Montgomery
    form) for every curve — the savefile normalization step."""
    pts = state.pts[0].cpu().numpy()
    xm = layout.unpack_batch(pts[0], ctx.p.w)
    zm = layout.unpack_batch(pts[1], ctx.p.w)
    xs = [ctx.from_mont_int(v % ctx.n_int) for v in xm]
    zs = [ctx.from_mont_int(v % ctx.n_int) for v in zm]
    return xs, zs
