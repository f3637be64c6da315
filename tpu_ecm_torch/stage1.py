"""Stage 1: power the curve batch by all prime powers <= B1 — the twin of
tpu_ecm/stage1.py.

The host plans one ADD/DUP tape per prime chunk (leading 2^k doublings +
PRAC chains with the prime-power repeat rule) and the engine's stage-1
kernel replays it over the [S, 2, rows, B] register file: K1 over digit
planes (limbs/kernels.tape, rows = NW) or K10 over residue planes
(limbs/rns_kernels.tape, rows = 2K+1).  Prime chunking follows the
reference's PRIME_RANGE protocol so checkpoints land at the same prime
boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .params import MontyCtx
from .primes import PrimeStream

from .curve import ops, prac
from .limbs import layout


@dataclasses.dataclass
class Stage1State:
    """Device state for a batch of curves: point register file + curve const."""
    pts: torch.Tensor       # [S, 2, rows, B]
    s_const: torch.Tensor   # [rows, B]  (A+2)/4 in Montgomery form


def pack_state(ctx: MontyCtx, xs: List[int], zs: List[int], ss: List[int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The host arrays of a batch's state: the point file [S, 2, NW, B] with
    (X, Z) in slot 0, and the curve constant [NW, B]."""
    p = ctx.p
    b = len(xs)
    pts = np.zeros((ops.NUM_SLOTS, 2, p.nw, b), dtype=np.int32)
    pts[0, 0] = layout.pack_batch(xs, p.w, p.nw)
    pts[0, 1] = layout.pack_batch(zs, p.w, p.nw)
    return pts, layout.pack_batch(ss, p.w, p.nw)


@dataclasses.dataclass
class Stage1Chunk:
    lo: int
    hi: int
    last_prime: int      # largest prime consumed (for checkpoint labels)
    is_final: bool
    ptadds: int = 0      # ADD steps executed (ecm_work counters)
    ptdups: int = 0
    numprimes: int = 0


def run_stage1(states: Sequence[Stage1State], run_tapes: Sequence[Callable],
               b1: int, stream: PrimeStream, *, full_prac: bool = False
               ) -> Iterator[Stage1Chunk]:
    """Yield each prime chunk after its tape has run; the caller
    checkpoints between chunks.  Each chunk's tape is planned once and
    replayed on every shard: run_tapes[i](pts, tape, s_const) is the
    engine's tape kernel call of shard i, which updates states[i]'s point
    file in place.  full_prac plans the tapes with all nine PRAC rules
    (curve/prac.py)."""
    first = True
    for lo, hi, primes in stream.chunks(0, b1):
        sel = primes[primes < b1]
        tape = prac.stage1_tape(sel, b1, include_two=first, full=full_prac)
        first = False
        if tape.shape[0]:
            for state, run_tape in zip(states, run_tapes):
                run_tape(state.pts, tape, state.s_const)
        last_prime = int(sel[-1]) if sel.size else 2
        ops_col = tape[:, 0] if tape.shape[0] else np.zeros(0, np.int32)
        yield Stage1Chunk(lo=lo, hi=hi, last_prime=last_prime,
                          is_final=hi >= b1,
                          ptadds=int(np.count_nonzero(ops_col == ops.OP_ADD)),
                          ptdups=int(np.count_nonzero(ops_col == ops.OP_DUP)),
                          numprimes=int(sel.size))


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
