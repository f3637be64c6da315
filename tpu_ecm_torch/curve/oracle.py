"""Pure-Python integer oracles for the device curve path.

Copy of tpu_ecm/curve/oracle.py over this package's curve/ops opcodes.

This is the residue-level reference implementation the C reference lacks
(SURVEY.md section 4): the same ADD/DUP tape semantics executed with exact
Python ints in the Montgomery domain, so device results must match
*canonically* (value mod n), independent of radix, batching, or sharding.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..params import MontyCtx
from .ops import NUM_SLOTS, OP_ADD, OP_DUP


class IntDomain:
    """Montgomery-domain modular ops on Python ints matching the device ops
    semantics: mul = a*b*R^-1 mod n (generic) or a*b mod M (Mersenne)."""

    def __init__(self, ctx: MontyCtx):
        self.n = ctx.n_int
        if ctx.is_mersenne:
            self.rinv = 1
        else:
            self.rinv = pow(ctx.p.R, -1, self.n)

    def mul(self, a: int, b: int) -> int:
        return (a * b * self.rinv) % self.n

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.n

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.n


def xdbl_int(dom: IntDomain, X: int, Z: int, s: int) -> Tuple[int, int]:
    v = dom.mul(dom.sub(X, Z), dom.sub(X, Z))
    u = dom.mul(dom.add(X, Z), dom.add(X, Z))
    x2 = dom.mul(u, v)
    w = dom.sub(u, v)
    t = dom.mul(w, s)
    z2 = dom.mul(dom.add(t, v), w)
    return x2, z2


def xadd_int(dom: IntDomain, X1, Z1, X2, Z2, Xd, Zd) -> Tuple[int, int]:
    u = dom.mul(dom.sub(X1, Z1), dom.add(X2, Z2))
    v = dom.mul(dom.add(X1, Z1), dom.sub(X2, Z2))
    t1 = dom.mul(dom.add(u, v), dom.add(u, v))
    t2 = dom.mul(dom.sub(u, v), dom.sub(u, v))
    return dom.mul(t1, Zd), dom.mul(t2, Xd)


def run_tape_int(ctx: MontyCtx, tape: Sequence[Sequence[int]],
                 x0: int, z0: int, s: int) -> List[Tuple[int, int]]:
    """Replay a tape on slot-0 point (x0, z0); returns all slots."""
    dom = IntDomain(ctx)
    slots: List[Tuple[int, int]] = [(0, 0)] * NUM_SLOTS
    slots[0] = (x0 % ctx.n_int, z0 % ctx.n_int)
    for op, dst, a, b, c in tape:
        if op == OP_DUP:
            slots[dst] = xdbl_int(dom, *slots[a], s)
        elif op == OP_ADD:
            xa, za = slots[a]
            xb, zb = slots[b]
            xd, zd = slots[c]
            slots[dst] = xadd_int(dom, xa, za, xb, zb, xd, zd)
        else:
            raise ValueError(f"bad opcode {op}")
    return slots


def ladder_int(dom: IntDomain, X: int, Z: int, s: int, k: int
               ) -> Tuple[int, int]:
    """Independent textbook x-only ladder for cross-checks (different chain
    than PRAC; agrees projectively)."""
    if k == 1:
        return X, Z
    x1, z1 = X, Z
    x2, z2 = xdbl_int(dom, X, Z, s)
    for i in range(k.bit_length() - 2, -1, -1):
        if (k >> i) & 1:
            x1, z1 = xadd_int(dom, x1, z1, x2, z2, X, Z)
            x2, z2 = xdbl_int(dom, x2, z2, s)
        else:
            x2, z2 = xadd_int(dom, x1, z1, x2, z2, X, Z)
            x1, z1 = xdbl_int(dom, x1, z1, s)
    return x1, z1
