"""Host-side PRAC / Lucas-chain planner: primes -> ADD/DUP tapes.

JAX-free copy of tpu_ecm/curve/prac.py, taking its opcodes from this
package's curve/ops.py; tests/test_torch_curve.py keeps the tapes equal.

Re-derivation of the reference prac()/lucas_cost() (same golden-ratio
candidate table, same active condition set 3/4/5/9 — the non-ORIG_PRAC
variant, reference ecm.c:459-884) emitting a register-renamed
instruction tape instead of executing point ops inline.  Pointer swaps in
the reference become virtual->physical renaming here, so the device sees a
pure ADD/DUP stream (see curve/ops.py).

Tape entry: (op, dst, a, b, c) int32.
  DUP: dst := 2 * pts[a]
  ADD: dst := pts[a] + pts[b]  with difference point pts[c]
The device executor reads all inputs before writing, so dst may alias any
input slot.

Chains depend only on the prime, so the whole stage-1 tape for a given B1 is
curve- and modulus-independent.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .ops import NUM_SLOTS, OP_ADD, OP_DUP

ADD_COST = 5.5
DUP_COST = 4.5

# 1/val[0] is the golden ratio; the others perturb one continued-fraction
# term (same 10-entry table as reference ecm.c:473-477)
VAL = (0.61803398874989485, 0.72360679774997897, 0.58017872829546410,
       0.63283980608870629, 0.61242994950949500, 0.62018198080741576,
       0.61721461653440386, 0.61834711965622806, 0.61791440652881789,
       0.61807966846989581)


def lucas_cost(n: int, v: float) -> float:
    """Weighted mul count of the PRAC chain for n at ratio v (branch order
    identical to prac_tape)."""
    d = n
    r = int(d * v + 0.5)
    if r >= n:
        return ADD_COST * n
    d = n - r
    e = 2 * r - n
    c = DUP_COST + ADD_COST
    while d != e:
        if d < e:
            d, e = e, d
        if (d + 3) // 4 <= e:
            d -= e
            c += ADD_COST
        elif (d + e) % 2 == 0:
            d = (d - e) // 2
            c += ADD_COST + DUP_COST
        elif d % 2 == 0:
            d //= 2
            c += ADD_COST + DUP_COST
        else:
            e //= 2
            c += ADD_COST + DUP_COST
    if d != 1:
        return 999999999.0
    return c


def best_ratio(n: int) -> float:
    """argmin over the 10 candidates (strict-improvement tie-breaking as in
    reference ecm.c:574-582)."""
    cmin = ADD_COST * n
    besti = 0
    for i, v in enumerate(VAL):
        c = lucas_cost(n, v)
        if c < cmin:
            cmin = c
            besti = i
    return VAL[besti]


class _RegFile:
    """Virtual {P,A,B,C,T} -> physical slot renaming with aliasing.

    Slot 0 always holds the caller's point P (and receives the final
    result); writes never target slot 0 except the explicit final ADD.
    """

    def __init__(self):
        self.v2p = {"A": None, "B": 0, "C": 0, "T": None}

    def slot(self, v: str) -> int:
        s = self.v2p[v]
        assert s is not None, f"read of unset register {v}"
        return s

    def _free_slot(self) -> int:
        used = {s for s in self.v2p.values() if s is not None}
        for s in range(1, NUM_SLOTS):
            if s not in used:
                return s
        raise RuntimeError("out of point slots")

    def write_target(self, v: str) -> int:
        """Physical slot for writing virtual v: reuse its exclusive slot,
        else allocate a free one (device ops read-before-write, so dst may
        alias an input)."""
        cur = self.v2p[v]
        shared = sum(1 for s in self.v2p.values() if s == cur) > 1
        if cur is None or cur == 0 or shared:
            cur = self._free_slot()
        self.v2p[v] = cur
        return cur

    def rename(self, mapping):
        """Parallel rename: dst virtual takes src virtual's slot."""
        old = dict(self.v2p)
        for dst, src in mapping.items():
            self.v2p[dst] = old[src]


def prac_tape(p: int, out: List[Tuple[int, int, int, int, int]]) -> None:
    """Append the PRAC chain for (prime) p to the tape.  P is slot 0 in and
    out.  Mirrors reference ecm.c:565-884 step for step."""
    v = best_ratio(p)
    r = int(p * v + 0.5)
    d = p - r
    e = 2 * r - p

    rf = _RegFile()
    # A = 2P; B = C = P  (reference ecm.c:601-613)
    out.append((OP_DUP, rf.write_target("A"), 0, 0, 0))
    while d != e:
        if d < e:
            d, e = e, d
            rf.rename({"A": "B", "B": "A"})
        if (d + 3) // 4 <= e:
            # condition 3: T = B + A (diff C); then rotate (B,T,C) <- (T,C,B)
            d -= e
            sb, sa, sc = rf.slot("B"), rf.slot("A"), rf.slot("C")
            dst = rf.write_target("T")
            out.append((OP_ADD, dst, sb, sa, sc))
            rf.rename({"B": "T", "T": "C", "C": "B"})
        elif (d + e) % 2 == 0:
            # condition 4: B = B + A (diff C); A = 2A
            d = (d - e) // 2
            sb, sa, sc = rf.slot("B"), rf.slot("A"), rf.slot("C")
            dst = rf.write_target("B")
            out.append((OP_ADD, dst, sb, sa, sc))
            out.append((OP_DUP, rf.write_target("A"), sa, 0, 0))
        elif d % 2 == 0:
            # condition 5: C = C + A (diff B); A = 2A
            d //= 2
            sc, sa, sb = rf.slot("C"), rf.slot("A"), rf.slot("B")
            dst = rf.write_target("C")
            out.append((OP_ADD, dst, sc, sa, sb))
            out.append((OP_DUP, rf.write_target("A"), sa, 0, 0))
        else:
            # condition 9: C = C + B (diff A); B = 2B
            e //= 2
            sc, sb, sa = rf.slot("C"), rf.slot("B"), rf.slot("A")
            dst = rf.write_target("C")
            out.append((OP_ADD, dst, sc, sb, sa))
            out.append((OP_DUP, rf.write_target("B"), sb, 0, 0))
    assert d == 1, f"PRAC chain failure for {p}"
    # final: P = A + B (diff C)  (reference ecm.c:868-873)
    out.append((OP_ADD, 0, rf.slot("A"), rf.slot("B"), rf.slot("C")))


def validate_tape(tape, k: int) -> None:
    """Symbolically execute a chain tape over sign-free integer multiples
    and assert every differential add is legal: xADD(X, Y, D) computes
    X+Y given D = +-(X-Y), or X-Y given D = +-(X+Y); anything else is a
    planner bug.  Slot 0 starts as [1]P and must end as [k]P."""
    mult = [None] * NUM_SLOTS
    mult[0] = 1
    for entry in tape:
        op, dst, a, b, c = (int(x) for x in entry)
        if op == OP_DUP:
            assert mult[a] is not None
            mult[dst] = 2 * mult[a]
        elif op == OP_ADD:
            x, y, dd = mult[a], mult[b], mult[c]
            assert None not in (x, y, dd), (x, y, dd)
            if dd == abs(x - y):
                mult[dst] = x + y
            elif dd == x + y:
                mult[dst] = abs(x - y)
            else:
                raise AssertionError(
                    f"illegal diff: |{x}-{y}| or {x}+{y} != {dd}")
        else:  # NOP / padding
            mult[dst] = mult[a]
    assert mult[0] == k, (mult[0], k)


def ladder_tape(k: int, out: List[Tuple[int, int, int, int, int]]) -> None:
    """Plain binary ladder [k]P for arbitrary k >= 1 (next_pt_vec analog,
    reference ecm.c:886-976).  P in slot 0 in and out."""
    if k == 1:
        return
    if k == 2:
        out.append((OP_DUP, 0, 0, 0, 0))
        out.append((-1, 0, 0, 0, 0))
        return
    # pt1 = P (slot 0), pt2 = 2P (slot 2); invariant pt2 - pt1 = original P,
    # which must stay readable in slot 0 as the difference point — so pt1
    # moves to slot 1 on its first write and slot 0 is never written.
    out.append((OP_DUP, 2, 0, 0, 0))
    cur1, cur2 = 0, 2
    mask = 1 << (k.bit_length() - 2)
    while mask:
        bit = k & mask
        if bit:
            # pt1 = pt1 + pt2 (diff P); pt2 = 2*pt2
            dst1 = 1 if cur1 == 0 else cur1
            out.append((OP_ADD, dst1, cur1, cur2, 0))
            cur1 = dst1
            out.append((OP_DUP, cur2, cur2, 0, 0))
        else:
            # pt2 = pt1 + pt2 (diff P); pt1 = 2*pt1
            out.append((OP_ADD, cur2, cur1, cur2, 0))
            dst1 = 1 if cur1 == 0 else cur1
            out.append((OP_DUP, dst1, cur1, 0, 0))
            cur1 = dst1
        mask >>= 1
    # result is pt1; move into slot 0 via a final doubling-free trick is not
    # available, so emit ADD(P; pt1, pt2, diff ...)?  No — just record: the
    # caller reads the result from the returned slot.
    out.append((-1, cur1, 0, 0, 0))  # sentinel: result slot marker


def ladder_pair_tape(k: int) -> Tuple[np.ndarray, int, int]:
    """Binary ladder yielding BOTH neighbours: returns (tape, slot_k,
    slot_k1) with [k]P in slot_k and [k+1]P in slot_k1 after execution (P in
    slot 0).  Used to seed the stage-2 giant-step chain with
    ([2*amin-2]Pd, [2*amin-1]Pd) from one ladder over Pd."""
    if k < 1:
        raise ValueError("k must be >= 1")
    if k == 1:
        return np.asarray([(OP_DUP, 2, 0, 0, 0)], dtype=np.int32), 0, 2
    if k == 2:
        return np.asarray([(OP_DUP, 2, 0, 0, 0),
                           (OP_ADD, 1, 2, 0, 0)], dtype=np.int32), 2, 1
    out: List[Tuple[int, int, int, int, int]] = []
    ladder_tape(k, out)
    assert out and out[-1][0] == -1
    cur1 = out[-1][1]
    out = out[:-1]
    # pt2 (= [k+1]P) lives in slot 2 throughout ladder_tape's loop
    return np.asarray(out, dtype=np.int32), cur1, 2


def pad_tape(tape: np.ndarray, multiple: int) -> np.ndarray:
    """Pad a tape to a length multiple with NOP entries (dst = NUM_SLOTS-1,
    src slot 0) so executors compile one shape per size class.  Safe whenever
    slot NUM_SLOTS-1 is not a live result slot."""
    from .ops import OP_NOP
    t = tape.shape[0]
    npad = (-t) % multiple
    if npad == 0:
        return tape
    nop = np.tile(np.asarray([[OP_NOP, NUM_SLOTS - 1, 0, 0, 0]],
                             dtype=np.int32), (npad, 1))
    return np.concatenate([tape, nop], axis=0)


def ladder_tape_result_slot(k: int) -> Tuple[np.ndarray, int]:
    """Build a standalone ladder tape and return (tape[T,5] int32, result_slot)."""
    ops: List[Tuple[int, int, int, int, int]] = []
    if k == 1:
        return np.zeros((0, 5), dtype=np.int32), 0
    ladder_tape(k, ops)
    if ops and ops[-1][0] == -1:
        res = ops[-1][1]
        ops = ops[:-1]
    else:
        res = 0
    return np.asarray(ops, dtype=np.int32), res


def stage1_powers_of_two(b1: int) -> int:
    """Number of leading doublings: 2,4,8,... while q < B1
    (reference ecm.c:1814-1822)."""
    k, q = 0, 2
    while q < b1:
        k += 1
        q *= 2
    return k


def stage1_tape(primes: Sequence[int], b1: int, *, include_two: bool = True,
                allow_native: bool = True) -> np.ndarray:
    """Full stage-1 tape: leading 2^k doublings (if include_two), then for
    each odd prime p <= primes in the list, PRAC(p) repeated per the prime-
    power rule `do {prac} while (c*q) < B1` (reference ecm.c:1824-1843).

    Dispatches to the C++ planner (tpu_ecm/native/planner.cpp, bit-identical
    output) when available.
    """
    if allow_native:
        try:
            from tpu_ecm.native import lib as _native
            if _native.available():
                return _native.stage1_tape(np.asarray(primes, np.uint64),
                                           b1, include_two)
        except Exception:
            pass
    ops: List[Tuple[int, int, int, int, int]] = []
    if include_two:
        for _ in range(stage1_powers_of_two(b1)):
            ops.append((OP_DUP, 0, 0, 0, 0))
    for q in primes:
        q = int(q)
        if q == 2 or q >= b1:
            continue
        c = 1
        while True:
            prac_tape(q, ops)
            c *= q
            if c * q >= b1:
                break
    if not ops:
        return np.zeros((0, 5), dtype=np.int32)
    return np.asarray(ops, dtype=np.int32)

