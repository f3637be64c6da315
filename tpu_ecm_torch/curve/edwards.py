"""Twisted Edwards a=-1 stage 1: curve construction, int oracle, and the
signed-window (wNAF) tape planner.

This is a capability the reference does not have — its stage 1 is Montgomery
x-only PRAC (~8.7 weighted muls/bit, reference ecm.c:565-884,1806-1854).
Extended-coordinate a=-1 twisted Edwards arithmetic (Hisil-Wong-Carter-Dawson
2008 formulas) with a width-w signed sliding window costs
  DBL = 3M+4S (+1M for T before an add), mixed ADD = 6M
for ~1/(w+1) adds/bit: ~25% fewer weighted muls per exponent bit.  The same
host-plans-tape / device-replays-scan architecture as the PRAC path applies:
the whole of stage 1 is ONE scalar s = prod p^k (p^k < B1) and its wNAF
digit string depends only on B1 — planned once per run on the host and
replayed over the curve batch by the K9 kernel (csrc/ed_tape.cu).

Curve family (one curve per sigma seed, guaranteed full rational 2-torsion,
so 4 | group order mod every p):
  the quadric y0^2 + m^2 = x0^2 + 1 is rationally parameterized by lines
  through (1,1,1); the line with direction (1, sigma, sigma+2) gives
    x0 = (2s-1)/(4s+3),  y0 = (4s+1)/(4s+3),  m = (2s+3)/(4s+3)
  and then  d = -(m/(x0*y0))^2  puts (x0, y0) on  -x^2 + y^2 = 1 + d x^2 y^2
  with -1/d a rational square, which makes BOTH points of order 2 at infinity
  rational => torsion contains Z/2 x Z/2.  (Suyama guarantees 12 | order; the
  4-vs-12 gap is an explicit, measured trade against the cheaper arithmetic —
  see BENCH_NOTES.md.)

Stage-2 handoff: the curve is birationally equivalent to the Montgomery curve
  A = 2(1+d)/(1-d) ... for a=-1:  A = 2(1-d)/(1+d),  (A+2)/4 = 1/(1+d)
with x-coordinate u = (Z+Y)/(Z-Y) projectively, so the existing Montgomery
stage 2 (stage2/) runs unchanged on (U : W) = (Z+Y : Z-Y).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..params import MontyCtx
from .suyama import FactorFoundDuringBuild

# tape opcodes (2-int entries: op, arg)
ED_DBL = 0    # doubling, T output skipped
ED_DBLT = 1   # doubling with T output (precedes an add)
ED_ADD = 2    # acc += table[arg]
ED_SUB = 3    # acc -= table[arg]
ED_NOP = 4

DEFAULT_W = 6  # signed window width: 2^(w-2) = 16 table points, ~1/7 adds/bit


@dataclasses.dataclass(frozen=True)
class EdCurveInit:
    sigma: int
    x0: int        # base point affine x (canonical residue)
    y0: int        # base point affine y
    d: int         # curve constant: -x^2 + y^2 = 1 + d x^2 y^2
    s_mont: int    # (A+2)/4 = 1/(1+d) of the equivalent Montgomery curve,
                   # in Montgomery form (feeds stage 2 unchanged)
    d2_mont: int   # 2d in Montgomery form (table caching constant)


def _inv_or_factor(x: int, n: int, sigma: int) -> int:
    g = math.gcd(x % n, n)
    if g != 1:
        raise FactorFoundDuringBuild(g if g != n else 0, sigma)
    return pow(x, -1, n)


def build_one_curve(ctx: MontyCtx, sigma: int) -> EdCurveInit:
    n = ctx.n_int
    den = _inv_or_factor(4 * sigma + 3, n, sigma)
    x0 = (2 * sigma - 1) * den % n
    y0 = (4 * sigma + 1) * den % n
    m = (2 * sigma + 3) * den % n
    t = x0 * y0 % n * _inv_or_factor(m, n, sigma) % n
    d = -pow(_inv_or_factor(t, n, sigma), 2, n) % n
    # degenerate curves: d=0 (impossible: -1/t^2), d=a=-1 (t^2=1), or the
    # exceptional base point y0^2 = x0^2 (doubling hits the point at infinity)
    if d == (n - 1) % n or (y0 * y0 - x0 * x0) % n == 0:
        raise FactorFoundDuringBuild(0, sigma)
    s_const = _inv_or_factor(1 + d, n, sigma)
    return EdCurveInit(sigma=sigma, x0=x0, y0=y0, d=d,
                       s_mont=ctx.to_mont_int(s_const),
                       d2_mont=ctx.to_mont_int(2 * d % n))


# ---------------------------------------------------------------------------
# int oracle: extended coordinates (X:Y:Z:T), T = XY/Z, on -x^2+y^2=1+dx^2y^2
# ---------------------------------------------------------------------------

def oracle_dbl(P, n: int):
    """dbl-2008-hwcd with a=-1 folded in."""
    X1, Y1, Z1, _ = P
    A = X1 * X1 % n
    B = Y1 * Y1 % n
    C = 2 * Z1 * Z1 % n
    E = ((X1 + Y1) * (X1 + Y1) - A - B) % n
    G = (B - A) % n
    F = (G - C) % n
    H = (-(A + B)) % n
    return (E * F % n, G * H % n, F * G % n, E * H % n)


def _finish_add(A, B, C, D, n, d2=None):
    if d2 is not None:
        C = C * d2 % n
    E = (B - A) % n
    H = (B + A) % n
    F = (D - C) % n
    G = (D + C) % n
    return (E * F % n, G * H % n, F * G % n, E * H % n)


def oracle_add_d(P1, P2, d: int, n: int):
    X1, Y1, Z1, T1 = P1
    X2, Y2, Z2, T2 = P2
    A = (Y1 - X1) * (Y2 - X2) % n
    B = (Y1 + X1) * (Y2 + X2) % n
    C = T1 * T2 % n
    D = 2 * Z1 * Z2 % n
    return _finish_add(A, B, C, D, n, d2=2 * d % n)


def oracle_neg(P, n: int):
    X, Y, Z, T = P
    return ((-X) % n, Y, Z, (-T) % n)


def oracle_scalar_mul(k: int, x0: int, y0: int, d: int, n: int):
    """Windowed scalar mult on the oracle — the stage-1 semantic ground
    truth (also validates the wNAF digits independently of the tape)."""
    P = (x0, y0, 1, x0 * y0 % n)
    digits = wnaf_digits(k, DEFAULT_W)
    table = [P]  # odd multiples: [1]P, [3]P, ...
    P2 = oracle_dbl(P, n)
    for _ in range((1 << (DEFAULT_W - 2)) - 1):
        table.append(oracle_add_d(table[-1], P2, d, n))
    acc = None
    for v in digits[::-1]:  # MSB first
        if acc is not None:
            acc = oracle_dbl(acc, n)
        if v:
            Q = table[(abs(v) - 1) // 2]
            Q = Q if v > 0 else oracle_neg(Q, n)
            acc = Q if acc is None else oracle_add_d(acc, Q, d, n)
    return acc


# ---------------------------------------------------------------------------
# stage-1 scalar and wNAF tape planning (host, cached per B1)
# ---------------------------------------------------------------------------

def stage1_scalar(primes: Sequence[int], b1: int,
                  include_two: bool = True) -> int:
    """s = 2^k * prod p^k with the reference's repeat rules
    (2^k: q<B1 doublings reference ecm.c:1814-1822; odd p: multiplicity
    max k with p^k < B1, ecm.c:1824-1843) — the same group-order coverage as
    the PRAC path, so factor-finding power is identical per curve order."""
    vals: List[int] = []
    if include_two:
        q = 2
        while q < b1:
            vals.append(2)
            q *= 2
    for p in primes:
        p = int(p)
        if p == 2 or p >= b1:
            continue
        c = p
        vals.append(p)
        while c * p < b1:
            c *= p
            vals.append(p)
    # balanced product tree
    if not vals:
        return 1
    while len(vals) > 1:
        vals = [vals[i] * vals[i + 1] for i in range(0, len(vals) - 1, 2)] \
            + ([vals[-1]] if len(vals) & 1 else [])
    return vals[0]


def wnaf_digits(s: int, w: int = DEFAULT_W) -> np.ndarray:
    """Width-w NAF of s, little-endian int8 digits (odd, |v| < 2^(w-1), at
    most one nonzero in any w consecutive positions).  Streamed over 64-bit
    words so multi-hundred-megabit scalars stay O(bits)."""
    assert s > 0 and 2 <= w <= 8
    nbits = s.bit_length()
    nwords = (nbits + 63) // 64 + 1     # +1 word of carry headroom
    words = np.frombuffer(s.to_bytes(nwords * 8, "little"),
                          dtype=np.uint64).copy()
    top = nwords * 64
    digits = np.zeros(top + 1, dtype=np.int8)
    half = 1 << (w - 1)
    full = 1 << w
    M64 = (1 << 64) - 1

    def get_window(i: int, width: int) -> int:
        wi, bi = divmod(i, 64)
        v = int(words[wi]) >> bi
        have = 64 - bi
        while have < width and wi + 1 < nwords:
            wi += 1
            v |= int(words[wi]) << have
            have += 64
        return v & ((1 << width) - 1)

    def add_carry_at(i: int) -> None:
        wi, bi = divmod(i, 64)
        c = 1 << bi
        while wi < nwords:
            tot = int(words[wi]) + c
            words[wi] = np.uint64(tot & M64)
            if tot <= M64:
                return
            c = 1
            wi += 1
        raise AssertionError("wNAF carry past headroom word")

    def clear_window(i: int) -> None:
        for j in range(w):
            wi, bi = divmod(i + j, 64)
            if wi < nwords:
                words[wi] &= np.uint64(M64 ^ (1 << bi))

    i = 0
    while i < top:
        if not get_window(i, 1):
            i += 1
            continue
        v = get_window(i, w)
        clear_window(i)
        if v >= half:
            v -= full
            # digit v < 0: the cleared window held (v + 2^w) mod 2^w, so
            # account for the borrowed 2^w with a carry into bit i+w
            add_carry_at(i + w)
        digits[i] = v
        i += w
    return _trim(digits)


def _trim(digits: np.ndarray) -> np.ndarray:
    nz = np.nonzero(digits)[0]
    return digits[:nz[-1] + 1] if nz.size else digits[:0]


def digits_to_int(digits: np.ndarray) -> int:
    """Reconstruct the scalar (test helper)."""
    s = 0
    for v in digits[::-1]:
        s = 2 * s + int(v)
    return s


def tape_from_digits(digits: np.ndarray) -> Tuple[np.ndarray, int]:
    """MSB-first replay tape [(op, arg)] and the leading digit (the
    accumulator is initialized to sign*table[arg] on the host, so the tape
    starts after it).  The DBL immediately before every add is promoted to
    ED_DBLT (adds consume the accumulator's T)."""
    idx = np.nonzero(digits)[0]
    assert idx.size, "empty scalar"
    lead = int(digits[idx[-1]])
    ops: List[Tuple[int, int]] = []
    pos = int(idx[-1])
    for j in idx[:-1][::-1]:
        v = int(digits[j])
        ndbl = pos - int(j)
        ops.extend([(ED_DBL, 0)] * (ndbl - 1))
        ops.append((ED_DBLT, 0))
        ops.append((ED_ADD if v > 0 else ED_SUB, (abs(v) - 1) // 2))
        pos = int(j)
    ops.extend([(ED_DBL, 0)] * pos)
    tape = np.asarray(ops, dtype=np.int32) if ops else \
        np.zeros((0, 2), dtype=np.int32)
    return tape, lead


def stage1_tape(primes: Sequence[int], b1: int,
                include_two: bool = True) -> Tuple[np.ndarray, int]:
    """(tape, leading digit) of the width-DEFAULT_W wNAF of a stage-1 prime
    set's scalar.  The scalar factorizes over prime chunks exactly like the
    PRAC schedule (s = s_chunk0 * s_chunk1 * ...), so the driver replays
    one tape per chunk with the window table rebuilt from the
    chunk-boundary point — giving Edwards mode the same per-1e8-primes
    checkpoint cadence as the reference (reference ecm.c:1236-1312).
    `include_two` adds the 2^k part (first chunk only)."""
    return tape_from_digits(wnaf_digits(stage1_scalar(primes, b1,
                                                      include_two)))


def build_batch_tables(ctx: MontyCtx, curves: Sequence[EdCurveInit],
                       w: int = DEFAULT_W,
                       base_pts: Optional[List[Tuple[int, int]]] = None):
    """Window tables for a curve batch, host-side and exact: per lane the
    odd multiples P, 3P, ..., (2^(w-1)-1)P in extended coordinates, all
    Z-normalized with ONE modular inverse for the whole batch (Montgomery's
    trick over every (lane, entry) Z — the same one-inversion discipline as
    stage 2).  Returns
      acc0   [4, NW, B]  accumulator init = table[lead] (set by the caller)
             — here: plain normalized entries as int lists [Tp][B][4]
      cached [Tp, 3, NW, B] packed planes (Y-X, Y+X, 2dT) in Montgomery form
    A Z that shares a factor with n is harvested as a found factor.

    `base_pts` overrides each curve's base point with an affine (x, y)
    (used at prime-chunk boundaries: the next chunk's table is built from
    the normalized chunk-boundary accumulator, not from the original base).
    """
    from ..limbs import layout as _layout   # local import: keep host module
    import numpy as _np                     # importable without jax
    n = ctx.n_int
    tp = 1 << (w - 2)
    b = len(curves)
    pts: List[List[tuple]] = []
    for i, c in enumerate(curves):
        x0, y0 = base_pts[i] if base_pts is not None else (c.x0, c.y0)
        P1 = (x0, y0, 1, x0 * y0 % n)
        P2 = oracle_dbl(P1, n)
        row = [P1]
        for _ in range(tp - 1):
            row.append(oracle_add_d(row[-1], P2, c.d, n))
        pts.append(row)
    # batch inversion of all Z's
    zs = [pts[i][j][2] % n for i in range(b) for j in range(tp)]
    pref = [1] * (len(zs) + 1)
    for i, z in enumerate(zs):
        pref[i + 1] = pref[i] * z % n
    g = math.gcd(pref[-1], n)
    if g != 1:
        for c, row in zip(curves, pts):
            for P in row:
                gz = math.gcd(P[2] % n, n)
                if gz != 1:
                    raise FactorFoundDuringBuild(gz if gz != n else 0,
                                                 c.sigma)
        raise FactorFoundDuringBuild(0, curves[0].sigma)
    inv = pow(pref[-1], -1, n)
    zinvs = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        zinvs[i] = pref[i] * inv % n
        inv = inv * zs[i] % n
    k0 = _np.zeros((tp, ctx.p.nw, b), _np.int32)
    k1 = _np.zeros_like(k0)
    k2 = _np.zeros_like(k0)
    for j in range(tp):
        c0: List[int] = []
        c1: List[int] = []
        c2: List[int] = []
        for i, c in enumerate(curves):
            X, Y, _, T = pts[i][j]
            zi = zinvs[i * tp + j]
            x, y, t = X * zi % n, Y * zi % n, T * zi % n
            c0.append(ctx.to_mont_int((y - x) % n))
            c1.append(ctx.to_mont_int((y + x) % n))
            c2.append(ctx.to_mont_int(2 * c.d * t % n))
            pts[i][j] = (x, y, 1, t)
        k0[j] = _layout.pack_batch(c0, ctx.p.w, ctx.p.nw)
        k1[j] = _layout.pack_batch(c1, ctx.p.w, ctx.p.nw)
        k2[j] = _layout.pack_batch(c2, ctx.p.w, ctx.p.nw)
    cached = _np.stack([_np.stack([k0[j], k1[j], k2[j]]) for j in range(tp)])
    return pts, cached


def init_accumulator(ctx: MontyCtx, pts: List[List[tuple]], lead: int):
    """Accumulator planes [4, NW, B] = normalized table entry for the
    leading wNAF digit (the same digit for every lane: one shared scalar)."""
    from ..limbs import layout as _layout
    import numpy as _np
    assert lead > 0 and lead % 2 == 1
    j = (lead - 1) // 2
    b = len(pts)
    acc = _np.zeros((4, ctx.p.nw, b), _np.int32)
    for coord in range(4):
        vals = [ctx.to_mont_int(pts[i][j][coord]) for i in range(b)]
        acc[coord] = _layout.pack_batch(vals, ctx.p.w, ctx.p.nw)
    return acc


def to_montgomery_xz(P, n: int) -> Tuple[int, int]:
    """(X:Y:Z:T) -> projective Montgomery x-coordinate (U : W) on the
    equivalent curve: u = (1+y)/(1-y) = (Z+Y)/(Z-Y)."""
    X, Y, Z, _ = P
    return ((Z + Y) % n, (Z - Y) % n)
