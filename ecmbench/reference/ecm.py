"""The plain reference of one ECM curve, in Python ints and NumPy.

It imports nothing of the program under test.  From sigma it builds the
Suyama curve (GMP-ECM's parameterization 0), multiplies the start point by
every prime power p^e <= B1 with a Montgomery ladder (a chain of its own,
not the program's PRAC chains, so stage-1 points agree projectively: the
affine x is compared), and takes the stage-2 product

    acc = prod over the plan's entries of  x([m*D]Q) - x([u]Q)   (mod n)

over a stage-2 plan handed to it as data: the program's pairmap, which
this module judges first (every prime of the stage-2 range must be
m*D - u or m*D + u of some entry; `plan_uncovered`).  The plan encoding is
avx-ecm's pair() output (ecm.c:2559-2910): per chunk, (v, u) entries with
(0, 0) sentinels that advance the window base amin by U; an entry names
the giant multiple m = v + amin.

A control (`skip_last_prime`, `drop_entry`) breaks one guarantee of the
configuration on purpose: stage 1 without the largest prime below B1, or
stage 2 without one entry of the plan.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Found(Exception):
    """A gcd with n that is neither 1 nor n: a factor."""

    def __init__(self, factor: int, where: str):
        super().__init__(f"factor {factor} at {where}")
        self.factor = factor
        self.where = where


def primes_upto(m: int) -> np.ndarray:
    """The primes <= m (sieve of Eratosthenes, int64)."""
    if m < 2:
        return np.zeros(0, np.int64)
    sieve = np.ones(m + 1, dtype=bool)
    sieve[:2] = False
    for p in range(2, math.isqrt(m) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    return np.nonzero(sieve)[0].astype(np.int64)


def inverse(x: int, n: int, where: str) -> int:
    g = math.gcd(x, n)
    if g != 1:
        raise Found(g, where)
    return pow(x, -1, n)


def suyama(n: int, sigma: int) -> Tuple[int, int]:
    """(x0, s) of sigma's curve: u = sigma^2 - 5, v = 4 sigma, the start
    point's affine x = u^3 / v^3 and s = (A + 2) / 4 =
    (v - u)^3 (3u + v) / (16 u^3 v), all mod n (GMP-ECM, param 0)."""
    u = (sigma * sigma - 5) % n
    v = 4 * sigma % n
    u3 = pow(u, 3, n)
    x0 = u3 * inverse(pow(v, 3, n), n, "curve") % n
    s = (pow(v - u, 3, n) * (3 * u + v) % n
         * inverse(16 * u3 * v % n, n, "curve") % n)
    return x0, s


def stage1_scalar(b1: int, skip_last_prime: bool = False) -> int:
    """The product of p^e over primes p < B1, e the largest with p^e < B1
    (the same as p^e <= B1 when B1 is no prime power, as in every cell)."""
    ps = [int(p) for p in primes_upto(b1 - 1)]
    if skip_last_prime:
        ps = ps[:-1]
    k = 1
    for p in ps:
        q = p
        while q * p < b1:
            q *= p
        k *= q
    return k


def ladder(n: int, x0: int, s: int, k: int) -> Tuple[int, int]:
    """(X, Z) of [k](x0 : 1) on By^2 = x^3 + Ax^2 + x, s = (A+2)/4: the
    Montgomery ladder, 5 + 5 products a bit.  k >= 1."""
    X0, Z0 = x0, 1
    # [2]P
    t = (x0 + 1) * (x0 + 1) % n
    d = (x0 - 1) * (x0 - 1) % n
    w = t - d
    X1, Z1 = t * d % n, w * (d + s * w % n) % n
    for bit in bin(k)[3:]:
        # the add of the two, their difference (x0 : 1)
        a = (X0 - Z0) * (X1 + Z1) % n
        b = (X0 + Z0) * (X1 - Z1) % n
        ax = (a + b) * (a + b) % n
        az = x0 * ((a - b) * (a - b) % n) % n
        if bit == "1":
            t = (X1 + Z1) * (X1 + Z1) % n
            d = (X1 - Z1) * (X1 - Z1) % n
            w = t - d
            X1, Z1 = t * d % n, w * (d + s * w % n) % n
            X0, Z0 = ax, az
        else:
            t = (X0 + Z0) * (X0 + Z0) % n
            d = (X0 - Z0) * (X0 - Z0) % n
            w = t - d
            X0, Z0 = t * d % n, w * (d + s * w % n) % n
            X1, Z1 = ax, az
    return X0, Z0


def _dbl(n, X, Z, s):
    t = (X + Z) * (X + Z) % n
    d = (X - Z) * (X - Z) % n
    w = t - d
    return t * d % n, w * (d + s * w % n) % n


def _add(n, X1, Z1, X2, Z2, Xd, Zd):
    a = (X1 - Z1) * (X2 + Z2) % n
    b = (X1 + Z1) * (X2 - Z2) % n
    return Zd * ((a + b) * (a + b) % n) % n, Xd * ((a - b) * (a - b) % n) % n


def chain(n: int, x_step: int, first: Tuple[int, int],
          second: Tuple[int, int], count: int) -> List[Tuple[int, int]]:
    """count points [k]P, [k+1]P, ... from first = [k]P and second =
    [k+1]P, P = (x_step : 1): each the last plus P, over the one before
    (differential addition)."""
    out = [first, second][:count]
    while len(out) < count:
        out.append(_add(n, *out[-1], x_step, 1, *out[-2]))
    return out


def affine(n: int, pts: Sequence[Tuple[int, int]], where: str) -> List[int]:
    """X/Z of every point, with one inverse (Montgomery's trick); a Z that
    shares a factor with n raises Found."""
    pre = []
    acc = 1
    for _x, z in pts:
        acc = acc * z % n
        pre.append(acc)
    inv = inverse(acc, n, where)
    out = [0] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        zi = inv * (pre[i - 1] if i else 1) % n
        inv = inv * pts[i][1] % n
        out[i] = pts[i][0] * zi % n
    return out


def plan_entries(plan: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(giant multiples m, baby steps u) of every entry of the plan
    {"D", "U", "chunks": [(map_v, map_u, amin0), ...]}: m = v + amin, amin
    the chunk's amin0 advanced by U at each (0, 0) sentinel."""
    ms, us = [], []
    for map_v, map_u, amin0 in plan["chunks"]:
        v = np.asarray(map_v, np.int64)
        u = np.asarray(map_u, np.int64)
        sent = (v == 0) & (u == 0)
        amin = amin0 + plan["U"] * np.cumsum(sent)
        keep = ~sent
        ms.append(v[keep] + amin[keep])
        us.append(u[keep])
    if not ms:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(ms), np.concatenate(us)


def plan_uncovered(plan: dict, b1: int, b2: int) -> int:
    """How many primes q with B1 < q < B2 no entry covers as m*D - u or
    m*D + u (avx-ecm's stage-2 range, ecm.c's testcoverage)."""
    m, u = plan_entries(plan)
    if np.any(u < 1) or np.any(u > plan["U"] * plan["D"]):
        return -1
    base = m * plan["D"]
    top = int(max(b2, (base + u).max() if base.size else 0)) + 1
    covered = np.zeros(top + 1, dtype=bool)
    lo = base - u
    covered[lo[lo >= 0]] = True
    covered[base + u] = True
    ps = primes_upto(b2 - 1)
    ps = ps[ps > b1]
    return int(np.count_nonzero(~covered[ps]))


def stage2_product(n: int, X: int, Z: int, s: int, plan: dict,
                   drop_entry: bool = False) -> int:
    """The product over the plan's entries of x([m*D]Q) - x([u]Q), Q =
    (X : Z).  Raises Found where a point's Z is not invertible."""
    D = plan["D"]
    m, u = plan_entries(plan)
    if drop_entry and m.size:
        m, u = m[1:], u[1:]
    if m.size == 0:
        return 1
    xq = X * inverse(Z, n, "stage 2") % n
    # the baby steps [u]Q and the giant steps [m*D]Q on differential
    # chains; only the points an entry names are normalized
    ub, ui = np.unique(u, return_inverse=True)
    babies = chain(n, xq, (xq, 1), _dbl(n, xq, 1, s), int(ub[-1]))
    bx = affine(n, [babies[k - 1] for k in ub.tolist()], "stage 2")
    dx, dz = ladder(n, xq, s, D)
    xd = dx * inverse(dz, n, "stage 2") % n
    mb, mi = np.unique(m, return_inverse=True)
    m_lo = int(mb[0])
    giants = chain(n, xd, ladder(n, xd, s, m_lo), ladder(n, xd, s, m_lo + 1),
                   int(mb[-1]) - m_lo + 1)
    gx = affine(n, [giants[k - m_lo] for k in mb.tolist()], "stage 2")
    acc = 1
    for g, b in zip(mi.tolist(), ui.tolist()):
        acc = acc * (gx[g] - bx[b]) % n
    return acc


def builds(n: int, sigma: int) -> bool:
    """Whether sigma's curve can be built mod n (no factor of n in its
    denominators)."""
    try:
        suyama(n, sigma)
        return True
    except Found:
        return False


def check_curve(n: int, sigma: int, b1: int, plan: Optional[dict],
                control: str = "") -> Dict[str, object]:
    """The reference's answers for sigma's curve: {"x1": the affine x
    after stage 1, or None where the stage-1 gcd finds a factor, "find1":
    that gcd (1: none), "acc": the stage-2 product over `plan` (None
    without one, or where stage 2 meets a factor), "find2": gcd(acc, n),
    or the factor stage 2 met (1: none)}.  control "stage1" leaves the
    largest prime below B1 out of stage 1, "stage2" drops one entry of
    the plan."""
    x0, s = suyama(n, sigma)
    k = stage1_scalar(b1, skip_last_prime=(control == "stage1"))
    X, Z = ladder(n, x0, s, k)
    find1 = math.gcd(Z, n)
    out = {"x1": None, "find1": find1, "acc": None, "find2": 1}
    if find1 != 1:
        return out
    out["x1"] = X * pow(Z, -1, n) % n
    if plan is not None:
        try:
            out["acc"] = stage2_product(n, X, Z, s, plan,
                                        drop_entry=(control == "stage2"))
            out["find2"] = math.gcd(out["acc"], n)
        except Found as e:
            out["find2"] = e.factor
    return out
