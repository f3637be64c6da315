"""Suyama curve construction from a 64-bit sigma seed (host side).

JAX-free copy of tpu_ecm/curve/suyama.py (that package's curve/__init__
imports JAX); tests/test_torch_curve.py keeps the two equal.

Re-derivation of build_one_curve (reference ecm.c:1548-1803): the
per-curve scalar GMP work of the reference maps to Python ints here; the
results are packed into the batch digit planes by the driver.

Given sigma:  v = 4*sigma, u = sigma^2 - 5
  X = u^3, Z = v^3  ->  X := u^3 * (v^3)^-1, Z := 1   (normalized start)
  s = (A+2)/4 = (v-u)^3 * (3u+v) / (16 u^3 v)
All mod the *working* modulus (the full Mersenne M on the special path), and
finally converted to Montgomery form on the generic path.

A non-invertible denominator means gcd(denominator, n) > 1 — a factor found
during curve construction; we surface it instead of proceeding (the
reference would feed an undefined inverse onward).
"""

from __future__ import annotations

import dataclasses
import math

from tpu_ecm.params import MontyCtx


class FactorFoundDuringBuild(Exception):
    def __init__(self, factor: int, sigma: int):
        super().__init__(f"factor {factor} found building curve sigma={sigma}")
        self.factor = factor
        self.sigma = sigma


@dataclasses.dataclass(frozen=True)
class CurveInit:
    sigma: int
    x_mont: int   # starting X in Montgomery form (u^3/v^3 * R mod n)
    z_mont: int   # starting Z in Montgomery form (R mod n)
    s_mont: int   # (A+2)/4 in Montgomery form


def _inv_or_factor(x: int, n: int, sigma: int) -> int:
    g = math.gcd(x, n)
    if g != 1:
        raise FactorFoundDuringBuild(g if g != n else 0, sigma)
    return pow(x, -1, n)


def build_one_curve(ctx: MontyCtx, sigma: int) -> CurveInit:
    n = ctx.n_int
    v = 4 * sigma
    u = sigma * sigma - 5
    x = pow(u, 3, n)
    z = pow(v, 3, n)
    t1 = (v - u) % n
    t4 = pow(t1, 3, n)
    t3 = (3 * u + v) % n
    a_num = (t3 * t4) % n                 # (v-u)^3 (3u+v)
    denom = (16 * x * v) % n              # 16 u^3 v
    s = (a_num * _inv_or_factor(denom, n, sigma)) % n
    zinv = _inv_or_factor(z, n, sigma)
    x = (x * zinv) % n
    return CurveInit(sigma=sigma,
                     x_mont=ctx.to_mont_int(x),
                     z_mont=ctx.to_mont_int(1),
                     s_mont=ctx.to_mont_int(s))
