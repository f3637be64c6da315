"""RNS (residue number system) Montgomery arithmetic: the twin of
tpu_ecm/limbs/rns.py, and the plain version of the RNS arithmetic core of
the CUDA kernels K10-K15 (csrc/rns_mma.cuh).

A value is held as its residues in 2K+1 channels, planes [..., 2K+1, B]
with the curve axis last: rows [0, K) are base A = {p_1..p_K}, rows
[K, 2K) base B = {q_1..q_K} (~13-bit primes), row 2K the redundant channel
m_r = 2^(cw+1).  The Montgomery radix is P = prod(A).

  mont_mul(x, y):
    1. s       = x * y per channel
    2. sigma_i = s_i * |(-N^-1)(P/p_i)^-1|_{p_i}             (base A)
    3. M0 mod (B, r) = W1^T sigma,   W1[i, j] = |P/p_i|_{q_j}
    4. t_{B,r} = s * P^-1 + M0 * (N P^-1)                      per channel
    5. tau_j   = t_j * |(Q/q_j)^-1|_{q_j}                      (base B)
    6. S2      = W2^T tau,  W2[j, i] = |Q/q_j|_{p_i / m_r}
       beta    = (S2_r - t_r) * |Q^-1|_{m_r}  mod m_r   (needs S2's exact
                                                         low cw+1 bits)
       t_A     = S2_A - beta * |Q|_{p_i} + comp   mod p_i
  Subtraction adds F = 2K*N, a multiple of N, so values stay nonnegative.

Every residue is canonical (0 <= r < p; r < m_r on the r channel), so any
exact integer implementation gives JAX's planes bit for bit.  The plain
versions below take the two extension dots in float64: each term is below
2^27 and a sum over K <= 520 terms below 2^37 < 2^53, so the products are
exact on the CPU and the card alike.  The TPU's bf16 digit-split tables and
f32 Barrett reductions are not carried over: they exist for the MXU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..params import MontyCtx

# largest K for which the JAX package builds a context (its f32 bound)
K_MAX = 520


# ---------------------------------------------------------------------------
# context construction (host)
# ---------------------------------------------------------------------------

def _primes_below(limit: int, count: int) -> List[int]:
    out = []
    x = limit
    while len(out) < count:
        x -= 1
        if x < 3:
            raise ValueError("ran out of channel primes")
        if all(x % d for d in range(2, int(x ** 0.5) + 1)):
            out.append(x)
    return out


def choose_cw(nbits: int) -> int:
    """Channel width: cw=13 gives the fewest channels while the primes
    below 2^13 cover 2K channels up to K = K_MAX (~6200-bit moduli)."""
    del nbits
    return 13


# names of the per-row tables an RnsCtx carries, in rns.RnsCtx's order
TABLES = ("p", "c1", "w1", "n_br", "pinv_br", "npinv_br", "qdivinv", "w2",
          "qinv_r", "qmod_ar", "comp_a", "f_sub")


@dataclasses.dataclass(frozen=True)
class RnsHost:
    """Bases, constants (numpy int32, `tables`) and host conversions."""
    ctx: MontyCtx
    pa: List[int]
    pb: List[int]
    mr: int
    P: int
    Q: int
    K: int
    V: int
    mr_shift: int
    tables: Dict[str, np.ndarray]

    @property
    def rows(self) -> int:
        return 2 * self.K + 1

    def to_rns(self, x_mont: int) -> np.ndarray:
        """Montgomery(P)-domain int -> channel residues [2K+1]."""
        x = x_mont % self.ctx.n_int
        chans = [x % p for p in self.pa] + [x % q for q in self.pb] \
            + [x % self.mr]
        return np.asarray(chans, dtype=np.int32)

    def pack(self, vals_mont: List[int]) -> np.ndarray:
        return np.stack([self.to_rns(v) for v in vals_mont], axis=1)

    @functools.cached_property
    def _crt_w(self) -> List[int]:
        """A-base CRT weights (P/p_i) * ((P/p_i)^-1 mod p_i) mod P."""
        out = []
        for p in self.pa:
            pi = self.P // p
            out.append(pi * pow(pi % p, -1, p) % self.P)
        return out

    def from_rns(self, res) -> int:
        """A-base CRT -> exact value (valid while value < P), mod N."""
        x = sum(int(r) * w for r, w in zip(res, self._crt_w))
        return (x % self.P) % self.ctx.n_int

    def unpack(self, res) -> List[int]:
        res = np.asarray(res)
        return [self.from_rns(res[:, b]) for b in range(res.shape[1])]

    def to_mont_int(self, x: int) -> int:
        return (x * self.P) % self.ctx.n_int

    def from_mont_int(self, x: int) -> int:
        return (x * pow(self.P, -1, self.ctx.n_int)) % self.ctx.n_int


def make_rns(ctx: MontyCtx, cw: int = 12) -> RnsHost:
    """Bases and constant tables for modulus ctx.n_int, as the JAX
    package's make_rns builds them (K a multiple of 8, grown until
    P >= 16*K*N and Q >= 4*K*N)."""
    n = ctx.n_int
    mr = 1 << (cw + 1)
    K = max(8, (n.bit_length() // cw + 7) // 8 * 8)
    while True:
        chans = _primes_below(1 << cw, 2 * K)
        pa, pb = chans[:K], chans[K:]
        P = 1
        for p in pa:
            P *= p
        Q = 1
        for q in pb:
            Q *= q
        if P >= 16 * K * n and Q >= 4 * K * n:
            break
        K += 8
    if K > K_MAX:
        raise ValueError(f"K={K} exceeds the RNS engine's K <= {K_MAX}")
    V = 2 * K * n
    F = 2 * K * n  # subtraction lift, multiple of N, >= V

    ninv = pow(-n, -1, P) % P
    rows_br = pb + [mr]
    rows_ar = pa + [mr]
    w1 = np.zeros((K, K + 1), dtype=np.int32)
    c1 = np.zeros((K, 1), dtype=np.int32)
    for i, p in enumerate(pa):
        ppi = P // p
        c1[i, 0] = (ninv % p) * pow(ppi % p, -1, p) % p
        for j, q in enumerate(rows_br):
            w1[i, j] = ppi % q
    qdivinv = np.zeros((K, 1), dtype=np.int32)
    w2 = np.zeros((K, K + 1), dtype=np.int32)
    for j, q in enumerate(pb):
        qqj = Q // q
        qdivinv[j, 0] = pow(qqj % q, -1, q)
        for i, p in enumerate(rows_ar):
            w2[j, i] = qqj % p
    col = lambda vals: np.asarray([[v] for v in vals], dtype=np.int32)
    tables = dict(
        p=col(pa + pb + [mr]),
        c1=c1, w1=w1,
        n_br=col([n % q for q in rows_br]),
        pinv_br=col([pow(P % q, -1, q) for q in rows_br]),
        npinv_br=col([n * pow(P % q, -1, q) % q for q in rows_br]),
        qdivinv=qdivinv, w2=w2,
        qinv_r=col([pow(Q % mr, -1, mr)]),
        qmod_ar=col([Q % p for p in rows_ar]),
        # keeps S2_A - beta*|Q|_p nonnegative: beta < K, |Q|_p < p
        comp_a=col([p * (K + 1) for p in pa]),
        f_sub=col([F % p for p in pa + pb + [mr]]))
    return RnsHost(ctx=ctx, pa=pa, pb=pb, mr=mr, P=P, Q=Q, K=K, V=V,
                   mr_shift=cw + 1, tables=tables)


# ---------------------------------------------------------------------------
# device context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class RnsCtx:
    """The constant tables of one modulus as int32 tensors on one device
    (the twin of rns.RnsCtx without its TPU-only split tables), plus the
    arrays the CUDA kernels read (`tab`: kernel_tables; `wmma`:
    mma_weights)."""
    p: torch.Tensor          # [2K+1, 1] channel moduli, rows [A | B | r]
    c1: torch.Tensor         # [K, 1]
    w1: torch.Tensor         # [K, K+1]
    n_br: torch.Tensor       # [K+1, 1]
    pinv_br: torch.Tensor    # [K+1, 1]
    npinv_br: torch.Tensor   # [K+1, 1]
    qdivinv: torch.Tensor    # [K, 1]
    w2: torch.Tensor         # [K, K+1]
    qinv_r: torch.Tensor     # [1, 1]
    qmod_ar: torch.Tensor    # [K+1, 1] (r row unused)
    comp_a: torch.Tensor     # [K, 1]
    f_sub: torch.Tensor      # [2K+1, 1]
    tab: torch.Tensor        # flat per-row constants (kernel_tables)
    wmma: torch.Tensor       # W1, W2 as padded u8 planes (mma_weights)
    K: int
    mr_shift: int

    @property
    def rows(self) -> int:
        return 2 * self.K + 1

    @property
    def device(self) -> torch.device:
        return self.p.device


def kernel_tables(t: Dict[str, np.ndarray], K: int) -> np.ndarray:
    """The kernels' per-row constants (csrc/rns_mma.cuh, RNS_TAB_*):
    int32 [9K+5]: p[0..2K] | c1[0..K) | pinv_br[0..K] | npinv_br[0..K] |
    qdivinv[0..K) | qmod_ar[0..K) | f_sub[0..2K] | qinv_r."""
    if K % 2:
        raise ValueError(f"K={K} must be even")
    return np.concatenate([
        t["p"][:, 0], t["c1"][:, 0], t["pinv_br"][:, 0], t["npinv_br"][:, 0],
        t["qdivinv"][:, 0], t["qmod_ar"][:K, 0], t["f_sub"][:, 0],
        t["qinv_r"][:, 0]]).astype(np.int32)


def mma_weights(t: Dict[str, np.ndarray], K: int) -> np.ndarray:
    """K10's weights (csrc/rns_mma.cuh): uint8 [4, Mpad/32, Kpad/16, 32,
    16], planes W1 lo, W1 hi, W2 lo, W2 hi of W^T in 32 x 16 row-major
    tiles: plane[j // 32, i // 16, j % 32, i % 16] = the low or high byte
    of W[i, j] for W = w1, w2 (i < K input channels, j <= K output
    channels), zero in the padding to Kpad = ceil16(K) and Mpad =
    ceil32(K+1): the A operand of the tensor-core tiles.  Every weight is
    below 2^14, so a high byte is below 64."""
    kpad, mpad = -(-K // 16) * 16, -(-(K + 1) // 32) * 32
    out = np.zeros((4, mpad, kpad), dtype=np.uint8)
    for m, w in enumerate((t["w1"], t["w2"])):
        out[2 * m, :K + 1, :K] = (w & 0xFF).T
        out[2 * m + 1, :K + 1, :K] = (w >> 8).T
    return np.ascontiguousarray(
        out.reshape(4, mpad // 32, 32, kpad // 16, 16).transpose(0, 1, 3, 2,
                                                                 4))


def make_ctx(tables: Dict[str, np.ndarray], K: int, mr_shift: int,
             device) -> RnsCtx:
    """RnsCtx on `device` from numpy tables (make_rns's, or the leaves of a
    JAX RnsCtx through convert.rns_ctx)."""
    tab = kernel_tables(tables, K)
    on = lambda a: torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
    w = mma_weights(tables, K)
    # a tensor of its own: torch's allocators align it for the tensor-core
    # tiles' 32-byte rule
    wmma = torch.empty(w.shape, dtype=torch.uint8, device=device)
    wmma.copy_(torch.from_numpy(w))
    return RnsCtx(**{k: on(tables[k]) for k in TABLES}, tab=on(tab),
                  wmma=wmma, K=K, mr_shift=mr_shift)


def device_ctx(host: RnsHost, device) -> RnsCtx:
    return make_ctx(host.tables, host.K, host.mr_shift, device)


# ---------------------------------------------------------------------------
# plain versions of the arithmetic core
# ---------------------------------------------------------------------------

def _dot(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact w^T v for w [K, K+1] and v [..., K, B] (int64 out): float64
    products and sums of integers below 2^53 are exact."""
    return torch.matmul(w.T.to(torch.float64),
                        v.to(torch.float64)).round().to(torch.int64)


def mont_mul(x: torch.Tensor, y: torch.Tensor, rc: RnsCtx) -> torch.Tensor:
    """RNS Montgomery product x*y/P of [..., 2K+1, B] residue planes."""
    K = rc.K
    i64 = torch.int64
    p = rc.p.to(i64)
    pA, pBr, pB = p[:K], p[K:], p[K:2 * K]
    mask = (1 << rc.mr_shift) - 1

    s = x.to(i64) * y.to(i64) % p
    s_a, s_br = s[..., :K, :], s[..., K:, :]
    sigma = s_a * rc.c1.to(i64) % pA
    m0 = _dot(rc.w1, sigma) % pBr                                 # [K+1, B]
    t_br = (s_br * rc.pinv_br.to(i64) + m0 * rc.npinv_br.to(i64)) % pBr
    t_b, t_r = t_br[..., :K, :], t_br[..., K:, :]
    tau = t_b * rc.qdivinv.to(i64) % pB
    s2 = _dot(rc.w2, tau)                                         # exact
    s2_a, s2_r = s2[..., :K, :], s2[..., K:, :]
    beta = ((s2_r - t_r) & mask) * rc.qinv_r.to(i64) & mask       # [1, B]
    t_a = (s2_a - beta * rc.qmod_ar[:K].to(i64) + rc.comp_a.to(i64)) % pA
    return torch.cat([t_a, t_b, t_r], dim=-2).to(torch.int32)


def mont_sqr(x: torch.Tensor, rc: RnsCtx) -> torch.Tensor:
    return mont_mul(x, x, rc)


def add(x: torch.Tensor, y: torch.Tensor, rc: RnsCtx) -> torch.Tensor:
    z = x + y - rc.p
    return torch.where(z < 0, z + rc.p, z)


def sub(x: torch.Tensor, y: torch.Tensor, rc: RnsCtx) -> torch.Tensor:
    """x - y + F (F = 2KN keeps the true value nonnegative)."""
    z = x - y + rc.f_sub
    z = torch.where(z < 0, z + rc.p, z)
    return torch.where(z >= rc.p, z - rc.p, z)


def addsub(x, y, rc: RnsCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    return add(x, y, rc), sub(x, y, rc)
