"""Batched reduced-radix modular arithmetic in PyTorch: the twin of
tpu_ecm/limbs/jnp_ops.py and the plain version of the CUDA arithmetic core
(csrc/arith.cuh).

Values are base-2**w signed int32 digit planes [..., NW, B] with the curve
axis B last; every function here gives the same digits as its jnp twin
(tests/test_torch_limbs.py holds them bit-identical).  Column sums stay
inside int32 by params.select_radix.  The one product that wraps by design
in jnp, the REDC quotient q = col * nprime mod 2^w, is formed here from the
low w bits of col, which gives the same q without overflowing.

Only the Montgomery (REDC) reduction is ported; a Mersenne-form context
raises (the fold is ROADMAP work).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tpu_ecm.params import ArithParams, MontyCtx

from . import layout


@dataclasses.dataclass(frozen=True)
class DeviceCtx:
    """Arithmetic context of one modulus on one device (the twin of
    jnp_ops.DeviceCtx)."""
    n: torch.Tensor       # [NW, 1] int32 digits of the working modulus
    c: torch.Tensor       # [CL, 1] int32 digits of |mersenne c| (or [1,1] zero)
    p: ArithParams
    nprime: int
    mersenne_e: int
    mersenne_c_sign: int

    @property
    def device(self) -> torch.device:
        return self.n.device

    @property
    def is_mersenne(self) -> bool:
        return self.mersenne_e != 0


def device_ctx(ctx: MontyCtx, device) -> DeviceCtx:
    p = ctx.p
    n_digits = layout.int_to_digits(ctx.n_int, p.w, p.nw)[:, None]
    if ctx.is_mersenne:
        cabs = abs(ctx.mersenne_c)
        cl = max(1, (cabs.bit_length() + p.w - 1) // p.w)
        c_digits = layout.int_to_digits(cabs, p.w, cl)[:, None]
        sign = 1 if ctx.mersenne_c > 0 else -1
    else:
        c_digits = np.zeros((1, 1), dtype=np.int32)
        sign = 0
    return DeviceCtx(n=torch.from_numpy(n_digits).to(device),
                     c=torch.from_numpy(c_digits).to(device),
                     p=p, nprime=ctx.nprime, mersenne_e=ctx.mersenne_e,
                     mersenne_c_sign=sign)


# ---------------------------------------------------------------------------
# add / sub (redundant representation)
# ---------------------------------------------------------------------------

def addmod(a: torch.Tensor, b: torch.Tensor, ctx: DeviceCtx) -> torch.Tensor:
    return a + b


def submod(a: torch.Tensor, b: torch.Tensor, ctx: DeviceCtx) -> torch.Tensor:
    return a - b


def addsubmod(a: torch.Tensor, b: torch.Tensor, ctx: DeviceCtx
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return a + b, a - b


def _norm_out(t: torch.Tensor, ctx: DeviceCtx) -> torch.Tensor:
    """One lazy pass in norm_inputs mode: makes an add/sub result a safe
    pre-normalized mulmod operand (norm1 of the CUDA core)."""
    return _lazy_pass(t, ctx.p.w) if ctx.p.norm_inputs else t


def addmod_n(a: torch.Tensor, b: torch.Tensor, ctx: DeviceCtx) -> torch.Tensor:
    return _norm_out(a + b, ctx)


def submod_n(a: torch.Tensor, b: torch.Tensor, ctx: DeviceCtx) -> torch.Tensor:
    return _norm_out(a - b, ctx)


def addsubmod_n(a: torch.Tensor, b: torch.Tensor, ctx: DeviceCtx
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _norm_out(a + b, ctx), _norm_out(a - b, ctx)


# ---------------------------------------------------------------------------
# lazy carry normalization
# ---------------------------------------------------------------------------

def _lazy_rows(t: torch.Tensor, w: int) -> torch.Tensor:
    """_lazy_pass with the digit axis first."""
    lo = t & ((1 << w) - 1)
    lo[-1] = t[-1]
    lo[1:] += t[:-1] >> w
    return lo


def _lazy_pass(t: torch.Tensor, w: int) -> torch.Tensor:
    """One carry-save squeeze over the digit axis (-2): digit j := (t_j mod
    2^w) + (t_{j-1} >> w), the top row kept unsplit (signed guard digit)."""
    return _lazy_rows(t.movedim(-2, 0), w).movedim(0, -2)


def lazy_normalize(t: torch.Tensor, w: int, passes: int = 2) -> torch.Tensor:
    for _ in range(passes):
        t = _lazy_pass(t, w)
    return t


# ---------------------------------------------------------------------------
# product columns and REDC (digit axis first inside, for cheap row views)
# ---------------------------------------------------------------------------

def _product_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact column sums of a*b: [..., NW, B] x [..., NW, B] -> [..., 2NW, B].
    Every (i, j) digit product is formed at once and summed into column
    i + j; integer sums do not depend on their order."""
    a, b = torch.broadcast_tensors(a, b)
    a, b = a.movedim(-2, 0), b.movedim(-2, 0)
    nw = a.shape[0]
    prods = (a.unsqueeze(1) * b.unsqueeze(0)).reshape((nw * nw,) + a.shape[1:])
    cols = torch.arange(nw, device=a.device)
    cols = (cols[:, None] + cols[None, :]).reshape(-1)
    t = a.new_zeros((2 * nw,) + a.shape[1:])
    t.index_add_(0, cols, prods)
    return t.movedim(0, -2)


def _square_columns(a: torch.Tensor) -> torch.Tensor:
    """Exact column sums of a*a: the same integers as jnp_ops' symmetric
    half product, hence the same digits."""
    return _product_columns(a, a)


def _redc(t: torch.Tensor, ctx: DeviceCtx) -> torch.Tensor:
    """Digit-serial Montgomery reduction of [..., 2NW, B] columns -> [..., NW, B]."""
    p = ctx.p
    nw, w, mask = p.nw, p.w, p.mask
    t = t.movedim(-2, 0).clone()
    n_col = ctx.n.reshape((nw,) + (1,) * (t.dim() - 1))
    for i in range(nw):
        ti = t[i]
        q = (ti & mask).mul_(ctx.nprime).bitwise_and_(mask)
        t[i:i + nw] += q * n_col
        t[i + 1] += ti >> w
    return t[nw:].movedim(0, -2)


def _check_redc(ctx: DeviceCtx) -> None:
    if ctx.is_mersenne:
        raise NotImplementedError(
            "Mersenne-form arithmetic (the fold reduction) is not ported yet: "
            "ROADMAP.md, 'Mersenne / pseudo-Mersenne path'")


def mulmod(a: torch.Tensor, b: torch.Tensor, ctx: DeviceCtx, *,
           pre: bool = False) -> torch.Tensor:
    """Montgomery product a*b/R of digit planes.  pre=True asserts both
    operands are already safe (mulmod outputs, packed host values or *_n
    results) and skips the norm_inputs entry passes."""
    _check_redc(ctx)
    if ctx.p.norm_inputs and not pre:
        a = _lazy_pass(a, ctx.p.w)
        b = _lazy_pass(b, ctx.p.w)
    return lazy_normalize(_redc(_product_columns(a, b), ctx), ctx.p.w)


def sqrmod(a: torch.Tensor, ctx: DeviceCtx, *, pre: bool = False
           ) -> torch.Tensor:
    """Montgomery square a*a/R."""
    _check_redc(ctx)
    if ctx.p.norm_inputs and not pre:
        a = _lazy_pass(a, ctx.p.w)
    return lazy_normalize(_redc(_square_columns(a), ctx), ctx.p.w)
