"""Carry arithmetic context and state across from the JAX package.

The port keeps tpu_ecm's layouts (int32 digit planes, and RNS residue
planes [.., 2K+1, B], curve axis last; the same radix, R, bases and
tables), so a conversion is a checked copy of the numpy arrays that the
JAX package's objects hold (np.asarray of jax arrays) onto a torch device.
Nothing here imports JAX: callers pass numpy arrays and ints.
"""

from __future__ import annotations

import numpy as np
import torch

from typing import Dict

from .params import ArithParams

from .curve.edwards import DEFAULT_W
from .curve.ops import NUM_SLOTS
from .limbs import rns
from .limbs.torch_ops import DeviceCtx
from .stage1 import Stage1State


def _plane(a, lead, p: ArithParams, device, what: str) -> torch.Tensor:
    """numpy int32 array of shape lead + [NW, B] -> contiguous tensor."""
    a = np.asarray(a)
    if a.dtype != np.int32:
        raise ValueError(f"{what}: expected int32, got {a.dtype}")
    if a.ndim != len(lead) + 2 or tuple(a.shape[:len(lead)]) != tuple(lead) \
            or a.shape[-2] != p.nw:
        raise ValueError(f"{what}: shape {a.shape} is not "
                         f"{tuple(lead)} + ({p.nw}, B)")
    return torch.from_numpy(np.array(a)).to(device)      # own, writable copy


def device_ctx(n, c, p: ArithParams, nprime: int, mersenne_e: int,
               mersenne_c_sign: int, device) -> DeviceCtx:
    """jnp_ops.DeviceCtx fields (n [NW,1], c [CL,1] as numpy) -> the
    port's DeviceCtx on `device`."""
    n = np.asarray(n)
    if n.shape != (p.nw, 1):
        raise ValueError(f"n: shape {n.shape} is not ({p.nw}, 1)")
    c = np.asarray(c)
    if c.ndim != 2 or c.shape[1] != 1:
        raise ValueError(f"c: shape {c.shape} is not (CL, 1)")
    return DeviceCtx(n=_plane(n, (), p, device, "n"),
                     c=torch.from_numpy(np.array(c, dtype=np.int32)).to(
                         device),
                     p=p, nprime=int(nprime), mersenne_e=int(mersenne_e),
                     mersenne_c_sign=int(mersenne_c_sign))


def stage1_state(pts, s_const, p: ArithParams, device) -> Stage1State:
    """Stage1State.pts [6,2,NW,B] and s_const [NW,B] -> the port's state."""
    pts_t = _plane(pts, (NUM_SLOTS, 2), p, device, "pts")
    s_t = _plane(s_const, (), p, device, "s_const")
    if pts_t.shape[-1] != s_t.shape[-1]:
        raise ValueError("pts and s_const disagree on the curve batch")
    return Stage1State(pts=pts_t, s_const=s_t)


def ed_state(acc, table, p: ArithParams, device):
    """The Edwards stage-1 state: accumulator acc [4, NW, B] and cached
    window table [Tp, 3, NW, B] (numpy int32) -> the port's two tensors.
    The table holds Tp = 2^(w-2) odd multiples at the window width
    w = edwards.DEFAULT_W."""
    acc_t = _plane(acc, (4,), p, device, "acc")
    table_t = _plane(table, (1 << (DEFAULT_W - 2), 3), p, device, "table")
    if acc_t.shape[-1] != table_t.shape[-1]:
        raise ValueError("acc and table disagree on the curve batch")
    return acc_t, table_t


def planes(a, p: ArithParams, device) -> torch.Tensor:
    """A stage-2 plane stack, e.g. the Pb table pbx [num_pb,NW,B] or the
    accumulator acc [NW,B] -> tensor on `device`."""
    a = np.asarray(a)
    return _plane(a, a.shape[:-2], p, device, "planes")


def rns_ctx(leaves: Dict[str, np.ndarray], K: int, mr_shift: int,
            device) -> rns.RnsCtx:
    """The leaves of a JAX rns.RnsCtx ({name: np.asarray(field)} for every
    name of rns.TABLES) -> the port's RnsCtx on `device`.  JAX's p carries
    one padding row (a second copy of m_r), which is dropped; the bf16
    split tables are not taken."""
    rows = 2 * K + 1
    shapes = dict(p=(rows, 1), c1=(K, 1), w1=(K, K + 1), n_br=(K + 1, 1),
                  pinv_br=(K + 1, 1), npinv_br=(K + 1, 1), qdivinv=(K, 1),
                  w2=(K, K + 1), qinv_r=(1, 1), qmod_ar=(K + 1, 1),
                  comp_a=(K, 1), f_sub=(rows, 1))
    tables = {}
    for name in rns.TABLES:
        a = np.asarray(leaves[name])
        if a.dtype != np.int32:
            raise ValueError(f"{name}: expected int32, got {a.dtype}")
        if name == "p" and a.shape == (rows + 1, 1):
            if a[rows, 0] != a[rows - 1, 0]:
                raise ValueError("p: padding row is not a copy of m_r")
            a = a[:rows]
        if a.shape != shapes[name]:
            raise ValueError(f"{name}: shape {a.shape} is not "
                             f"{shapes[name]} for K={K}")
        tables[name] = a
    if int(tables["p"][-1, 0]) != 1 << mr_shift:
        raise ValueError(f"p: r channel {int(tables['p'][-1, 0])} is not "
                         f"2^{mr_shift}")
    return rns.make_ctx(tables, K, mr_shift, device)


def rns_planes(a, K: int, device) -> torch.Tensor:
    """A stack of residue planes [.., 2K+1, B] (register file, curve
    constant, Pb table, accumulator) -> tensor on `device`."""
    a = np.asarray(a)
    if a.dtype != np.int32:
        raise ValueError(f"rns_planes: expected int32, got {a.dtype}")
    if a.ndim < 2 or a.shape[-2] != 2 * K + 1:
        raise ValueError(f"rns_planes: shape {a.shape} is not "
                         f"(.., {2 * K + 1}, B) for K={K}")
    return torch.from_numpy(np.array(a)).to(device)
