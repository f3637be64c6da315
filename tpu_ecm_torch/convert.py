"""Carry arithmetic context and state across from the JAX package.

The port keeps tpu_ecm's layout (int32 digit planes, curve axis last, the
same radix and R), so a conversion is a checked copy of the numpy arrays
that the JAX package's objects hold (np.asarray of jax arrays) onto a torch
device.  Nothing here imports JAX: callers pass numpy arrays and ints.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ecm.params import ArithParams

from .curve.ops import NUM_SLOTS
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


def planes(a, p: ArithParams, device) -> torch.Tensor:
    """A stage-2 plane stack, e.g. the Pb table pbx [num_pb,NW,B] or the
    accumulator acc [NW,B] -> tensor on `device`."""
    a = np.asarray(a)
    return _plane(a, a.shape[:-2], p, device, "planes")
