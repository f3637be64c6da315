"""The curve axis split over the devices of one host: the twin of
tpu_ecm/parallel/mesh.py.

Every plane is [.., B] with the curve batch B last, and every arithmetic
and curve operation is batch-pointwise, so stage 1 and stage 2 need no
traffic between devices.  The reference lays B over a 1-D ('curves',)
jax mesh in blocks (NamedSharding(P(..., 'curves'))); here device i holds
the contiguous columns [i*B/n, (i+1)*B/n) as a tensor of its own, and the
driver runs one shard per device (driver.py).  The only crossings between
shards are on the host: the gcd harvest, the savefile writes and, in
stage 2, each shard's host modular inverse per group, the same crossings
as on one device.  Fixed sigma gives the same residues for any number of
devices, since the split never changes the arithmetic.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class Sharder:
    """Lays [.., B]-trailing arrays over `devices` (default: every visible
    CUDA device).  A device may repeat (several shards on one device: the
    CPU tests use ["cpu"] * k); a list that mixes device types, or a CUDA
    device that is not there, raises."""

    def __init__(self, devices: Optional[Sequence] = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Sharder(): no CUDA device is visible; "
                                   "pass the devices")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("Sharder needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1:
            raise ValueError(f"Sharder devices mix types: {sorted(kinds)}")
        if "cuda" in kinds:
            if not torch.cuda.is_available():
                raise RuntimeError("Sharder: CUDA devices requested but "
                                   "torch.cuda.is_available() is False")
            count = torch.cuda.device_count()
            devs = [torch.device("cuda", torch.cuda.current_device()
                                 if d.index is None else d.index)
                    for d in devs]
            missing = [str(d) for d in devs if d.index >= count]
            if missing:
                raise ValueError(f"Sharder: {missing} not present "
                                 f"({count} CUDA devices visible)")
        self.devices: List[torch.device] = devs
        self.n = len(devs)

    def round_batch(self, b: int) -> int:
        """Round a requested batch up to a multiple of the device count
        (tpu_ecm/parallel/mesh.py:57-61)."""
        return ((b + self.n - 1) // self.n) * self.n

    def split(self, b: int) -> List[Tuple[int, int]]:
        """The column range [lo, hi) of each device in a batch of b: the
        block layout of NamedSharding(P(..., 'curves'))."""
        return [(i * b // self.n, (i + 1) * b // self.n)
                for i in range(self.n)]

    def device_put(self, x) -> List[torch.Tensor]:
        """One contiguous tensor per device: device i's columns of x's LAST
        axis (the curve batch), which must divide evenly."""
        x = np.asarray(x)
        b = x.shape[-1]
        if b % self.n:
            raise ValueError(f"batch {b} not divisible by {self.n} devices")
        return [torch.from_numpy(np.ascontiguousarray(x[..., lo:hi])).to(d)
                for d, (lo, hi) in zip(self.devices, self.split(b))]
