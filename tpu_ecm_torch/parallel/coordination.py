"""Stop-on-factor across processes: the twin of
tpu_ecm/parallel/coordination.py.

A run stops its curve loop once any curve finds a factor.  A job spread
over several processes needs the same property across them: when one
process hits, the others must not spend the rest of their curve budget.
Curves are independent, so the only traffic between processes is one
"anyone hit?" bit, exchanged at curve-batch boundaries.

Three flags behind one `HitFlag.poll()`:

* CollectiveFlag: an all_reduce(MAX) of the hit bit over torch.distributed's
  default group (gloo, on CPU tensors: one int a batch needs no NCCL).
  Collective: every process must poll the same number of times.  Equal
  curve budgets do not give equal batch counts (the batch follows the
  local device count and engine), so the driver agrees on a poll budget
  first: plan(n_batches) takes the MAX over processes, and drain() pads
  this process's shortfall (an early stop, fewer batches) with polls.
* FileFlag: a flag file on a shared filesystem, for independent processes
  started by a launcher (no process group).  Any process may poll at any
  time.
* LocalFlag: one process, a local bit.
"""

from __future__ import annotations

import os


class HitFlag:
    """poll(found_local) -> bool: publish this process's hit bit and return
    whether ANY process (this one included) has hit.  The driver calls it
    once per curve-batch boundary, after plan(n_batches) before its loop
    and before drain() after it (both no-ops except for collective
    flags)."""

    def poll(self, found_local: bool) -> bool:
        raise NotImplementedError

    def plan(self, n_batches: int) -> None:
        pass

    def drain(self) -> None:
        pass


class LocalFlag(HitFlag):
    def __init__(self):
        self.hit = False

    def poll(self, found_local: bool) -> bool:
        self.hit = self.hit or bool(found_local)
        return self.hit


class FileFlag(HitFlag):
    """Shared-filesystem flag: `poll` writes the flag file when this
    process has hit and reports whether any process created it."""

    def __init__(self, path: str):
        self.path = path

    def poll(self, found_local: bool) -> bool:
        if found_local and not os.path.exists(self.path):
            tmp = f"{self.path}.{os.getpid()}.tmp"
            try:
                with open(tmp, "w") as f:
                    f.write("hit\n")
                os.replace(tmp, self.path)       # atomic on POSIX
            except OSError:
                pass
        return os.path.exists(self.path)

    def clear(self):
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


def _world() -> int:
    """The default group's size, 1 without an initialized group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _all_max(v: int) -> int:
    """MAX of v over the default group's processes."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([int(v)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


class CollectiveFlag(HitFlag):
    """torch.distributed collective: one int64 all_reduce(MAX) a poll on
    the default group.  Sticky: once any process reports a hit, every poll
    returns True.  With no initialized group, or a world of one process,
    it is the local bit."""

    def __init__(self):
        self._hit = False
        self._polls = 0
        self._budget = None

    def plan(self, n_batches: int) -> None:
        if _world() == 1:
            self._budget = int(n_batches)
            return
        self._budget = _all_max(n_batches)

    def poll(self, found_local: bool) -> bool:
        self._hit = self._hit or bool(found_local)
        self._polls += 1
        if _world() == 1:
            return self._hit
        self._hit = _all_max(1 if self._hit else 0) > 0
        return self._hit

    def drain(self) -> None:
        while self._budget is not None and self._polls < self._budget:
            self.poll(self._hit)
