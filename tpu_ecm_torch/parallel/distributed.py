"""One job over several processes (hosts): split the sigma space between
them and run the same single-process program on each — the twin of
tpu_ecm/parallel/distributed.py.

ECM curves are independent, so the compute needs no traffic between
processes.  Coordination is two things:

(a) disjoint sigma ranges: process i owns sigmas
    [base + i*curves_per_host, base + (i+1)*curves_per_host);
(b) stop-on-factor: a one-bit HitFlag poll per curve-batch boundary
    (parallel/coordination.py), a CollectiveFlag over torch.distributed
    or a FileFlag on a shared filesystem.

Each process drives all of its local CUDA devices: a Sharder over them is
installed when the run is on CUDA and there is more than one.

Usage, the same command in every process (rank r of w):

    from tpu_ecm_torch.parallel import distributed
    res = distributed.run_multihost(
        n, total_curves=32768, b1=43_000_000,
        init_method="tcp://10.0.0.1:29500", world_size=w, rank=r)

A process that is already in a process group passes no init_method; with
no group it is a plain run.  A group that run_multihost starts it also
ends: after a barrier (no process tears the group down while another is
still in one of its collectives) it destroys it, so the process exits
with no group and can start another run.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import driver as _driver
from . import coordination as _coord
from .mesh import Sharder


def host_sigma_base(global_sigma: int, process_id: int,
                    curves_per_host: int) -> int:
    """Deterministic, disjoint sigma ranges per process: process i starts at
    global_sigma + i * curves_per_host (the sigma generator takes one sigma
    a curve).  global_sigma == 0 (random mode) leaves the seed to the
    driver, which mixes in the process index."""
    if global_sigma == 0:
        return 0
    return global_sigma + process_id * curves_per_host


def run_multihost(n: int, total_curves: int, b1: int, *,
                  b2: Optional[int] = None, sigma: int = 0,
                  init_method: Optional[str] = None,
                  world_size: Optional[int] = None,
                  rank: Optional[int] = None,
                  **kw) -> _driver.RunResult:
    """Run this process's share of a job spread over processes.

    Each process runs the same program on its local devices over a
    disjoint slice of the curve budget; with a fixed sigma the union of
    all processes' results is that of one run over the whole budget.
    init_method (e.g. "tcp://host:port" or "file:///shared/path") starts
    the gloo process group with world_size and rank.  Batch counts may
    differ between processes, so the driver agrees on the CollectiveFlag's
    poll budget through plan()/drain() (parallel/coordination.py)."""
    import torch.distributed as dist

    if init_method is None:
        return _run_share(n, total_curves, b1, b2, sigma, kw)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank)
    try:
        res = _run_share(n, total_curves, b1, b2, sigma, kw)
        dist.barrier()
        return res
    finally:
        dist.destroy_process_group()


def _run_share(n: int, total_curves: int, b1: int, b2: Optional[int],
               sigma: int, kw: dict) -> _driver.RunResult:
    """This process's share of the job in the default group, if any."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    nproc = dist.get_world_size() if grouped else 1
    pid = dist.get_rank() if grouped else 0
    curves_here = (total_curves + nproc - 1) // nproc
    base = host_sigma_base(sigma, pid, curves_here)
    if sigma == 0:
        # random mode: each process gets its own results file; the driver
        # seeds its sigmas from (time, rank), so equal clocks still give
        # different sigmas
        kw.setdefault("results_path", f"ecm_results_h{pid}.txt")
    if ("sharder" not in kw
            and torch.device(kw.get("device", "cuda")).type == "cuda"
            and torch.cuda.is_available() and torch.cuda.device_count() > 1):
        # drive every local card, not one per process
        kw["sharder"] = Sharder()
    if "hit_flag" not in kw and nproc > 1:
        kw["hit_flag"] = _coord.CollectiveFlag()
    cfg = _driver.RunConfig(n=n, curves=curves_here, b1=b1, b2=b2,
                            sigma=base, **kw)
    return _driver.ECMDriver(cfg).run()
