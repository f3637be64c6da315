"""Several processes on one job (tpu_ecm_torch.parallel.coordination and
.distributed), every case of tests/test_distributed.py for the port: the
stop-on-factor flags, the driver stopping on another process's hit and
publishing its own, run_multihost in one process, plan/poll/drain
bracketing, the union of host_sigma_base ranges equalling one run
(tests/test_sharding.py:87), a real two-process gloo run in which both
processes stop at the same batch boundary, and the random-sigma seed with
the process index mixed in as tpu_ecm mixes it."""

import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm_torch import driver  # noqa: E402
from tpu_ecm_torch.parallel import coordination as coord  # noqa: E402
from tpu_ecm_torch.parallel import distributed  # noqa: E402
from tpu_ecm_torch.utils import rng  # noqa: E402

from test_e2e import N71, P35  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P36 = N71 // P35


def _cfg(tmp_path, tag, **kw):
    base = dict(n=N71, b1=300, sigma=110, verbose=0, device="cpu",
                save_b1_path=None, checkpoint_path=None,
                results_path=str(tmp_path / f"r{tag}.txt"))
    base.update(kw)
    return driver.RunConfig(**base)


def test_local_flag_sticky():
    f = coord.LocalFlag()
    assert not f.poll(False)
    assert f.poll(True)
    assert f.poll(False)          # sticky


def test_collective_flag_single_process():
    """No process group: the local bit."""
    f = coord.CollectiveFlag()
    assert not f.poll(False)
    assert f.poll(True)
    assert f.poll(False)          # sticky


def test_collective_flag_plan_drain_single_process():
    """plan() fixes the poll budget; drain() pads the shortfall so the
    all_reduce counts match across processes."""
    f = coord.CollectiveFlag()
    f.plan(5)
    assert f.poll(False) is False
    assert f.poll(True) is True          # sticky from here on
    f.drain()
    assert f._polls == 5
    assert f.poll(False) is True         # stickiness survives draining


def test_file_flag_cross_instance(tmp_path):
    """Two FileFlag instances (two processes on a shared filesystem): a hit
    published by one is visible to the other."""
    path = str(tmp_path / "hit.flag")
    a, b = coord.FileFlag(path), coord.FileFlag(path)
    assert not b.poll(False)
    assert a.poll(True)
    assert b.poll(False)          # sees A's hit without hitting itself
    a.clear()
    assert not b.poll(False)


def test_driver_stops_when_other_host_hit(tmp_path):
    """Process B stops at its first batch boundary when the shared flag
    says another process found a factor, although B found nothing (B2=B1:
    stage 1 only, sigmas 110..117 give no stage-1 hit)."""
    flag = coord.FileFlag(str(tmp_path / "hit.flag"))
    assert flag.poll(True)        # "process A" publishes
    cfg = _cfg(tmp_path, "b", curves=8, batch=2, b2=300,
               hit_flag=coord.FileFlag(flag.path))
    res = driver.ECMDriver(cfg).run()
    assert not res.factors
    assert res.curves_run == 2    # 1 of 4 batches, then the flag stopped it


def test_driver_publishes_hit_to_flag(tmp_path):
    """Process A's own find is published at the batch boundary."""
    flag_path = str(tmp_path / "hit.flag")
    cfg = _cfg(tmp_path, "a", curves=4, b2=10000, stop_on_factor=False,
               hit_flag=coord.FileFlag(flag_path))
    res = driver.ECMDriver(cfg).run()
    assert any(h.factor == P35 for h in res.factors)    # sigma 112, stage 2
    assert os.path.exists(flag_path)


def test_run_multihost_single_process(tmp_path):
    """One process: the whole budget here, no collective flag (no group),
    no sharder on the CPU; the sigma-112 find stops the run."""
    res = distributed.run_multihost(
        N71, total_curves=8, b1=300, b2=10000, sigma=110, device="cpu",
        verbose=0, save_b1_path=None, checkpoint_path=None,
        results_path=str(tmp_path / "r.txt"))
    assert any(h.factor == P35 and h.sigma == 112 for h in res.factors)
    assert res.curves_run == 8


class Recording(coord.HitFlag):
    def __init__(self):
        self.planned = None
        self.polls = 0
        self.drained = 0

    def plan(self, n_batches):
        self.planned = n_batches

    def poll(self, found_local):
        self.polls += 1
        return bool(found_local)

    def drain(self):
        self.drained += 1


def test_driver_brackets_hit_flag_with_plan_and_drain(tmp_path):
    """The driver plans the batch count before its loop and drains after
    it, also on an early stop-on-factor exit."""
    flag = Recording()
    driver.ECMDriver(_cfg(tmp_path, "1", curves=8, b2=300, batch=2,
                          hit_flag=flag, stop_on_factor=False)).run()
    assert (flag.planned, flag.polls, flag.drained) == (4, 4, 1)

    flag2 = Recording()
    driver.ECMDriver(_cfg(tmp_path, "2", curves=8, b2=300, sigma=174,
                          batch=2, hit_flag=flag2,
                          stop_on_factor=True)).run()
    assert flag2.planned == 4
    assert flag2.polls < 4               # sigma 174 hits in the first batch
    assert flag2.drained == 1


def test_multihost_union_equals_single_run(tmp_path):
    """Two processes' disjoint sigma ranges (host_sigma_base) find together
    exactly the factor set of one run over the whole range."""
    def run(curves, sigma, tag):
        res = driver.ECMDriver(_cfg(tmp_path, tag, curves=curves,
                                    b2=20000, sigma=sigma,
                                    stop_on_factor=False)).run()
        return {(h.factor, h.stage, h.sigma) for h in res.factors}

    total, nproc = 64, 2
    per_host = total // nproc
    union = set()
    for pid in range(nproc):
        union |= run(per_host, distributed.host_sigma_base(110, pid,
                                                           per_host),
                     f"h{pid}")
    assert union == run(total, 110, "all")
    assert distributed.host_sigma_base(0, 1, per_host) == 0


_TWO_PROC_SCRIPT = r"""
import os, sys
import torch
torch.set_num_threads(1)
pid = int(sys.argv[1]); tmp = sys.argv[2]
from tpu_ecm_torch.parallel import distributed
res = distributed.run_multihost(
    {n}, total_curves=12, b1=300, b2=10000, sigma=110, batch=2,
    device="cpu", init_method="file://" + os.path.join(tmp, "rendezvous"),
    world_size=2, rank=pid, verbose=0, save_b1_path=None,
    checkpoint_path=None, results_path=os.path.join(tmp, "r%d.txt" % pid))
print("RESULT", pid, res.curves_run,
      sorted((h.factor, h.stage, h.sigma) for h in res.factors))
"""


def test_run_multihost_two_processes(tmp_path):
    """A real two-process gloo run on the CPU (file:// rendezvous): process
    0 owns sigmas 110..115 (sigma 111 finds P36 in its first batch of 2),
    process 1 owns 116..121 and finds nothing.  The CollectiveFlag stops
    both at the first batch boundary: each runs 2 of its 6 curves."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    script = _TWO_PROC_SCRIPT.format(n=N71)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(i), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(tmp_path)) for i in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-3000:]
    lines = {o.strip().splitlines()[-1].split()[1]: o.strip().splitlines()[-1]
             for o, _ in outs}
    assert str(P36) in lines["0"]
    assert lines["1"].endswith("[]")
    ran0, ran1 = int(lines["0"].split()[2]), int(lines["1"].split()[2])
    assert ran0 == ran1 == 2, (ran0, ran1)


def test_seed_mixes_the_process_index(monkeypatch, tmp_path):
    """With the clock fixed, rank 0 keeps the one-process seed
    hash64(time_us), ranks 0 and 1 draw different random sigmas, and each
    rank draws tpu_ecm's sigmas for its process index."""
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.123456)
    monkeypatch.setattr(driver, "time", clock)
    monkeypatch.setattr(j_driver, "time", clock)

    def sigmas(pid, mod, **kw):
        if mod is driver:
            monkeypatch.setattr(driver, "process_index", lambda: pid)
            d = driver.ECMDriver(_cfg(tmp_path, "s", curves=4, b2=300,
                                      sigma=0))
        else:
            monkeypatch.setattr(jax, "process_index", lambda: pid)
            d = j_driver.ECMDriver(j_driver.RunConfig(
                n=N71, curves=4, b1=300, b2=300, sigma=0, verbose=0,
                save_b1_path=None, checkpoint_path=None, results_path=None,
                cache_dir=str(tmp_path / "cache")))
        return [d.sigma_gen.next() for _ in range(4)]

    one = rng.SigmaGen(0, rng.hash64(int(clock.time() * 1e6)
                                     & ((1 << 64) - 1)))
    r0, r1 = sigmas(0, driver), sigmas(1, driver)
    assert r0 == [one.next() for _ in range(4)]
    assert r0 != r1
    assert r0 == sigmas(0, j_driver) and r1 == sigmas(1, j_driver)
    monkeypatch.undo()
    assert driver.process_index() == 0      # no process group here
