#!/usr/bin/env python3
"""The curve axis split over the cards of one host, against one card
(tpu_ecm_torch.parallel): three jobs on a host with four NVIDIA GPUs.

  flagship  bench.py's 416-bit N, 8192 Suyama curves from sigma 7000,
            B1=1e5, B2=1e7: on card 0 in 4 batches of 2048, then in one
            batch of 8192 split over every card (2048 a card)
  rns       row 21's 2397-bit N, 4096 curves from its sigma 377260338,
            B1=25,000, B2=2,500,000: on card 0 (batches of the card's RNS
            batch), then on a Sharder over every card (one batch)
  multihost run_multihost in two gloo processes, each seeing two cards
            through CUDA_VISIBLE_DEVICES (0,1 and 2,3), on the flagship N
            at 2048 curves from sigma 7000 (1024 a process, 512 a card)

The split runs must give the one-card runs' (factor, stage, sigma) sets
and save_b1.txt bytes (multihost: the union of the two processes' finds
and their save files, in rank order, are the one-card flagship run's for
the first 2048 sigmas).  Prints the card's name and power limit, each
run's wall time, stage split and curves/s, the ratio of the split run's
curves/s to one card's, and one JSON line of it all, also written to
chiprun_out/multigpu_check.json.  Exits non-zero if a comparison fails or
fewer than two cards are visible.

    python3 tools/multigpu_check.py [--jobs flagship,rns,multihost]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FLAGSHIP = dict(curves=8192, sigma=7000, b1=100_000, b2=10_000_000,
                batch=2048)
MULTIHOST_CURVES = 2048
JOBS = ("flagship", "rns", "multihost")


def _cfg(d, **kw):
    from tpu_ecm_torch import driver
    os.makedirs(d, exist_ok=True)
    return driver.RunConfig(
        save_b1_path=os.path.join(d, "save_b1.txt"),
        checkpoint_path=os.path.join(d, "checkpoint.txt"),
        results_path=os.path.join(d, "ecm_results.txt"), verbose=0,
        stop_on_factor=False, **kw)


def _timed(d, **kw) -> dict:
    """One driver run: finds, save bytes, wall, split and curves/s."""
    import torch
    from tpu_ecm_torch import driver
    t0 = time.time()
    res = driver.ECMDriver(_cfg(d, **kw)).run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    t = res.timings
    with open(os.path.join(d, "save_b1.txt"), "rb") as fh:
        save = fh.read()
    return dict(finds=sorted((h.factor, h.stage, h.sigma)
                             for h in res.factors),
                save=save, wall=wall, curves=res.curves_run,
                curves_per_s=res.curves_run / wall,
                split={k: round(t.get(k, 0.0), 3) for k in (
                    "build", "stage1", "stage2_init", "stage2")},
                counters=dict(res.counters))


def _line(label, r) -> str:
    s = r["split"]
    return (f"{label}: {r['curves']} curves, wall {r['wall']:.2f} s, "
            f"{r['curves_per_s']:.2f} curves/s, build {s['build']:.2f} / "
            f"stage1 {s['stage1']:.2f} / stage2_init {s['stage2_init']:.2f}"
            f" / stage2 {s['stage2']:.2f} s, {len(r['finds'])} finds")


def _compare(label, one, split) -> dict:
    same = {k: split[k] == one[k] for k in ("finds", "save")}
    if not all(same.values()):
        raise AssertionError(f"{label}: the split run differs from one "
                             f"card: equal {same}")
    ratio = split["curves_per_s"] / one["curves_per_s"]
    print(f"  {label}: identical finds and save_b1.txt; split / one card "
          f"= {ratio:.3f}", flush=True)
    return dict(one={k: v for k, v in one.items() if k != "save"},
                split={k: v for k, v in split.items() if k != "save"},
                ratio=ratio, finds=len(one["finds"]))


def job_flagship(tmp) -> dict:
    import chip_smoke
    from tpu_ecm_torch.parallel import Sharder
    j = FLAGSHIP
    kw = dict(n=chip_smoke.N416, curves=j["curves"], b1=j["b1"],
              b2=j["b2"], sigma=j["sigma"], engine="digit")
    one = _timed(os.path.join(tmp, "flag1"), device="cuda:0",
                 batch=j["batch"], **kw)
    print("  " + _line(f"flagship, card 0, batches of {j['batch']}", one),
          flush=True)
    sh = Sharder()
    split = _timed(os.path.join(tmp, "flagn"), sharder=sh, **kw)
    print("  " + _line(f"flagship, {sh.n} cards, one batch", split),
          flush=True)
    return _compare("flagship", one, split)


def job_rns(tmp) -> dict:
    import chip_smoke
    from tpu_ecm_torch.parallel import Sharder
    j = chip_smoke.RNS_JOB
    kw = dict(n=chip_smoke.row21_n(), curves=4096, b1=j["b1"], b2=j["b2"],
              sigma=j["sigma"], engine="rns")
    one = _timed(os.path.join(tmp, "rns1"), device="cuda:0", **kw)
    print("  " + _line("rns, card 0", one), flush=True)
    sh = Sharder()
    split = _timed(os.path.join(tmp, "rnsn"), sharder=sh, **kw)
    print("  " + _line(f"rns, {sh.n} cards", split), flush=True)
    return _compare("rns", one, split)


def job_multihost(tmp, flag_dir=None) -> dict:
    """Two processes of one job over gloo, two cards each, against the
    flagship's one-card run of the same sigmas (its first 2048 records and
    their finds; without flag_dir, a one-card run of those 2048 curves)."""
    if flag_dir is None:
        import chip_smoke
        j = FLAGSHIP
        flag_dir = os.path.join(tmp, "mhref")
        ref = _timed(flag_dir, device="cuda:0", n=chip_smoke.N416,
                     curves=MULTIHOST_CURVES, b1=j["b1"], b2=j["b2"],
                     sigma=j["sigma"], engine="digit")
        print("  " + _line("multihost reference, card 0", ref), flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank, cards in enumerate(("0,1", "2,3")):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             str(rank), f"tcp://localhost:{port}",
             os.path.join(tmp, f"mh{rank}")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            p.kill()
    got = []
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"multihost child failed: {err[-3000:]}")
        got.append(json.loads(out.strip().splitlines()[-1]))
    finds = sorted(tuple(f) for r in got for f in r["finds"])
    save = b"".join(open(os.path.join(tmp, f"mh{r}", "save_b1.txt"),
                         "rb").read() for r in range(2))
    with open(os.path.join(flag_dir, "save_b1.txt"), "rb") as fh:
        recs = fh.read().splitlines(keepends=True)
    last = FLAGSHIP["sigma"] + MULTIHOST_CURVES
    want = b"".join(recs[:MULTIHOST_CURVES])
    results = os.path.join(flag_dir, "ecm_results.txt")
    text = open(results).read() if os.path.exists(results) else ""
    want_finds = sorted(f for f in _results_finds(text) if f[2] < last)
    if finds != want_finds or save != want:
        raise AssertionError(
            f"multihost: finds {'equal' if finds == want_finds else 'DIFFER'}"
            f", save files {'equal' if save == want else 'DIFFER'}")
    wall = max(r["wall"] for r in got)
    for r in got:
        print(f"  multihost rank {r['rank']} ({r['devices']}): "
              f"{r['curves']} curves, wall {r['wall']:.2f} s, split "
              f"{r['split']}, {len(r['finds'])} finds", flush=True)
    print(f"  multihost: the union of both processes' finds and save "
          f"files is the one-card run's; {MULTIHOST_CURVES / wall:.2f} "
          f"curves/s over the slower process", flush=True)
    return dict(ranks=got, curves_per_s=MULTIHOST_CURVES / wall,
                finds=len(finds))


def _results_finds(text):
    """(factor, stage, sigma) of each ecm_results.txt line."""
    import re
    return {(int(m.group(1)), int(m.group(2)), int(m.group(3)))
            for m in re.finditer(r"factor (\d+) in stage (\d+) .*sigma "
                                 r"(\d+)", text)}


def child(rank: int, init_method: str, d: str) -> int:
    """One process of the multihost job."""
    import torch
    import chip_smoke
    from tpu_ecm_torch.parallel import distributed
    j = FLAGSHIP
    t0 = time.time()
    res = distributed.run_multihost(
        chip_smoke.N416, total_curves=MULTIHOST_CURVES, b1=j["b1"],
        b2=j["b2"], sigma=j["sigma"], init_method=init_method,
        world_size=2, rank=rank, engine="digit", stop_on_factor=False,
        verbose=0, save_b1_path=os.path.join(d, "save_b1.txt"),
        checkpoint_path=os.path.join(d, "checkpoint.txt"),
        results_path=os.path.join(d, "ecm_results.txt"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    print(json.dumps(dict(
        rank=rank, devices=torch.cuda.device_count(), wall=wall,
        curves=res.curves_run,
        split={k: round(v, 3) for k, v in res.timings.items()},
        finds=sorted((h.factor, h.stage, h.sigma) for h in res.factors))))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", default=",".join(JOBS))
    ap.add_argument("--child", nargs=3, metavar=("RANK", "INIT", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        os.makedirs(args.child[2], exist_ok=True)
        return child(int(args.child[0]), args.child[1], args.child[2])
    import torch
    import chip_smoke
    from tpu_ecm_torch.limbs import build
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("multigpu_check: needs at least two NVIDIA GPUs",
              file=sys.stderr)
        return 1
    jobs = args.jobs.split(",")
    print(chip_smoke.smi_line(), flush=True)
    t0 = time.time()
    build.build()            # once, before any process loads it
    print(f"build {time.time() - t0:.2f} s", flush=True)
    out = dict(card=chip_smoke.smi_line(),
               cards=torch.cuda.device_count())
    tmp = tempfile.mkdtemp(prefix="multigpu_")
    if "flagship" in jobs:
        t0 = time.time()
        out["flagship"] = job_flagship(tmp)
        print(f"flagship job {time.time() - t0:.2f} s", flush=True)
    if "rns" in jobs:
        t0 = time.time()
        out["rns"] = job_rns(tmp)
        print(f"rns job {time.time() - t0:.2f} s", flush=True)
    if "multihost" in jobs:
        t0 = time.time()
        out["multihost"] = job_multihost(
            tmp, os.path.join(tmp, "flag1") if "flagship" in jobs else None)
        print(f"multihost job {time.time() - t0:.2f} s", flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "multigpu_check.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
