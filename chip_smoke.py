#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_ecm_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX.  Each phase prints one line with its name, its
result and its seconds; any failure raises and exits non-zero.

  1 device    the card's name and power limit; nvcc builds the kernels
  2 kernels   K1-K5 against their plain PyTorch versions on the card, on
              seeded random reduced inputs: at N64/B=128 on short stacks,
              and at the 416-bit flagship/B=2048 at the main path's own
              depths (a 256-op stage-1 tape split over three launches,
              4,096-row chain and inversion groups, a 65,536-entry replay
              block over a 4,097-row Pa group and the full Pb table); digits
              must be equal for K1-K4, values mod n for K5; each kernel is
              timed against its plain version at the flagship depths
  3 oracle    N71 known answers through the driver: the sigma-112 stage-2
              find and the 57-hit golden sweep of tests/test_e2e.py
  4 flagship  bench.py's job at full width: the 416-bit semiprime, 2048
              Suyama curves from sigma 7000 in one batch, B1=1e5, B2=1e7
              (cut 10x from 1e6/1e8 to fit the time limit); save_b1.txt
              must hold a record per curve, and every kernel must have
              launched during the run

The last three lines are the kernels' JSON record, the card as nvidia-smi
reports it, and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [DIR]

runs phase 1 and then the flagship job once under torch.profiler instead:
it prints the device time per kernel and the card's busy and idle share of
the job, and writes the whole per-kernel table to DIR/profile_flagship.txt
(DIR defaults to chiprun_out/).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N64 = 2545580083 * 2551628647
P35, P36 = 34359738421, 68719476767
N71 = P35 * P36
N416 = (205688069665150755269371147819668813122841983204197482918578443
        * 411376139330301510538742295639337626245683966408394965837157771)
FLAGSHIP = dict(curves=2048, sigma=7000, b1=100_000, b2=10_000_000)
# short kernel-test stacks (main_path_depth gives the main path's own)
SHORT = dict(tape_ops=256, tape_slice=None, rows=64, pb_rows=97,
             entries=256)
# replay entries per call of the plain version: bounds its memory
PLAIN_REPLAY_BLOCK = 1024


def phase(name: str, fn):
    t0 = time.time()
    result = fn()
    print(f"phase {name}: {result} ({time.time() - t0:.2f} s)", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch
    from tpu_ecm_torch.limbs import build
    path = build.build()
    build.library()
    log = open(path[:-3] + ".log").read()
    for line in log.splitlines():
        if re.search(r"Compiling entry|Used \d+ registers|spill", line):
            print("  nvcc:", line.strip())
    return (f"{torch.cuda.get_device_name(0)} | {smi_line()} | "
            f"built {os.path.relpath(path, HERE)}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand_planes(rng, ctx, shape):
    """Random values below 2^(w*k) <= n/2, k whole digits: reduced."""
    import numpy as np
    import torch
    p = ctx.p
    k = (p.nbits - 1) // p.w
    a = np.zeros(shape, dtype=np.int32)
    a[..., :k, :] = rng.integers(0, 1 << p.w, size=shape[:-2] + (k, shape[-1]),
                                 dtype=np.int32)
    return torch.from_numpy(a).cuda()


def _canon(plane, ctx):
    from tpu_ecm_torch.limbs import layout
    return [v % ctx.n_int
            for v in layout.unpack_batch(plane.cpu().numpy(), ctx.p.w)]


def _timed(fn, reps: int):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def _replay_plain(acc, pa_ext, pbx, idx, d):
    """The plain K5 over blocks of PLAIN_REPLAY_BLOCK live entries, acc
    carried across: the same product, in the same order of quadruples."""
    import numpy as np
    from tpu_ecm_torch.limbs import kernels
    live = idx[1:1 + int(idx[0])]
    for lo in range(0, live.size, PLAIN_REPLAY_BLOCK):
        blk = live[lo:lo + PLAIN_REPLAY_BLOCK]
        acc = kernels.replay_plain(
            acc, pa_ext, pbx,
            np.concatenate([np.asarray([blk.size], np.int32), blk]), d)
    return acc


def _sliced_tape(pts, tape, sc, d, tape_slice):
    """kernels.tape with its per-launch slice set to tape_slice ops."""
    from tpu_ecm_torch.limbs import kernels
    if tape_slice is None:
        return kernels.tape(pts.clone(), tape, sc, d)
    old, kernels.TAPE_SLICE = kernels.TAPE_SLICE, tape_slice
    try:
        return kernels.tape(pts.clone(), tape, sc, d)
    finally:
        kernels.TAPE_SLICE = old


def main_path_depth(nw: int, b: int) -> dict:
    """The stack sizes the main path gives the kernels on the card at the
    flagship bounds: Pa groups of PA_GROUP rows, replay blocks of
    REPLAY_BLOCK entries, the whole Pb table; a tape slice of 100 ops
    splits the 256-op tape over three launches."""
    from tpu_ecm_torch.stage2 import exec as s2, plan
    return dict(tape_ops=256, tape_slice=100, rows=s2.PA_GROUP["cuda"],
                pb_rows=plan.make_stage2_params(
                    FLAGSHIP["b1"], FLAGSHIP["b2"], nw=nw, batch=b).num_pb,
                entries=s2.REPLAY_BLOCK["cuda"])


def _kernel_cases(rng, ctx, b, depth=SHORT):
    """name -> (kernel call, plain call, compare mod n?) on one geometry:
    B curves and the stack sizes of `depth`."""
    import numpy as np
    import torch
    from tpu_ecm.primes import primes_range
    from tpu_ecm_torch.curve import ops, prac
    from tpu_ecm_torch.limbs import kernels, layout
    from tpu_ecm_torch.limbs.torch_ops import device_ctx
    d = device_ctx(ctx, "cuda")
    nw = ctx.p.nw
    rows, entries, pb_rows = depth["rows"], depth["entries"], depth["pb_rows"]
    pts = _rand_planes(rng, ctx, (6, 2, nw, b))
    sc = _rand_planes(rng, ctx, (nw, b))
    tape = prac.stage1_tape(primes_range(0, FLAGSHIP["b1"]),
                            FLAGSHIP["b1"])[:depth["tape_ops"]]
    p1, p2, pd = (_rand_planes(rng, ctx, (2, nw, b)) for _ in range(3))
    xs, zs, pres = (_rand_planes(rng, ctx, (rows, nw, b)) for _ in range(3))
    one = torch.from_numpy(layout.broadcast_int(ctx.r_mod_n, ctx.p.w, nw,
                                                b)).cuda()
    tinv = _rand_planes(rng, ctx, (nw, b))
    pa_ext = torch.cat([_rand_planes(rng, ctx, (rows, nw, b)), one[None]])
    pbx = _rand_planes(rng, ctx, (pb_rows, nw, b))
    pbx[0] = 0
    # v-sorted live entries, 5 live pads G << 16 | 0 and 3 past idx[0]
    pa = np.sort(rng.integers(0, rows, entries - 8))
    ent = np.concatenate([(pa << 16) | rng.integers(1, pb_rows, entries - 8),
                          np.full(8, rows << 16)]).astype(np.int32)
    idx = np.concatenate([[entries - 3], ent]).astype(np.int32)
    acc = _rand_planes(rng, ctx, (nw, b))
    return {
        "tape": (lambda: _sliced_tape(pts, tape, sc, d, depth["tape_slice"]),
                 lambda: ops.run_tape(pts.clone(), tape, sc, d), False),
        "chain": (lambda: kernels.chain(p1, p2, pd, rows, d),
                  lambda: kernels.chain_plain(p1, p2, pd, rows, d), False),
        "prefix": (lambda: kernels.prefix(zs, one, d),
                   lambda: kernels.prefix_plain(zs, one, d), False),
        "apply_inverse": (
            lambda: kernels.apply_inverse(xs, zs, pres, tinv, d),
            lambda: kernels.apply_inverse_plain(xs, zs, pres, tinv, d),
            False),
        "replay": (lambda: kernels.replay(acc, pa_ext, pbx, idx, d),
                   lambda: _replay_plain(acc, pa_ext, pbx, idx, d), True),
    }


def phase_kernels(record):
    import numpy as np
    from tpu_ecm import params
    rng = np.random.default_rng(20261016)
    worst = {}
    for label, n, b in (("N64", N64, 128), ("flagship", N416, 2048)):
        ctx = params.make_monty(n)
        depth = (main_path_depth(ctx.p.nw, b) if label == "flagship"
                 else SHORT)
        cases = _kernel_cases(rng, ctx, b, depth)
        for name, (kern, plain, mod_n) in cases.items():
            got = kern()
            want, plain_ms = _timed(plain, 1)
            if mod_n:
                g, w = _canon(got, ctx), _canon(want, ctx)
                err = max(abs(x - y) for x, y in zip(g, w))
            else:
                err = int((got - want).abs().max().item())
            if err != 0:
                raise AssertionError(f"{name} at {label}: kernel and plain "
                                     f"version differ (max abs err {err})")
            worst[name] = max(worst.get(name, 0), err)
            if label == "flagship":
                _, ms = _timed(kern, 2)
                record[name] = dict(max_abs_err=worst[name], ms=ms,
                                    plain_ms=plain_ms)
            del got, want
        del cases
    return ("K1-K5 equal their plain versions at N64/B=128 (short stacks) "
            "and 416-bit/B=2048 (main-path depths); flagship ms "
            "(kernel/plain): " + ", ".join(
                f"{k} {v['ms']:.3f}/{v['plain_ms']:.1f}"
                for k, v in record.items()))


# ---------------------------------------------------------------------------
# phases 3-4: the driver
# ---------------------------------------------------------------------------

def _golden_sweep():
    """GOLDEN_SWEEP of tests/test_e2e.py, read without importing the test
    (it imports the JAX package)."""
    with open(os.path.join(HERE, "tests", "test_e2e.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "GOLDEN_SWEEP"):
            return ast.literal_eval(node.value)
    raise LookupError("GOLDEN_SWEEP not found in tests/test_e2e.py")


def _run(tmp, **kw):
    from tpu_ecm_torch import driver
    kw.setdefault("verbose", 0)
    return driver.run_ecm(
        save_b1_path=os.path.join(tmp, "save_b1.txt"),
        checkpoint_path=os.path.join(tmp, "checkpoint.txt"),
        results_path=os.path.join(tmp, "ecm_results.txt"),
        device="cuda", **kw)


def phase_oracle(tmp):
    res = _run(os.path.join(tmp, "o1"), n=N71, curves=4, b1=300, b2=10000,
               sigma=110)
    hits = {(h.factor, h.stage, h.sigma) for h in res.factors}
    if (P35, 2, 112) not in hits:
        raise AssertionError(f"N71 sigma-112 stage-2 find missing: {hits}")
    res = _run(os.path.join(tmp, "o2"), n=N71, curves=128, b1=2000,
               b2=200000, sigma=110, stop_on_factor=False)
    got = {(h.factor, h.stage, h.sigma) for h in res.factors}
    want = _golden_sweep()
    if got != want:
        raise AssertionError(f"golden sweep differs: missing "
                             f"{sorted(want - got)}, extra {sorted(got - want)}")
    return f"(P35, 2, 112) found; golden sweep {len(got)}/{len(want)} equal"


def phase_flagship(tmp, record):
    from tpu_ecm.io import savefile
    from tpu_ecm_torch.limbs import kernels
    f = FLAGSHIP
    kernels.reset_launches()
    t0 = time.time()
    res = _run(tmp, n=N416, curves=f["curves"], b1=f["b1"], b2=f["b2"],
               sigma=f["sigma"], stop_on_factor=False)
    wall = time.time() - t0
    counts = dict(kernels.launches)
    for name, c in counts.items():
        record[name]["launches"] = c
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    with open(os.path.join(tmp, "save_b1.txt")) as fh:
        recs = list(savefile.parse_records(fh))
    sigmas = {r.sigma for r in recs}
    if (len(recs) != f["curves"] or any(r.n != N416 or r.b1 != f["b1"]
                                         or not 0 <= r.x < N416
                                         or not 0 < r.z < N416 for r in recs)
            or sigmas != set(range(f["sigma"], f["sigma"] + f["curves"]))):
        raise AssertionError("save_b1.txt does not hold one canonical "
                             "record per flagship curve")
    if res.curves_run != f["curves"]:
        raise AssertionError(f"ran {res.curves_run} curves")
    t = res.timings
    return (f"{f['curves']} curves x 416 bits, B1={f['b1']}, B2={f['b2']}: "
            f"stage1 {t['stage1']:.2f} s, stage2_init "
            f"{t['stage2_init']:.2f} s, stage2 {t['stage2']:.2f} s, "
            f"wall {wall:.2f} s, {f['curves'] / wall:.2f} curves/s; "
            f"launches {counts}; factors {len(res.factors)}")


def profile_flagship(tmp, out_dir):
    """The flagship job once under torch.profiler (after a small warm-up
    run, so lazy set-up stays outside the window): device time per kernel,
    and the union of the card's kernel intervals against the job's wall
    time, which gives the card's idle share of the job."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    f = FLAGSHIP
    _run(os.path.join(tmp, "o1"), n=N71, curves=4, b1=300, b2=10000,
         sigma=110)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = _run(tmp, n=N416, curves=f["curves"], b1=f["b1"], b2=f["b2"],
                   sigma=f["sigma"], stop_on_factor=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    per_name, busy, lo, hi = {}, 0, None, None
    for a, b, name in spans:
        n_us = per_name.setdefault(name, [0, 0])
        n_us[0] += 1
        n_us[1] += b - a
        if hi is None or a > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy = (busy + (hi - lo if hi is not None else 0)) / 1e6
    rows = sorted(per_name.items(), key=lambda kv: -kv[1][1])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "profile_flagship.txt")
    with open(path, "w") as fh:
        fh.write(f"{smi_line()}\n")
        for name, (count, us) in rows:
            fh.write(f"{us / 1e6:12.6f} s {count:8d}x  {name}\n")
    for name, (count, us) in rows[:8]:
        print(f"  {us / 1e6:12.6f} s {count:8d}x  {name[:70]}")
    t = res.timings
    return (f"stage1 {t['stage1']:.2f} s, stage2_init "
            f"{t['stage2_init']:.2f} s, stage2 {t['stage2']:.2f} s, "
            f"job wall {wall:.2f} s; device busy (union of kernel "
            f"intervals) {busy:.2f} s, idle share {1 - busy / wall:.4f}; "
            f"table in {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", nargs="?", metavar="DIR",
                    const=os.path.join(HERE, "chiprun_out"),
                    help="profile the flagship job instead of the smoke "
                         "phases; write the kernel table under DIR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from tpu_ecm_torch.limbs import kernels

    record = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for sub in ("o1", "o2"):
            os.makedirs(os.path.join(tmp, sub))
        phase("device", phase_device)
        if args.profile:
            phase("profile", lambda: profile_flagship(tmp, args.profile))
            return 0
        phase("kernels", lambda: phase_kernels(record))
        phase("oracle", lambda: phase_oracle(tmp))
        phase("flagship", lambda: phase_flagship(tmp, record))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = []
    for name, (source, replaces) in kernels.KERNELS.items():
        r = record[name]
        out.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, launches=r["launches"],
                        max_abs_err=r["max_abs_err"], ms=r["ms"],
                        plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": out}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
