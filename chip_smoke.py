#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_ecm_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX.  Each phase prints one line with its name, its
result and its seconds; any failure raises and exits non-zero.

  1 device    the card's name and power limit; nvcc builds the kernels
              (registers, stack frame and spills of each are printed)
  2 kernels   every kernel against its plain PyTorch version on the card,
              on seeded random reduced inputs, and timed against it at the
              main path's own depths:
              digit K1-K5 at N64/B=128 on short stacks and at the 416-bit
              flagship/B=2048 (a 256-op stage-1 tape split over three
              launches, 4,096-row chain and inversion groups, a 65,536-entry
              replay block over a 4,097-row Pa group and the full Pb table);
              digits equal for K1-K4, values mod n for K5;
              RNS K10-K13 and K15 at N256/B=128 on short stacks and at the
              2397-bit row-21 geometry (K=200, 401 residue rows)/B=1024
              (a 256-op tape over three launches, the Pa group the memory
              rule picks, a 65,536-entry replay block, the rns job's
              963-row Pb table); residues equal, every one;
              then K1 against K10 per tape op on one 1536-bit modulus at
              B=1024 (ns per curve per op: the digit/RNS crossover datum)
  3 oracle    known answers through the driver: N71 sigma 112 finds P35 in
              stage 2 on both engines; the 57-hit golden sweep of
              tests/test_e2e.py; N256 gives the same stage-1 residues on
              both engines; the 2355-bit P35*prp(2320) of
              tests/test_rns_engine.py routes to RNS and finds P35 at
              sigma 112
  4 flagship  bench.py's job at full width: the 416-bit semiprime, 2048
              Suyama curves from sigma 7000 in one batch, B1=1e5, B2=1e7
              (cut 10x from 1e6/1e8 to fit the time limit); save_b1.txt
              must hold a record per curve, and every digit kernel must
              have launched during the run
  5 rns       row 21 of tests/test_acceptance.py at full width: its
              2397-bit N, 1024 Suyama curves from its sigma 377260338 in
              one batch, B1=25,000, B2=2,500,000 (cut 10x from B1=250,000,
              with B2 = 100*B1); save_b1.txt must hold a record per curve,
              every RNS kernel must have launched and no digit kernel

The last three lines are the kernels' JSON record, the card as nvidia-smi
reports it, and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [DIR] [--job flagship|rns|both]

runs phase 1 and then the chosen job(s) once under torch.profiler instead:
it prints the device time per kernel and the card's busy and idle share of
each job, and writes the whole per-kernel table to DIR/profile_<job>.txt
(DIR defaults to chiprun_out/, --job to both).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import random
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
N256 = (170141183460469231731687303715884105773
        * 340282366920938463463374607431768211507)   # tests/moduli.py
N416 = (205688069665150755269371147819668813122841983204197482918578443
        * 411376139330301510538742295639337626245683966408394965837157771)
FLAGSHIP = dict(curves=2048, sigma=7000, b1=100_000, b2=10_000_000)
# row 21 of tests/test_acceptance.py runs B1=250,000, B2=183,032,866
RNS_JOB = dict(curves=1024, sigma=377_260_338, b1=25_000, b2=2_500_000)
# short kernel-test stacks (main_path_depth gives the main path's own)
SHORT = dict(tape_ops=256, tape_slice=None, rows=64, pb_rows=97,
             entries=256)
RNS_SHORT = dict(tape_ops=32, tape_slice=None, rows=16, pb_rows=29,
                 entries=64)
# replay entries per call of the plain version: bounds its memory
PLAIN_REPLAY_BLOCK = 1024
DIGIT_KERNELS = ("tape", "chain", "prefix", "apply_inverse", "replay")
RNS_KERNELS = ("rns_tape", "rns_chain", "rns_prefix", "rns_apply_inverse",
               "rns_replay")


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


def _max_abs_err(got, want) -> int:
    """max |got - want| over stacks of planes, a block of leading rows at
    a time (a whole difference of two 12.5 GiB stacks would not fit)."""
    if got.shape != want.shape:
        raise AssertionError(f"shapes differ: {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    return max(int((g - w).abs().max().item())
               for g, w in zip(got.split(64), want.split(64)))


def _timed(fn, reps: int):
    """(last output, ms per call) of fn run reps times; the previous
    output is freed before each call, so two never coexist."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = None
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


def _sliced_tape(mod, pts, tape, sc, d, tape_slice):
    """mod.tape (kernels or rns_kernels) with its per-launch slice set to
    tape_slice ops."""
    if tape_slice is None:
        return mod.tape(pts.clone(), tape, sc, d)
    old, mod.TAPE_SLICE = mod.TAPE_SLICE, tape_slice
    try:
        return mod.tape(pts.clone(), tape, sc, d)
    finally:
        mod.TAPE_SLICE = old


def _replay_idx(rng, rows: int, pb_rows: int, entries: int):
    """A replay block [count, e...] over a Pa group of `rows` rows (row
    `rows` the one row) and pb_rows Pb rows: v-sorted live entries, 5 live
    pads rows << 16 | 0 and 3 entries past count."""
    import numpy as np
    pa = np.sort(rng.integers(0, rows, entries - 8))
    ent = np.concatenate([(pa << 16) | rng.integers(1, pb_rows, entries - 8),
                          np.full(8, rows << 16)]).astype(np.int32)
    return np.concatenate([[entries - 3], ent]).astype(np.int32)


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
    idx = _replay_idx(rng, rows, pb_rows, entries)
    acc = _rand_planes(rng, ctx, (nw, b))
    return {
        "tape": (lambda: _sliced_tape(kernels, pts, tape, sc, d,
                                      depth["tape_slice"]),
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


def _rand_residues(gen, rc, shape):
    """Random canonical residues [.., rows, B] on the card: every kernel
    takes any canonical residues, consistent across channels or not."""
    import torch
    r = torch.randint(0, 1 << 30, shape, device="cuda", dtype=torch.int32,
                      generator=gen)
    return r.remainder_(rc.p)


def rns_main_path_depth(ctx, rows: int, b: int) -> dict:
    """The stack sizes the main path gives the RNS kernels on the card for
    the rns job: the Pa group the memory rule picks for this geometry on
    this card, replay blocks of REPLAY_BLOCK entries, the job's Pb table; a
    tape slice of 100 ops splits the 256-op tape over three launches."""
    import torch
    from tpu_ecm_torch.stage2 import exec as s2, plan
    num_pb = plan.make_stage2_params(RNS_JOB["b1"], RNS_JOB["b2"],
                                     nw=ctx.p.nw, batch=b).num_pb
    free = (torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
            - torch.cuda.memory_allocated())
    return dict(tape_ops=256, tape_slice=100, pb_rows=num_pb,
                rows=s2.pa_group_for_memory(rows * b * 4, num_pb, free),
                entries=s2.REPLAY_BLOCK["cuda"])


def _rns_kernel_cases(rng, gen, host, rc, b, depth=RNS_SHORT):
    """name -> (kernel call, plain call) for K10-K13 and K15 on one
    geometry: B curves and the stack sizes of `depth`."""
    import torch
    from tpu_ecm.primes import primes_range
    from tpu_ecm_torch.curve import prac
    from tpu_ecm_torch.limbs import rns_exec, rns_kernels
    rows, entries, pb_rows = depth["rows"], depth["entries"], depth["pb_rows"]
    R = lambda *shape: _rand_residues(gen, rc, shape + (rc.rows, b))
    pts, sc = R(6, 2), R()
    tape = prac.stage1_tape(primes_range(0, RNS_JOB["b1"]),
                            RNS_JOB["b1"])[:depth["tape_ops"]]
    p1, p2, pd = R(2), R(2), R(2)
    xs, zs, pres = R(rows), R(rows), R(rows)
    one = torch.from_numpy(host.pack([host.to_mont_int(1)] * b)).cuda()
    tinv = R()
    pa_ext = torch.cat([R(rows), one[None]])
    pbx = R(pb_rows)
    pbx[0] = 0
    idx = _replay_idx(rng, rows, pb_rows, entries)
    acc = R()
    k = rns_kernels
    return {
        "rns_tape": (
            lambda: _sliced_tape(k, pts, tape, sc, rc, depth["tape_slice"]),
            lambda: rns_exec.run_tape(pts.clone(), tape, sc, rc)),
        "rns_chain": (lambda: k.chain(p1, p2, pd, rows, rc),
                      lambda: k.chain_plain(p1, p2, pd, rows, rc)),
        "rns_prefix": (lambda: k.prefix(zs, one, rc),
                       lambda: k.prefix_plain(zs, one, rc)),
        "rns_apply_inverse": (
            lambda: k.apply_inverse(xs, zs, pres, tinv, rc),
            lambda: k.apply_inverse_plain(xs, zs, pres, tinv, rc)),
        "rns_replay": (lambda: k.replay(acc, pa_ext, pbx, idx, rc),
                       lambda: k.replay_plain(acc, pa_ext, pbx, idx, rc)),
    }


def _crossover(rng, gen):
    """K1 and K10 on one 1536-bit modulus at B=1024, the same 256-op tape:
    ns per curve per tape op of each (the digit/RNS crossover datum)."""
    from tpu_ecm import params
    from tpu_ecm.primes import primes_range
    from tpu_ecm_torch.curve import prac
    from tpu_ecm_torch.limbs import kernels, rns, rns_kernels
    from tpu_ecm_torch.limbs.torch_ops import device_ctx
    b, ops = 1024, 256
    ctx = params.make_monty(n1536())
    tape = prac.stage1_tape(primes_range(0, RNS_JOB["b1"]),
                            RNS_JOB["b1"])[:ops]
    d = device_ctx(ctx, "cuda")
    pts = _rand_planes(rng, ctx, (6, 2, ctx.p.nw, b))
    sc = _rand_planes(rng, ctx, (ctx.p.nw, b))
    kernels.tape(pts.clone(), tape, sc, d)
    _, ms_d = _timed(lambda: kernels.tape(pts.clone(), tape, sc, d), 2)
    host = rns.make_rns(ctx, cw=rns.choose_cw(ctx.p.nbits))
    rc = rns.device_ctx(host, "cuda")
    rpts = _rand_residues(gen, rc, (6, 2, rc.rows, b))
    rsc = _rand_residues(gen, rc, (rc.rows, b))
    rns_kernels.tape(rpts.clone(), tape, rsc, rc)
    _, ms_r = _timed(lambda: rns_kernels.tape(rpts.clone(), tape, rsc, rc),
                     2)
    per = lambda ms: ms * 1e6 / (b * ops)
    return (f"1536-bit, B={b}: K1 (nw={ctx.p.nw}) {per(ms_d):.1f} ns, "
            f"K10 (K={rc.K}) {per(ms_r):.1f} ns per curve per tape op")


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
                err = _max_abs_err(got, want)
            if err != 0:
                raise AssertionError(f"{name} at {label}: kernel and plain "
                                     f"version differ (max abs err {err})")
            worst[name] = max(worst.get(name, 0), err)
            del got, want
            if label == "flagship":
                _, ms = _timed(kern, 2)
                record[name] = dict(max_abs_err=worst[name], ms=ms,
                                    plain_ms=plain_ms)
        del cases
    import torch
    from tpu_ecm_torch.limbs import rns
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    for label, n, b in (("N256", N256, 128), ("row21", row21_n(), 1024)):
        ctx = params.make_monty(n)
        host = rns.make_rns(ctx, cw=rns.choose_cw(ctx.p.nbits))
        rc = rns.device_ctx(host, "cuda")
        depth = (rns_main_path_depth(ctx, rc.rows, b) if label == "row21"
                 else RNS_SHORT)
        cases = _rns_kernel_cases(rng, gen, host, rc, b, depth)
        for name, (kern, plain) in cases.items():
            got = kern()
            want, plain_ms = _timed(plain, 1)
            err = _max_abs_err(got, want)
            if err != 0:
                raise AssertionError(f"{name} at {label}: kernel and plain "
                                     f"version differ (max abs err {err})")
            worst[name] = max(worst.get(name, 0), err)
            del got, want
            if label == "row21":
                _, ms = _timed(kern, 2)
                record[name] = dict(max_abs_err=worst[name], ms=ms,
                                    plain_ms=plain_ms)
        del cases
        torch.cuda.empty_cache()
    print(f"  rns depths at row 21 (K={rc.K}, B=1024): {depth}", flush=True)
    cross = _crossover(rng, gen)
    torch.cuda.empty_cache()
    return ("K1-K5 equal their plain versions at N64/B=128 (short stacks) "
            "and 416-bit/B=2048 (main-path depths); K10-K13, K15 at "
            "N256/B=128 (short stacks) and row 21/B=1024 (main-path "
            "depths); ms (kernel/plain): " + ", ".join(
                f"{k} {v['ms']:.3f}/{v['plain_ms']:.1f}"
                for k, v in record.items()) + "; " + cross)


# ---------------------------------------------------------------------------
# phases 3-4: the driver
# ---------------------------------------------------------------------------

def _test_constant(filename: str, name: str):
    """A literal constant of tests/<filename>, read without importing the
    test (the tests import the JAX package)."""
    with open(os.path.join(HERE, "tests", filename)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == name):
            return ast.literal_eval(node.value)
    raise LookupError(f"{name} not found in tests/{filename}")


def row21_n() -> int:
    """N of row 21 of tests/test_acceptance.py (2397 bits)."""
    from tpu_ecm.io import calc
    rows = _test_constant("test_acceptance.py", "REFSWEEP_ROWS")
    return calc.calc(next(r for r in rows if r[0] == 21)[1])


def n2355() -> int:
    """P35 * _prp(random.Random(5), 2320) of tests/test_rns_engine.py:251
    (2355 bits).  That prp is draw 2363 of its stream; taking the draw
    directly skips the slow search, and the Fermat tests are checked."""
    rng = random.Random(5)
    for _ in range(2363):
        c = rng.getrandbits(2320) | 1 | (1 << 2319)
    if not all(pow(a, c - 1, c) == 1 for a in (2, 3, 5, 7, 11)):
        raise AssertionError("draw 2363 is not the 2320-bit prp")
    return P35 * c


def n1536() -> int:
    """The 1536-bit P768*P768 of tests/test_rns_engine.py:64."""
    rng = random.Random(11)
    return _prp(rng, 768) * _prp(rng, 768)


def _prp(rng, bits: int) -> int:
    """tests/test_rns_engine.py:_prp."""
    while True:
        c = rng.getrandbits(bits) | 1 | (1 << (bits - 1))
        if all(pow(a, c - 1, c) == 1 for a in (2, 3, 5, 7, 11)):
            return c


def _run(tmp, **kw):
    from tpu_ecm_torch import driver
    os.makedirs(tmp, exist_ok=True)
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
    want = _test_constant("test_e2e.py", "GOLDEN_SWEEP")
    if got != want:
        raise AssertionError(f"golden sweep differs: missing "
                             f"{sorted(want - got)}, extra {sorted(got - want)}")
    from tpu_ecm_torch.limbs import kernels
    res = _run(os.path.join(tmp, "o3"), n=N71, curves=4, b1=300, b2=10000,
               sigma=110, engine="rns")
    hits = {(h.factor, h.stage, h.sigma) for h in res.factors}
    if (P35, 2, 112) not in hits:
        raise AssertionError(f"N71 sigma-112 RNS find missing: {hits}")
    r_d, r_r = (_run(os.path.join(tmp, f"o4{e}"), n=N256, curves=4, b1=500,
                     b2=500, sigma=40, engine=e) for e in ("digit", "rns"))
    if r_d.stage1_residues != r_r.stage1_residues:
        raise AssertionError("N256: the engines' stage-1 residues differ")
    kernels.reset_launches()
    res = _run(os.path.join(tmp, "o5"), n=n2355(), curves=4, b1=300,
               b2=10000, sigma=110, stop_on_factor=False)
    if kernels.launches["tape"] or not kernels.launches["rns_tape"]:
        raise AssertionError("2355 bits did not route to the RNS engine")
    if not any(h.factor % P35 == 0 and h.stage == 2 and h.sigma == 112
               for h in res.factors):
        raise AssertionError(f"2355-bit sigma-112 find missing: "
                             f"{res.factors}")
    return (f"(P35, 2, 112) found; golden sweep {len(got)}/{len(want)} "
            "equal; RNS: N71 (P35, 2, 112) found, N256 stage-1 residues "
            "equal to the digit engine's, 2355 bits routed to RNS and P35 "
            "found in stage 2 at sigma 112")


def phase_flagship(tmp, record):
    from tpu_ecm_torch.limbs import kernels
    f = FLAGSHIP
    kernels.reset_launches()
    t0 = time.time()
    res = _run(tmp, n=N416, curves=f["curves"], b1=f["b1"], b2=f["b2"],
               sigma=f["sigma"], stop_on_factor=False)
    wall = time.time() - t0
    counts = {k: kernels.launches[k] for k in DIGIT_KERNELS}
    for name, c in counts.items():
        record[name]["launches"] = c
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    _check_save(os.path.join(tmp, "save_b1.txt"), N416, f)
    if res.curves_run != f["curves"]:
        raise AssertionError(f"ran {res.curves_run} curves")
    t = res.timings
    return (f"{f['curves']} curves x 416 bits, B1={f['b1']}, B2={f['b2']}: "
            f"stage1 {t['stage1']:.2f} s, stage2_init "
            f"{t['stage2_init']:.2f} s, stage2 {t['stage2']:.2f} s, "
            f"wall {wall:.2f} s, {f['curves'] / wall:.2f} curves/s; "
            f"launches {counts}; factors {len(res.factors)}")


def _check_save(path, n, job):
    """save_b1.txt holds one canonical record per curve of the job."""
    from tpu_ecm.io import savefile
    with open(path) as fh:
        recs = list(savefile.parse_records(fh))
    sigmas = {r.sigma for r in recs}
    if (len(recs) != job["curves"]
            or any(r.n != n or r.b1 != job["b1"] or not 0 <= r.x < n
                   or not 0 < r.z < n for r in recs)
            or sigmas != set(range(job["sigma"],
                                   job["sigma"] + job["curves"]))):
        raise AssertionError(f"{path} does not hold one canonical record "
                             "per curve")


def phase_rns(tmp, record):
    """Row 21's N through run_ecm(engine="auto") at full width."""
    from tpu_ecm_torch.limbs import kernels
    j = RNS_JOB
    n = row21_n()
    kernels.reset_launches()
    t0 = time.time()
    res = _run(tmp, n=n, curves=j["curves"], b1=j["b1"], b2=j["b2"],
               sigma=j["sigma"], stop_on_factor=False)
    wall = time.time() - t0
    counts = {k: kernels.launches[k] for k in RNS_KERNELS}
    for name, c in counts.items():
        record[name]["launches"] = c
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"RNS kernels never launched: {missing}")
    digit = {k: kernels.launches[k] for k in DIGIT_KERNELS
             if kernels.launches[k]}
    if digit:
        raise AssertionError(f"digit kernels launched in the rns job: "
                             f"{digit}")
    _check_save(os.path.join(tmp, "save_b1.txt"), n, j)
    if res.curves_run != j["curves"]:
        raise AssertionError(f"ran {res.curves_run} curves")
    t = res.timings
    return (f"{j['curves']} curves x {n.bit_length()} bits, B1={j['b1']}, "
            f"B2={j['b2']}: stage1 {t['stage1']:.2f} s, stage2_init "
            f"{t['stage2_init']:.2f} s, stage2 {t['stage2']:.2f} s, "
            f"wall {wall:.2f} s, {j['curves'] / wall:.2f} curves/s; "
            f"launches {counts}; factors {len(res.factors)}")


PROFILE_JOBS = {"flagship": (N416, FLAGSHIP), "rns": (None, RNS_JOB)}


def profile_job(tmp, out_dir, job: str):
    """One job once under torch.profiler (after a small warm-up run of the
    same engine, so lazy set-up stays outside the window): device time per
    kernel, and the union of the card's kernel intervals against the job's
    wall time, which gives the card's idle share of the job."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n, j = PROFILE_JOBS[job]
    n = n or row21_n()
    _run(os.path.join(tmp, "o1"), n=N71, curves=4, b1=300, b2=10000,
         sigma=110, engine="digit" if job == "flagship" else "rns")
    sub = os.path.join(tmp, job)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = _run(sub, n=n, curves=j["curves"], b1=j["b1"], b2=j["b2"],
                   sigma=j["sigma"], stop_on_factor=False)
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
    path = os.path.join(out_dir, f"profile_{job}.txt")
    with open(path, "w") as fh:
        fh.write(f"{smi_line()}\n")
        for name, (count, us) in rows:
            fh.write(f"{us / 1e6:12.6f} s {count:8d}x  {name}\n")
    for name, (count, us) in rows[:8]:
        print(f"  {us / 1e6:12.6f} s {count:8d}x  {name[:70]}")
    t = res.timings
    return (f"{job}: stage1 {t['stage1']:.2f} s, stage2_init "
            f"{t['stage2_init']:.2f} s, stage2 {t['stage2']:.2f} s, "
            f"job wall {wall:.2f} s; device busy (union of kernel "
            f"intervals) {busy:.2f} s, idle share {1 - busy / wall:.4f}; "
            f"table in {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", nargs="?", metavar="DIR",
                    const=os.path.join(HERE, "chiprun_out"),
                    help="profile a job instead of the smoke phases; "
                         "write its kernel table under DIR")
    ap.add_argument("--job", choices=("flagship", "rns", "both"),
                    default="both", help="the job(s) --profile runs")
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
        phase("device", phase_device)
        if args.profile:
            jobs = (("flagship", "rns") if args.job == "both"
                    else (args.job,))
            for job in jobs:
                phase("profile",
                      lambda: profile_job(tmp, args.profile, job))
            return 0
        phase("kernels", lambda: phase_kernels(record))
        phase("oracle", lambda: phase_oracle(tmp))
        phase("flagship",
              lambda: phase_flagship(os.path.join(tmp, "flagship"), record))
        phase("rns", lambda: phase_rns(os.path.join(tmp, "rns"), record))
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
