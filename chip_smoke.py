#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_ecm_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX.  Each phase prints one line with its name, its
result and its seconds; any failure raises and exits non-zero.

  1 device    the card's name and power limit; whether the native host
              library (g++) loaded; nvcc builds the kernels (registers,
              stack frame and spills of each are printed)
  2 kernels   every kernel against its plain PyTorch version on the card,
              on seeded random reduced inputs, and timed against it at the
              main path's own depths:
              digit K1-K9 at N64/B=128 on short stacks (K8 with slabs of
              8 rows) and at the 416-bit flagship/B=2048 (a 256-op
              stage-1 tape split over three launches, 4,096-row chain and
              inversion groups, the full Pb table, K5-K8 on the index
              arrays of the flagship job's first replay call in their
              mode: its first 65,536 entries as stream entries, as [T, 2]
              pairs in 16-entry steps, in 4,096 shared-Pa-row steps, and
              partitioned by slabs of the rows a block's shared memory
              holds on this card; a 256-op Edwards tape);
              the same nine in fold mode at M127 = 2^127-1/B=128 on short
              stacks, and at M1277 = 2^1277-1 (w=11, nw=118)/B=2048 at
              the mersenne job's depths (the same 256-op tapes over three
              launches, the Pa group the memory rule picks, the job's Pb
              table and first replay calls), each timed by its compared
              launch, with the plain versions run on the first 128
              curves; digits equal for K1-K9 (K5's
              plain version at these depths runs in blocks of
              kernels.PLAIN_REPLAY_BLOCK entries, a multiple of 4, so its
              quadruples are the kernel's); K6 on K8's own entries
              (digits equal to K8's, its ms per live entry in K8's line);
              RNS K10-K15 at N256/B=128 on short stacks and at the
              2397-bit row-21 geometry (K=200, 401 residue rows)/B=1024
              (a 256-op tape over three launches, the Pa group the memory
              rule picks, the rns job's 963-row Pb table and first replay
              calls); residues equal, every one;
              the lane-core kernels' (K1-K9's) lines at both main-path
              depths give their geometry (lanes a curve, digits a lane,
              curves a block, blocks, resident and launched warps per SM),
              their instantiation's ptxas report (registers, stack frame,
              spills) and their share of the bound, K5's-K8's also their
              ms per live entry, K8's its slabs, slab height and shared
              memory a block, and K2's-K9's their ms beside the
              one-thread kernel's (_lanes_line);
              K10's line (_k10_line) gives its tile, threads, blocks,
              shared memory a block, whether its weights are resident,
              its ptxas report, its share of the bound and its ms beside
              K10_BEFORE's; K11's, K12's and K13's (_rows_line) the same
              with their products a pass, rows and us a row, beside
              K11_BEFORE's, K12_BEFORE's and K13_BEFORE's; K14's and
              K15's (_rns_replay_line) the same with their products a
              pass, their live entries and the bytes their row loads
              move, beside K14_BEFORE's and K15_BEFORE's;
              the plain versions run their single-plane products from
              CUDA graphs (_graphed_products); the replay kernels' bounds
              count a product per live entry, and their lines give the
              live entries, the slots and the ms per live entry;
              then K1 against K10 per tape op on one 1536-bit modulus at
              B=1024 (ns per curve per op: the digit/RNS crossover datum),
              and K1 in fold mode at M1277 against K1 in REDC mode on a
              random odd 1277-bit N at B=2048 (ms per tape op: the fold's
              datum)
  3 oracle    known answers through the driver: N71 sigma 112 finds P35 in
              stage 2 on both engines; the 57-hit golden sweep of
              tests/test_e2e.py; N256 gives the same stage-1 residues on
              both engines; the 2355-bit P35*prp(2320) of
              tests/test_rns_engine.py routes to RNS and finds P35 at
              sigma 112; on M101 = 2^101-1 (fold) sigma 511 finds its P13
              in stage 1 and sigma 502 in stage 2 (tests/test_e2e.py:497);
              Edwards curves on N71 find P35 at sigma 46 in stage 1 and at
              sigma 29 in stage 2 (tests/test_edwards.py:154-165); the
              replay modes: N71 finds P35 at sigma 112 in stage 2 under
              gather, parow and resident (digit) and gather (RNS), the
              2355-bit N under gather, M101 its P13 at sigma 502 under
              gather, parow and resident, each through its mode's kernel
  4 flagship  bench.py's job at full width: the 416-bit semiprime, 2048
              Suyama curves from sigma 7000 in one batch, B1=1e5, B2=1e7
              (cut 10x from 1e6/1e8 to fit the time limit); save_b1.txt
              must hold a record per curve, and every digit kernel but K9
              must have launched during the run
  5 rns       row 21 of test.csh (tpu_ecm_torch/acceptance.py) at full
              width: its
              2397-bit N, 1024 Suyama curves from its sigma 377260338 in
              one batch, B1=25,000, B2=2,500,000 (cut 10x from B1=250,000,
              with B2 = 100*B1); save_b1.txt must hold a record per curve,
              K10-K13 and the replay kernel of the RNS engine's default
              mode (K15) must have launched and no digit kernel
  6 mersenne  M1277 = 2^1277-1, the smallest Mersenne number with no known
              factor, at full width: 2048 Suyama curves from sigma 7000 in
              one batch, B1=10,000, B2=1,000,000; the fold must be on,
              K1-K5 must have launched, save_b1.txt must hold a record per
              curve with N = M1277, and the first 4 curves' stage-1 (X, Z)
              must equal the exact integer replay of curve/oracle.py
  7 edwards   the flagship job with Edwards curves (curve_mode="edwards"):
              the 416-bit N, 2048 curves from sigma 7000, B1=1e5, B2=1e7;
              K9 and K2-K5 must have launched and K1 not in stage 1 (stage
              2 runs its point ladders through K1), save_b1.txt must
              hold an AVX-ECM-ED record per curve, and the first 4 curves'
              stage-1 points must equal edwards.oracle_scalar_mul,
              projectively, through to_montgomery_xz
  8 replay    the replay modes at full width: a 416-bit N with a 20-digit
              factor (replay_n), 2048 curves from sigma 7000, B1=20,000,
              B2=2,000,000, in stream, gather, parow and resident (K5-K8),
              and
              the 2355-bit n2355() with 1024 curves from sigma 110,
              B1=2,000, B2=200,000, in stream and gather (K15, K14); each
              run prints its entries and entry slots (a call pads to
              whole 16-entry steps at most) and must launch its mode's
              replay kernel and no other, and the modes' (factor, stage,
              sigma) sets (with a stage-2 find) and paired/ptadds/numinv
              counters must be identical
  9 surface   the rest of the single-process surface at phase 8's full
              width: phase 8's digit job with cross="noinv" (its finds a
              subset of the stream run's, with a stage-2 find; numinv 0;
              K1 and K2 launched, K3-K8 not; its entries and stage-2
              seconds printed); resume_stage2 of phase 8's digit and RNS
              stream save_b1.txt (copies) to their B2 (the stream runs'
              finds and paired counts; the engine's stage-2 kernels
              launched, on RNS no digit kernel); stage 1 of the digit job
              with full_prac=True (its residues the reduced rule set's as
              points, K1 launched)
 10 multidevice  phase 8's digit and RNS stream jobs with the curve axis
              split (parallel.Sharder over ["cuda:0", "cuda:0"] on one
              card, over every card when there are more): phase 8's
              finds, paired and numinv counters and save_b1.txt bytes
              exactly, through the engine's kernels; then
              parallel.distributed.run_multihost in this one process on
              the digit job, the same; each run's curves/s beside phase
              8's
 11 acceptance  row 13 of the reference's test.csh at its full bounds
              through the acceptance sweep's row runner
              (tpu_ecm_torch/acceptance.py, tools/refsweep_card.py): the
              761-bit N, 8 curves from sigma 1568738653, B1=239,049,
              B2=128,973,400 (stage 2 over two 1e8 prime chunks), on the
              engine "auto" picks (digit, nw=71); the reference's C69 (or
              a divisor or multiple of it) must come at that sigma in
              stage 2 (acceptance.match_row), and K1-K5 must have
              launched; the line gives the wall, the stage split, the
              chunks, D, U, the Pa group and the hits

The last three lines are the kernels' JSON record (with each kernel's
bound: the larger of its multiply-adds over the card's int32 rate and its
bytes over the memory rate; for K10-K15 the larger of their extension
dots at the int8 tensor peak and their channel work at the int32 rate,
against the bytes: _rns_bound), the card as nvidia-smi reports it, and
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [DIR] [--job JOB|all]

runs phase 1 and then the chosen job (flagship, rns, mersenne, edwards;
default all) once under torch.profiler instead: it prints the device time
per kernel and the card's busy and idle share of each job, and writes the
whole per-kernel table to DIR/profile_<job>.txt (DIR defaults to
chiprun_out/).
"""

from __future__ import annotations

import argparse
import ast
import contextlib
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
M101 = (1 << 101) - 1
M101_P13 = 7432339208719
M127 = (1 << 127) - 1
M1277 = (1 << 1277) - 1
FLAGSHIP = dict(curves=2048, sigma=7000, b1=100_000, b2=10_000_000)
# row 21 of test.csh runs B1=250,000, B2=183,032,866
RNS_JOB = dict(curves=1024, sigma=377_260_338, b1=25_000, b2=2_500_000)
MERSENNE_JOB = dict(curves=2048, sigma=7000, b1=10_000, b2=1_000_000)
# short kernel-test stacks (main_path_depth gives the main path's own)
SHORT = dict(tape_ops=256, tape_slice=None, rows=64, pb_rows=97,
             entries=256, ed_ops=64, cap=8)
RNS_SHORT = dict(tape_ops=32, tape_slice=None, rows=16, pb_rows=29,
                 entries=64)
# curves the plain versions run on at M1277's main-path depths (curves are
# independent: the kernel's first PLAIN_CURVES columns are compared)
PLAIN_CURVES = 128
# the kernels every job of an engine launches besides the replay kernel of
# the engine's default mode (_job_kernels)
DIGIT_BASE = ("tape", "chain", "prefix", "apply_inverse")
RNS_BASE = ("rns_tape", "rns_chain", "rns_prefix", "rns_apply_inverse")
# phase 8 at full width: a 416-bit N with a 20-digit factor (the flagship's
# radix and digit count) through the digit engine's three modes, and the
# 2355-bit n2355() through the RNS engine's two
REPLAY_SEED = 0
REPLAY_JOB = dict(curves=2048, sigma=7000, b1=20_000, b2=2_000_000)
RNS_REPLAY_JOB = dict(curves=1024, sigma=110, b1=2_000, b2=200_000)
# The card's peak rates for a kernel's bound: int32 multiply-adds at 64 per
# SM per clock (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions, compute capability 9.0) x 132 SMs x 1.98 GHz (the boost
# clock behind the data sheet's 67 TFLOP/s fp32 = 132 x 128 x 2 x 1.98e9),
# and 3.35 TB/s of HBM3 (NVIDIA H100 SXM data sheet).
IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# int8 tensor-core operations (two a multiply-add), dense: 1,979 TOPS
# (NVIDIA H100 SXM data sheet), the RNS extension dots' peak as exact u8
# splits
TENSOR_INT8_OPS_PER_S = 1.979e15
# The lane-core kernels (csrc/arith_lanes.cuh): name -> (label, kernel
# template, occupancy entry point)
LANE_KERNELS = {
    "tape": ("K1", "tape_lanes_kernel", "tpuecm_tape_occupancy"),
    "chain": ("K2", "chain_lanes_kernel", "tpuecm_chain_occupancy"),
    "prefix": ("K3", "prefix_lanes_kernel", "tpuecm_prefix_occupancy"),
    "apply_inverse": ("K4", "apply_inverse_lanes_kernel",
                      "tpuecm_apply_inverse_occupancy"),
    "replay": ("K5", "replay_lanes_kernel", "tpuecm_replay_occupancy"),
    "replay_gather": ("K6", "replay_gather_lanes_kernel",
                      "tpuecm_replay_gather_occupancy"),
    "replay_parow": ("K7", "replay_parow_lanes_kernel",
                     "tpuecm_replay_parow_occupancy"),
    "replay_resident": ("K8", "replay_resident_lanes_kernel",
                        "tpuecm_replay_resident_occupancy"),
    "ed_tape": ("K9", "ed_tape_lanes_kernel", "tpuecm_ed_tape_occupancy"),
}
# K5 on the one-thread core (csrc/arith.cuh) before it moved to the lane
# core, on this smoke's first replay call at each main-path depth: ms per
# call and per live entry (PERF.md section 6, NVIDIA H100 80GB HBM3,
# 700 W)
K5_ONE_THREAD = {"flagship": (2591.990, 0.03955),
                 "M1277": (10594.312, 0.21363)}
# K6 and K7 on the one-thread core before they moved to the lane core, on
# this smoke's first replay call at each main-path depth in their mode:
# ms per call and per live entry (PERF.md section 6, NVIDIA H100 80GB
# HBM3, 700 W)
K6_ONE_THREAD = {"flagship": (2919.128, 0.04454),
                 "M1277": (11343.829, 0.22874)}
K7_ONE_THREAD = {"flagship": (2856.605, 0.04672),
                 "M1277": (11886.074, 0.23968)}
# K8 on the one-thread core (32 curves a block, slabs of 49 and 14 rows)
# before it moved to the lane core, on this smoke's first resident call at
# each main-path depth: ms per call and per live entry (PERF.md section 6,
# NVIDIA H100 80GB HBM3, 700 W)
K8_ONE_THREAD = {"flagship": (2881.121, 0.04397),
                 "M1277": (28962.963, 0.58402)}
# K9 on the one-thread core before it moved to the lane core: ms per
# 256-op Edwards tape over three launches at each main-path depth (the
# flagship's from this smoke's phase 2, M1277's from tools/ed_tape_time.py;
# PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W)
K9_ONE_THREAD = {"flagship": 66.910, "M1277": 344.119}
# K2 on the one-thread core before it moved to the lane core: ms per
# 4,096-row chain group at each main-path depth (this smoke's phase 2;
# PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W)
K2_ONE_THREAD = {"flagship": 900.502, "M1277": 5082.399}
# K3 and K4 on the one-thread core before they moved to the lane core: ms
# per 4,096-row group at each main-path depth (this smoke's phase 2;
# PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W)
K3_ONE_THREAD = {"flagship": 168.918, "M1277": 839.021}
K4_ONE_THREAD = {"flagship": 477.301, "M1277": 2562.009}
# K10 on csrc/rns_arith.cuh (4 curves a block, integer-pipe dots, `%`
# reductions) before it moved to the tensor cores: ms per 256-op tape over
# three launches at row 21 (K=200, B=1024; this smoke's phase 2, PERF.md
# section 6, NVIDIA H100 80GB HBM3, 700 W)
K10_BEFORE = {"row21": 32.144}
# K11 on csrc/rns_arith.cuh (4 curves a block, one product at a time,
# integer-pipe dots, `%` reductions) before it moved to the tensor cores:
# ms per chain of the Pa group the memory rule picks at row 21 (K=200,
# B=1024, 4,096 rows; this smoke's phase 2, PERF.md section 6, NVIDIA
# H100 80GB HBM3, 700 W)
K11_BEFORE = {"row21": 555.088}
# K14 on csrc/rns_arith.cuh (one product at a time, integer-pipe dots, `%`
# reductions) before it moved to the tensor cores: ms on the rns job's
# first replay call at row 21 (K=200, B=1024, 65,536 entries; this smoke's
# phase 2, PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W)
K14_BEFORE = {"row21": 1464.523}
# K12 and K13 on csrc/rns_arith.cuh (4 curves a block, one product at a
# time, integer-pipe dots, `%` reductions) before they moved to the tensor
# cores: ms per stack of the Pa group the memory rule picks at row 21
# (K=200, B=1024, 4,096 rows; this smoke's phase 2, PERF.md section 6,
# NVIDIA H100 80GB HBM3, 700 W)
K12_BEFORE = {"row21": 115.600}
K13_BEFORE = {"row21": 286.174}
# K15 on csrc/rns_arith.cuh (4 curves a block, one product at a time,
# integer-pipe dots, `%` reductions, the Pa row reloaded every entry)
# before it moved to the tensor cores: ms on the rns job's first replay
# call at row 21 (K=200, B=1024, 65,536 entries; this smoke's phase 2,
# PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W)
K15_BEFORE = {"row21": 1782.060}
# The kernels whose line gives their ms per row (_rows_line): name ->
# (label, geometry function of limbs/rns_kernels, kernel template, ms
# before the redesign)
ROWS_KERNELS = {
    "rns_chain": ("K11", "chain_geometry", "rns_chain_kernel", K11_BEFORE),
    "rns_prefix": ("K12", "prefix_geometry", "rns_prefix_kernel",
                   K12_BEFORE),
    "rns_apply_inverse": ("K13", "apply_inverse_geometry",
                          "rns_apply_inverse_kernel", K13_BEFORE),
}
# The RNS replays, whose line gives their ms per live entry and the bytes
# their row loads move (_rns_replay_line): name -> (label, geometry
# function of limbs/rns_kernels, kernel template, ms before the redesign)
RNS_REPLAY_KERNELS = {
    "rns_replay_gather": ("K14", "gather_geometry",
                          "rns_replay_gather_kernel", K14_BEFORE),
    "rns_replay": ("K15", "replay_geometry", "rns_replay_kernel",
                   K15_BEFORE),
}


def _ops(engine: str):
    """The stage-2 engine adapter of `engine`: its replay_kernels (mode ->
    kernel) and default_replay."""
    from tpu_ecm_torch.stage2 import exec as s2
    return s2.DigitOps if engine == "digit" else s2.RnsOps


def _job_kernels(engine: str) -> tuple:
    """The kernels a Suyama job of `engine` launches in its default replay
    mode."""
    ops = _ops(engine)
    return ((DIGIT_BASE if engine == "digit" else RNS_BASE)
            + (ops.replay_kernels[ops.default_replay],))


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
    from tpu_ecm_torch.native import lib as native
    path = build.build()
    build.library()
    log = open(path[:-3] + ".log").read()
    for line in log.splitlines():
        if re.search(r"Compiling entry|Used \d+ registers|spill", line):
            print("  nvcc:", line.strip())
    host = ("native host library loaded" if native.available()
            else "native host library NOT loaded (pure-Python planners)")
    return (f"{torch.cuda.get_device_name(0)} | {smi_line()} | "
            f"built {os.path.relpath(path, HERE)} | {host}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _make_ctx(n, mersenne=None):
    from tpu_ecm_torch import params
    return params.make_monty(n, mersenne=mersenne)


def _rand_planes(rng, ctx, shape):
    """Random values below 2^(w*k) <= n/2, k whole digits: reduced.  Drawn
    on the card, from a generator seeded by rng."""
    import torch
    p = ctx.p
    k = (p.nbits - 1) // p.w
    gen = torch.Generator(device="cuda").manual_seed(
        int(rng.integers(1 << 62)))
    a = torch.zeros(shape, dtype=torch.int32, device="cuda")
    a[..., :k, :] = torch.randint(0, 1 << p.w, shape[:-2] + (k, shape[-1]),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
    return a


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
    """The plain K5 over blocks of kernels.PLAIN_REPLAY_BLOCK live entries
    (bounds its memory), acc carried across: the block is a multiple of 4,
    so the quadruples and the tail are the whole call's, and the digits the
    kernel's."""
    import numpy as np
    from tpu_ecm_torch.limbs import kernels
    live = idx[1:1 + int(idx[0])]
    step = kernels.PLAIN_REPLAY_BLOCK
    for lo in range(0, live.size, step):
        blk = live[lo:lo + step]
        acc = kernels.replay_plain(
            acc, pa_ext, pbx,
            np.concatenate([np.asarray([blk.size], np.int32), blk]), d)
    return acc


def _sliced_tape(mod, fn, state, tape, const, d, tape_slice):
    """fn(state clone, tape, const, d) (a tape wrapper of mod: kernels or
    rns_kernels) with its per-launch slice set to tape_slice ops."""
    if tape_slice is None:
        return fn(state.clone(), tape, const, d)
    old, mod.TAPE_SLICE = mod.TAPE_SLICE, tape_slice
    try:
        return fn(state.clone(), tape, const, d)
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


def _random_calls(rng, rows: int, pb_rows: int, entries: int,
                  cap=None) -> dict:
    """The gather, parow and (with cap set) resident calls
    (stage2/exec.replay_calls) of entries - 5 random v-sorted entries over
    a Pa group of `rows` rows (row `rows` the one row) and pb_rows Pb rows,
    each in one call: K6's ends in 5 pads (rows, 0), K7's short steps hold
    pb = 0 pads, K8's slabs of cap rows end in (rows, 0) pads."""
    import numpy as np
    from tpu_ecm_torch.stage2 import exec as s2
    idx = np.stack([np.sort(rng.integers(0, rows, entries - 5)),
                    rng.integers(1, pb_rows, entries - 5)], 1).astype(np.int32)
    return {m: next(s2.replay_calls(m, idx, s2.REPLAY_E * entries, rows,
                                    cap))[0]
            for m in ("gather", "parow", "resident")
            if cap or m != "resident"}


def _first_calls(job: dict, sp, g: int, cap=None) -> dict:
    """The index arrays of the main path's first replay call of `job` in
    each mode (resident, with slabs of cap rows, when cap is set): its
    first stage-2 chunk planned as the driver plans it, the entries of its
    first Pa group of g rows as Stage2Runner.run_chunk cuts them, and that
    group's first call (stage2/exec.replay_calls)."""
    import numpy as np
    from tpu_ecm_torch.primes import PrimeStream
    from tpu_ecm_torch.stage2 import exec as s2, plan
    stream = PrimeStream()
    lo, hi = job["b1"], min(job["b1"] + stream.chunk, job["b2"])
    primes = stream.load(lo, hi + 1000 if hi == job["b2"] else hi)
    v, u, amin0, _ = plan.pair(sp, primes, lo, hi)
    ent = s2.entries_global(sp, v, u, amin0)
    idx = ent[ent[:, 0] < g].astype(np.int32)
    return {m: next(s2.replay_calls(m, idx, s2.REPLAY_BLOCK["cuda"], g,
                                    cap))[0]
            for m in s2.REPLAY_MODES if cap or m != "resident"}


def _rows_read(rows_idx, row_bytes: int) -> int:
    """Bytes of the distinct table rows an index array names, each read
    once."""
    import numpy as np
    return int(np.unique(rows_idx).size) * row_bytes


def _slab_rows_read(call, pb_rows: int) -> int:
    """The Pb rows of the distinct slabs a K8 call loads (rows [lo, lo +
    cap) inside the table), each counted once."""
    import numpy as np
    return sum(min(call.cap, pb_rows - int(lo))
               for lo in np.unique(call.slabs[:, 0]))


def main_path_depth(nw: int, rows: int, b: int, job: dict,
                    ed_ops=None, cap=None) -> dict:
    """The stack sizes the main path gives the kernels on the card for
    `job` at B curves of `rows`-row planes (nw digits): the Pa group the
    memory rule picks on this card, the job's whole Pb table, the replay
    kernels' index arrays of its first replay call (calls: mode -> array;
    K8's with slabs of cap rows when cap is set, the digit engine's slab
    on this card); a tape slice of 100 ops splits the 256-op tapes (K1's,
    K9's when ed_ops is set, K10's) over three launches."""
    from tpu_ecm_torch.stage2 import exec as s2, plan
    sp = plan.make_stage2_params(job["b1"], job["b2"], nw=nw, batch=b)
    g = s2.pa_group_for_memory(rows * b * 4, sp.num_pb,
                               s2.device_free_bytes("cuda"))
    return dict(tape_ops=256, tape_slice=100, pb_rows=sp.num_pb, rows=g,
                entries=s2.REPLAY_BLOCK["cuda"], ed_ops=ed_ops, cap=cap,
                calls=_first_calls(job, sp, g, cap))


def _nbytes(*tensors) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tensors)


def _bound(macs: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take for macs
    int32 multiply-adds and nbytes of memory traffic."""
    t_ops, t_mem = macs / IMAD_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def _product_macs(ctx, sqr: bool) -> int:
    """int32 multiply-adds of one digit product of one curve, as
    csrc/arith.cuh forms it: the schoolbook columns (a square's half),
    then REDC (nw quotient digits times nw digits of n, and the quotient
    products) or the fold's three passes of |c|'s digits times the high
    part."""
    nw = ctx.p.nw
    cols = nw * (nw + 1) // 2 if sqr else nw * nw
    if not ctx.is_mersenne:
        return cols + nw * nw + nw
    w = ctx.p.w
    cl = max(1, (abs(ctx.mersenne_c).bit_length() + w - 1) // w)
    hi = 2 * nw - ctx.mersenne_e // w
    return cols + cl * (2 * hi + min(nw, hi))


def _digit_macs(ctx, muls: int, sqrs: int) -> int:
    return (muls * _product_macs(ctx, False)
            + sqrs * _product_macs(ctx, True))


def _tape_products(tape):
    """(products, squares) of a K1 tape: DUP 3M+2S, ADD 4M+2S, NOP none."""
    ops = tape[:, 0]
    dup, add = int((ops == 0).sum()), int((ops == 1).sum())
    return 3 * dup + 4 * add, 2 * (dup + add)


def _ed_products(tape):
    """(products, squares) of a K9 tape: DBL 3M+4S, DBLT 4M+4S, ADD and
    SUB 6M (A, B, C, X3, Y3, Z3), NOP none."""
    ops = tape[:, 0]
    dbl, dblt = int((ops == 0).sum()), int((ops == 1).sum())
    adds = int(((ops == 2) | (ops == 3)).sum())
    return 3 * dbl + 4 * dblt + 6 * adds, 4 * (dbl + dblt)


def _kernel_cases(rng, ctx, b, depth=SHORT, plain_b=None, same=None):
    """(cases, slots): cases maps name -> (kernel call, plain call,
    bound) on one geometry: B curves and the stack sizes of `depth`; K9
    is included when depth["ed_ops"] is set.  The plain calls run on the
    first plain_b curves (None: all B).  bound = (ms,
    "operations" | "bytes") of the kernel call's multiply-adds and bytes.
    slots maps each replay kernel to (live entries, entry slots) of its
    call: the replay kernels read depth["calls"] (the main path's first
    replay call) or, without it, random entries.  A dict `same` gets
    same["replay_resident"]: K6 on K8's call, its entries mapped back to
    pbx rows (pads to the zero row 0), which gives K8's digits."""
    import numpy as np
    import torch
    from tpu_ecm_torch.curve import edops, edwards, ops, prac
    from tpu_ecm_torch.limbs import kernels, layout
    from tpu_ecm_torch.limbs.torch_ops import device_ctx
    from tpu_ecm_torch.primes import primes_range
    d = device_ctx(ctx, "cuda")
    nw = ctx.p.nw
    rows, entries, pb_rows = depth["rows"], depth["entries"], depth["pb_rows"]
    R = lambda *shape: _rand_planes(rng, ctx, shape + (nw, b))
    primes = primes_range(0, FLAGSHIP["b1"])
    tape = prac.stage1_tape(primes, FLAGSHIP["b1"])[:depth["tape_ops"]]
    one = torch.from_numpy(layout.broadcast_int(ctx.r_mod_n, ctx.p.w, nw,
                                                b)).cuda()
    k = dict(pts=R(6, 2), sc=R(), p1=R(2), p2=R(2), pd=R(2), xs=R(rows),
             zs=R(rows), pres=R(rows), one=one, tinv=R(),
             pa_ext=torch.cat([R(rows), one[None]]), pbx=R(pb_rows), acc=R())
    k["pbx"][0] = 0
    calls = depth.get("calls")
    if calls is None:
        calls = dict(_random_calls(rng, rows, pb_rows, entries,
                                   depth["cap"]),
                     stream=_replay_idx(rng, rows, pb_rows, entries))
    idx, pairs, steps = calls["stream"], calls["gather"], calls["parow"]
    res = calls["resident"]
    e = steps.shape[1] - 1
    etape = None
    if depth.get("ed_ops"):
        etape = np.ascontiguousarray(
            edwards.stage1_tape(primes, FLAGSHIP["b1"])[0][:depth["ed_ops"]])
        k.update(eacc=R(4), table=R(1 << (edwards.DEFAULT_W - 2), 3))
    p = k if plain_b is None else {
        name: t[..., :plain_b].contiguous() for name, t in k.items()}
    row = nw * b * 4
    # a product per live entry: a step of k live entries takes k - 1 tree
    # products and one into acc; pads (pb = 0) multiply by one, which the
    # function does not need
    pb_live = steps[:, 1:][steps[:, 1:] > 0]
    slots = {"replay": (int(idx[0]), int(idx[0])),
             "replay_gather": (int((pairs[:, 1] > 0).sum()),
                               pairs.shape[0]),
             "replay_parow": (pb_live.size, steps[:, 1:].size),
             "replay_resident": (int((res.entries[:, 1] > 0).sum()),
                                 res.entries.shape[0])}
    macs = {name: b * live * _digit_macs(ctx, 1, 0)
            for name, (live, _n) in slots.items()}
    cases = {
        "tape": (lambda: _sliced_tape(kernels, kernels.tape, k["pts"], tape,
                                      k["sc"], d, depth["tape_slice"]),
                 lambda: ops.run_tape(p["pts"].clone(), tape, p["sc"], d),
                 _bound(b * _digit_macs(ctx, *_tape_products(tape)),
                        2 * _nbytes(k["pts"]) + _nbytes(k["sc"])
                        + tape.nbytes)),
        "chain": (lambda: kernels.chain(k["p1"], k["p2"], k["pd"], rows, d),
                  lambda: kernels.chain_plain(p["p1"], p["p2"], p["pd"],
                                              rows, d),
                  _bound(b * rows * _digit_macs(ctx, 4, 2),
                         _nbytes(k["p1"], k["p2"], k["pd"]) + 2 * rows * row)),
        "prefix": (lambda: kernels.prefix(k["zs"], k["one"], d),
                   lambda: kernels.prefix_plain(p["zs"], p["one"], d),
                   _bound(b * rows * _digit_macs(ctx, 1, 0),
                          _nbytes(k["zs"], k["one"]) + rows * row)),
        "apply_inverse": (
            lambda: kernels.apply_inverse(k["xs"], k["zs"], k["pres"],
                                          k["tinv"], d),
            lambda: kernels.apply_inverse_plain(p["xs"], p["zs"], p["pres"],
                                                p["tinv"], d),
            _bound(b * rows * _digit_macs(ctx, 3, 0),
                   _nbytes(k["xs"], k["zs"], k["pres"], k["tinv"])
                   + rows * row)),
        "replay": (lambda: kernels.replay(k["acc"], k["pa_ext"], k["pbx"],
                                          idx, d),
                   lambda: _replay_plain(p["acc"], p["pa_ext"], p["pbx"], idx,
                                         d),
                   _bound(macs["replay"],
                          _nbytes(k["acc"], k["pa_ext"], k["pbx"])
                          + idx.nbytes + row)),
        # one difference and one product per live entry; each row named
        # is read once
        "replay_gather": (
            lambda: kernels.replay_gather(k["acc"], k["pa_ext"], k["pbx"],
                                          pairs, d, e=e),
            lambda: kernels.replay_gather_plain(p["acc"], p["pa_ext"],
                                                p["pbx"], pairs, e, d),
            _bound(macs["replay_gather"],
                   _rows_read(pairs[:, 0], row)
                   + _rows_read(pairs[:, 1], row) + pairs.nbytes + 2 * row)),
        # as K6, with one Pa row per step and the one row for pb = 0
        "replay_parow": (
            lambda: kernels.replay_parow(k["acc"], k["pa_ext"], k["pbx"],
                                         steps, k["one"], d),
            lambda: kernels.replay_parow_plain(p["acc"], p["pa_ext"],
                                               p["pbx"], steps, p["one"], d),
            _bound(macs["replay_parow"],
                   _rows_read(steps[:, 0], row)
                   + _rows_read(pb_live, row) + steps.nbytes + 3 * row)),
        # as K6, with the Pb rows of every slab the call loads read once
        "replay_resident": (
            lambda: kernels.replay_resident(k["acc"], k["pa_ext"], k["pbx"],
                                            res.entries, res.slabs, res.cap,
                                            d, e=e),
            lambda: kernels.replay_resident_plain(
                p["acc"], p["pa_ext"], p["pbx"], res.entries, res.slabs,
                res.cap, e, d),
            _bound(macs["replay_resident"],
                   _rows_read(res.entries[:, 0], row)
                   + _slab_rows_read(res, pb_rows) * row
                   + res.entries.nbytes + res.slabs.nbytes + 2 * row)),
    }
    if same is not None:
        on_pbx = np.stack([res.entries[:, 0],
                           kernels.pbx_rows(res.entries, res.slabs, e)], 1)
        same["replay_resident"] = lambda: kernels.replay_gather(
            k["acc"], k["pa_ext"], k["pbx"], on_pbx, d, e=e)
    if etape is not None:
        cases["ed_tape"] = (
            lambda: _sliced_tape(kernels, kernels.ed_tape, k["eacc"], etape,
                                 k["table"], d, depth["tape_slice"]),
            lambda: edops.run_tape(p["eacc"].clone(), etape, p["table"], d),
            _bound(b * _digit_macs(ctx, *_ed_products(etape)),
                   2 * _nbytes(k["eacc"]) + _nbytes(k["table"])
                   + etape.nbytes))
    return cases, slots


def _rand_residues(gen, rc, shape):
    """Random canonical residues [.., rows, B] on the card: every kernel
    takes any canonical residues, consistent across channels or not."""
    import torch
    r = torch.randint(0, 1 << 30, shape, device="cuda", dtype=torch.int32,
                      generator=gen)
    return r.remainder_(rc.p)


def _rns_bound(rc, products: int, nbytes: float):
    """(bound_ms, bound_by, int32-only bound_ms) of `products` RNS
    products (one curve each) and nbytes of memory traffic, whatever runs
    them: the two extension dots (K x (K+1) multiply-adds each) as exact u8
    splits, four int8 products a multiply-add, at the int8 tensor peak;
    the channel work beside them at the int32 rate: the 7K+4 modular
    products of limbs/rns.py:mont_mul (A: x*y, s*c1, beta*|Q|_p; B: x*y,
    s*P^-1, M0*N P^-1, t*qdivinv; r: x*y, s*P^-1, M0*N P^-1, beta's
    *Q^-1), a multiply and a multiply-high reduction each, three
    multiply-adds; the larger of the two against the bytes.  The third
    number is the bound before: every multiply-add of the dots on the
    int32 pipes, and six a channel pair beside them."""
    K = rc.K
    t_dots = products * 2 * K * (K + 1) * 4 * 2 / TENSOR_INT8_OPS_PER_S
    t_chan = products * 3 * (7 * K + 4) / IMAD_PER_S
    t_ops, t_mem = max(t_dots, t_chan), nbytes / HBM_BYTES_PER_S
    old = products * (2 * K * (K + 1) + 6 * K + 3) / IMAD_PER_S
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes",
            max(old, t_mem) * 1e3)


# A short K10 tape (OP_DUP 0, OP_ADD 1, OP_NOP 2; rows op, dst, a, b, c):
# a DUP into a fresh slot and one in place, ADDs into a fresh slot, over
# their difference c and over b, NOPs into another slot and onto
# themselves
RNS_EDGE_TAPE = ((0, 1, 0, 0, 0), (1, 2, 1, 0, 3), (1, 3, 2, 1, 3),
                 (0, 2, 2, 0, 0), (2, 4, 3, 0, 0), (1, 1, 4, 1, 2),
                 (2, 0, 0, 0, 0))


def synthetic_rns(K: int, seed: int, device):
    """An RnsCtx at any even K in [2, rns.K_MAX] with random tables inside
    the kernels' bounds: the channel moduli the primes below 2^13 in turn
    (repeated past the 1027 odd ones), every weight and constant
    canonical for its channel, qinv odd.  make_rns builds K <= 512 in
    steps of 8, so K10's edges (2, 222, 224, 520) take these: the kernels
    and their plain versions compute the same function of any such
    tables."""
    import numpy as np
    from tpu_ecm_torch.limbs import rns
    rng = np.random.default_rng(seed)
    primes = rns._primes_below(1 << 13, 1027)
    chans = [primes[i % len(primes)] for i in range(2 * K)]
    mr = 1 << 14
    pa, pb = chans[:K], chans[K:]
    col = lambda v: np.asarray(v, dtype=np.int64).reshape(-1, 1).astype(
        np.int32)
    below = lambda mods, shape=None: rng.integers(
        0, np.asarray(mods), shape).astype(np.int32)
    tables = dict(
        p=col(pa + pb + [mr]), c1=col(below(pa)),
        w1=below(pb + [mr], (K, K + 1)), n_br=col(below(pb + [mr])),
        pinv_br=col(below(pb + [mr])), npinv_br=col(below(pb + [mr])),
        qdivinv=col(below(pb)), w2=below(pa + [mr], (K, K + 1)),
        qinv_r=col([int(rng.integers(0, mr // 2)) * 2 + 1]),
        qmod_ar=col(below(pa + [mr])), comp_a=col([p * (K + 1) for p in pa]),
        f_sub=col(below(pa + pb + [mr])))
    return rns.make_ctx(tables, K, 14, device)


def _rns_kernel_cases(rng, gen, host, rc, b, depth=RNS_SHORT):
    """(cases, slots) for K10-K15 on one geometry, B curves and the stack
    sizes of `depth`: cases maps name -> (kernel call, plain call, bound),
    slots each replay kernel to (live entries, entry slots, rows loaded),
    as _kernel_cases."""
    import numpy as np
    import torch
    from tpu_ecm_torch.curve import prac
    from tpu_ecm_torch.limbs import rns_exec, rns_kernels
    from tpu_ecm_torch.primes import primes_range
    from tpu_ecm_torch.stage2 import exec as s2
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
    calls = depth.get("calls")
    if calls is None:
        calls = dict(_random_calls(rng, rows, pb_rows, entries),
                     stream=_replay_idx(rng, rows, pb_rows, entries))
    idx, pairs = calls["stream"], calls["gather"]
    e = s2.REPLAY_E
    live = int((pairs[:, 1] > 0).sum())
    stream = idx[1:1 + int(idx[0])].view(np.uint32)
    # each replay's live entries, entry slots and rows loaded: K14 two an
    # entry slot, K15 a Pb row an entry and its Pa row where pa changes
    slots = {"rns_replay": (stream.size, stream.size, stream.size + int(
                 (np.diff(stream >> 16, prepend=-1) != 0).sum())),
             "rns_replay_gather": (live, pairs.shape[0], 2 * pairs.shape[0])}
    acc = R()
    k = rns_kernels
    row = rc.rows * b * 4
    bound = lambda products, nbytes: _rns_bound(rc, b * products, nbytes)
    muls, sqrs = _tape_products(tape)
    return {
        "rns_tape": (
            lambda: _sliced_tape(k, k.tape, pts, tape, sc, rc,
                                 depth["tape_slice"]),
            lambda: rns_exec.run_tape(pts.clone(), tape, sc, rc),
            bound(muls + sqrs, 2 * _nbytes(pts) + _nbytes(sc) + tape.nbytes)),
        "rns_chain": (lambda: k.chain(p1, p2, pd, rows, rc),
                      lambda: k.chain_plain(p1, p2, pd, rows, rc),
                      bound(rows * 6, _nbytes(p1, p2, pd) + 2 * rows * row)),
        "rns_prefix": (lambda: k.prefix(zs, one, rc),
                       lambda: k.prefix_plain(zs, one, rc),
                       bound(rows, _nbytes(zs, one) + rows * row)),
        "rns_apply_inverse": (
            lambda: k.apply_inverse(xs, zs, pres, tinv, rc),
            lambda: k.apply_inverse_plain(xs, zs, pres, tinv, rc),
            bound(rows * 3, _nbytes(xs, zs, pres, tinv) + rows * row)),
        "rns_replay": (lambda: k.replay(acc, pa_ext, pbx, idx, rc),
                       lambda: k.replay_plain(acc, pa_ext, pbx, idx, rc),
                       bound(int(idx[0]), _rows_read(stream >> 16, row)
                             + _rows_read(stream & 0xFFFF, row)
                             + 4 * stream.size + 2 * row)),
        "rns_replay_gather": (
            lambda: k.replay_gather(acc, pa_ext, pbx, pairs, rc, e=e),
            lambda: k.replay_gather_plain(acc, pa_ext, pbx, pairs, e, rc),
            bound(live, _rows_read(pairs[:, 0], row)
                  + _rows_read(pairs[:, 1], row) + pairs.nbytes + 2 * row)),
    }, slots


def _tape_ms_per_op(rng, ctx, tape, b):
    """K1's ms per tape op over `tape` at B curves on random planes (one
    compared launch, then the mean of two timed ones)."""
    from tpu_ecm_torch.limbs import kernels
    from tpu_ecm_torch.limbs.torch_ops import device_ctx
    d = device_ctx(ctx, "cuda")
    pts = _rand_planes(rng, ctx, (6, 2, ctx.p.nw, b))
    sc = _rand_planes(rng, ctx, (ctx.p.nw, b))
    kernels.tape(pts.clone(), tape, sc, d)
    _, ms = _timed(lambda: kernels.tape(pts.clone(), tape, sc, d), 2)
    return ms / tape.shape[0]


def _crossover(rng, gen):
    """K1 and K10 on one 1536-bit modulus at B=1024, the same 256-op tape:
    ns per curve per tape op of each (the digit/RNS crossover datum)."""
    from tpu_ecm_torch.curve import prac
    from tpu_ecm_torch.limbs import rns, rns_kernels
    from tpu_ecm_torch.primes import primes_range
    b, ops = 1024, 256
    ctx = _make_ctx(n1536())
    tape = prac.stage1_tape(primes_range(0, RNS_JOB["b1"]),
                            RNS_JOB["b1"])[:ops]
    ms_d = _tape_ms_per_op(rng, ctx, tape, b) * ops
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


def _fold_datum(rng):
    """K1 in fold mode at M1277 against K1 in REDC mode on a random odd
    1277-bit N, the same 64-op tape at B=2048: ms per tape op of each."""
    from tpu_ecm_torch.curve import prac
    from tpu_ecm_torch.primes import primes_range
    b = 2048
    tape = prac.stage1_tape(primes_range(0, MERSENNE_JOB["b1"]),
                            MERSENNE_JOB["b1"])[:64]
    fold = _make_ctx(M1277, (1277, 1))
    n = random.Random(1277).getrandbits(1277) | 1 | (1 << 1276)
    redc = _make_ctx(n)
    ms_f = _tape_ms_per_op(rng, fold, tape, b)
    ms_r = _tape_ms_per_op(rng, redc, tape, b)
    return (f"1277 bits, B={b}: K1 fold (M1277, nw={fold.p.nw}) "
            f"{ms_f:.4f} ms, K1 REDC (random odd N, nw={redc.p.nw}) "
            f"{ms_r:.4f} ms per tape op")


def _compare(name, label, got, want):
    err = _max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name} at {label}: kernel and plain version "
                             f"differ (max abs err {err})")
    return err


def _record(ms, plain_ms, bound, err, slots=None):
    """The record of one timed kernel, beside the plain version's time and
    the bound; a replay kernel's also holds its call's live entries, its
    entry slots and its ms per live entry, an RNS replay's the rows it
    loads."""
    r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
             bound_by=bound[1], library_ms=None)
    if len(bound) > 2:                  # an RNS kernel: the int32-only bound
        r["bound_int32_ms"] = bound[2]
    if slots is not None:
        r.update(entries=slots[0], slots=slots[1], ms_per_entry=ms / slots[0])
    if slots is not None and len(slots) > 2:
        r["row_loads"] = slots[2]
    return r


@contextlib.contextmanager
def _graphed_products():
    """While active, the products the plain versions form on single CUDA
    planes (torch_ops.mulmod and sqrmod on [NW, B], rns.mont_mul on
    [rows, B]: their sequential chains) replay a CUDA graph captured once
    per function, shapes and context: the same kernels on the same inputs,
    so the same digits, in a few launches per product instead of hundreds
    from the host.  Batched products run as they are."""
    import torch
    from tpu_ecm_torch.limbs import rns, torch_ops
    graphs = {}

    def graphed(fn):
        def call(*args, **kw):
            planes = [a for a in args if isinstance(a, torch.Tensor)]
            if not all(t.is_cuda and t.dim() == 2 for t in planes):
                return fn(*args, **kw)
            others = [a for a in args if not isinstance(a, torch.Tensor)]
            key = (fn, tuple(t.shape for t in planes),
                   tuple(map(id, others)), tuple(sorted(kw.items())))
            if key not in graphs:
                static = [a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args]
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn(*static, **kw)            # warm-up, outside the graph
                torch.cuda.current_stream().wait_stream(side)
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = fn(*static, **kw)
                graphs[key] = ([a for a in static
                                if isinstance(a, torch.Tensor)], out, g,
                               others)
            static, out, g, _others = graphs[key]
            for dst, src in zip(static, planes):
                dst.copy_(src)
            g.replay()
            return out.clone()
        return call

    swapped = [(torch_ops, "mulmod"), (torch_ops, "sqrmod"),
               (rns, "mont_mul")]
    saved = [getattr(mod, name) for mod, name in swapped]
    for mod, name in swapped:
        setattr(mod, name, graphed(getattr(mod, name)))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swapped, saved):
            setattr(mod, name, fn)
        graphs.clear()


def _ptxas_lines(kernel: str) -> list:
    """What nvcc -Xptxas -v reported for one kernel (its stack frame,
    spills, registers and static shared memory), from the build log."""
    from tpu_ecm_torch.limbs import build
    with open(build.library_path()[:-3] + ".log") as f:
        log = f.read().splitlines()
    out, inside = [], False
    for line in log:
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and re.search(r"stack frame|Used \d+ registers", line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def _lanes_ptxas(kernel: str) -> dict:
    """What nvcc -Xptxas -v reported for each instantiation of a kernel
    template (its int template argument, or the tuple of them where it
    has several, e.g. digits a lane of a lane-core kernel, (T, H) of K14
    -> registers, stack frame and spill bytes), from the build log."""
    from tpu_ecm_torch.limbs import build
    with open(build.library_path()[:-3] + ".log") as f:
        log = f.read().splitlines()
    out, digits = {}, None
    for line in log:
        hit = re.search(
            rf"Compiling entry function '_Z\d+{kernel}I((?:Li\d+E)+)E", line)
        if hit:
            args = tuple(map(int, re.findall(r"Li(\d+)E", hit.group(1))))
            digits = args[0] if len(args) == 1 else args
            out[digits] = {}
            continue
        if "Compiling entry function" in line:
            digits = None
        if digits is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame:
            out[digits].update(stack_bytes=int(frame.group(1)),
                               spill_store_bytes=int(frame.group(2)),
                               spill_load_bytes=int(frame.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[digits]["registers"] = int(regs.group(1))
    return out


def _lanes_line(name, label, r, nw, b, rows) -> str:
    """A lane-core kernel's (K1-K9's) geometry at nw digits and B curves
    (lanes a curve, curves a block, blocks, resident warps per SM the card
    allows, K8's at its slab of r["cap"] rows, and warps per SM the launch
    gives), its instantiation's ptxas report and its share of the bound,
    added to its record r; K5's-K8's lines also give their ms per live
    entry, and K2's, K3's and K4's (on `rows` rows) and K9's their ms,
    beside the one-thread kernel's; K8's its slabs, slab height, shared
    memory a block and K6's ms per live entry on its entries."""
    import ctypes
    import torch
    from tpu_ecm_torch.limbs import build, kernels
    k, kernel, occupancy = LANE_KERNELS[name]
    lanes, digits, per_block, blocks = kernels.tape_geometry(nw, b)
    per_sm = ctypes.c_int()
    slab = (r["cap"],) if name == "replay_resident" else ()
    if getattr(build.library(), occupancy)(lanes, digits, *slab,
                                           ctypes.byref(per_sm)) != 0:
        raise RuntimeError(f"{k}: occupancy query refused")
    warps = kernels.TAPE_BLOCK // 32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r.update(geometry=dict(
        lanes=lanes, digits=digits, curves_per_block=per_block,
        blocks=blocks, resident_warps_per_sm=per_sm.value * warps,
        launch_warps_per_sm=blocks * warps / sms),
        ptxas=_lanes_ptxas(kernel)[digits],
        share_of_bound=r["bound_ms"] / r["ms"])
    g, x = r["geometry"], r["ptxas"]
    line = (f"{k} at {label} (nw={nw}, B={b}): {g['lanes']} lanes a curve, "
            f"{g['digits']} digits a lane, {g['curves_per_block']} curves a "
            f"block, {g['blocks']} blocks, {g['resident_warps_per_sm']} "
            f"resident warps per SM allowed, {g['launch_warps_per_sm']:.2f} "
            f"launched per SM; ptxas: {x.get('registers')} registers, "
            f"{x.get('stack_bytes')} bytes stack frame, "
            f"{x.get('spill_store_bytes')}/{x.get('spill_load_bytes')} "
            f"bytes spill stores/loads; {r['ms']:.3f} ms against the bound "
            f"{r['bound_ms']:.4f}: {100 * r['share_of_bound']:.2f}% of it")
    if name in ("replay", "replay_gather", "replay_parow",
                "replay_resident"):
        old_ms, old_per = {"replay": K5_ONE_THREAD,
                           "replay_gather": K6_ONE_THREAD,
                           "replay_parow": K7_ONE_THREAD,
                           "replay_resident": K8_ONE_THREAD}[name][label]
        line += (f"; {r['entries']} live entries, {r['ms_per_entry']:.6f} ms "
                 f"per live entry (the one-thread kernel: {old_per:.5f} on "
                 f"the same call, {old_ms:.3f} ms; {old_ms / r['ms']:.2f}x)")
    if name == "replay_resident":
        line += (f"; {r['slots']} slots in {r['slabs']} slabs of "
                 f"{r['cap']} rows, {r['smem_bytes']} bytes of shared "
                 f"memory a block; lane-core K6 on the same entries "
                 f"{r['k6_ms_per_entry_same']:.6f} ms per live entry")
    if name == "ed_tape":
        old_ms = K9_ONE_THREAD[label]
        line += (f"; the one-thread kernel: {old_ms:.3f} ms on a 256-op "
                 f"tape ({old_ms / r['ms']:.2f}x)")
    if name in ("chain", "prefix", "apply_inverse"):
        old_ms = {"chain": K2_ONE_THREAD, "prefix": K3_ONE_THREAD,
                  "apply_inverse": K4_ONE_THREAD}[name][label]
        line += (f"; {rows} rows, the one-thread kernel: {old_ms:.3f} ms "
                 f"per 4,096-row group "
                 f"({old_ms * rows / 4096 / r['ms']:.2f}x per row)")
    return line


def _k10_line(label, r, K, b) -> str:
    """K10's geometry at K and B curves (curves a block, threads, blocks,
    shared memory a block, whether the weights are resident in it), its
    instantiation's ptxas report and its share of the bound, added to its
    record r, and its ms beside K10_BEFORE's."""
    from tpu_ecm_torch.limbs import rns_kernels
    g = rns_kernels.tape_geometry(K, b)
    r.update(geometry=g._asdict(),
             ptxas=_lanes_ptxas("rns_tape_kernel")[g.tile],
             share_of_bound=r["bound_ms"] / r["ms"])
    x, old = r["ptxas"], K10_BEFORE[label]
    return (f"K10 at {label} (K={K}, B={b}): T={g.tile} curves a block, "
            f"{g.threads} threads, {g.blocks} blocks, {g.smem} bytes of "
            f"shared memory a block, weights "
            f"{'resident in it' if g.resident else 'from the global table'}"
            f"; ptxas: {x.get('registers')} registers, "
            f"{x.get('stack_bytes')} bytes stack frame, "
            f"{x.get('spill_store_bytes')}/{x.get('spill_load_bytes')} "
            f"bytes spill stores/loads; {r['ms']:.3f} ms against the bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}): "
            f"{100 * r['share_of_bound']:.2f}% of it (of the int32-only "
            f"bound {r['bound_int32_ms']:.4f}: "
            f"{100 * r['bound_int32_ms'] / r['ms']:.2f}%); before: "
            f"{old:.3f} ms ({old / r['ms']:.2f}x)")


def _rows_line(name, label, r, K, b, rows) -> str:
    """K11's, K12's or K13's geometry at K and B curves (curves a block,
    products a pass, threads, blocks, shared memory a block, whether the
    weights are resident in it), its instantiation's ptxas report and its
    share of the bound on `rows` rows, added to its record r, and its ms
    beside the ms before its redesign (ROWS_KERNELS)."""
    from tpu_ecm_torch.limbs import rns_kernels
    k, geometry, kernel, before = ROWS_KERNELS[name]
    g = getattr(rns_kernels, geometry)(K, b)
    ptxas = _lanes_ptxas(kernel)
    r.update(geometry=g._asdict(),
             ptxas=ptxas.get((g.tile, g.halves), ptxas.get(g.tile)),
             share_of_bound=r["bound_ms"] / r["ms"])
    x, old = r["ptxas"], before[label]
    return (f"{k} at {label} (K={K}, B={b}): T={g.tile} curves a block, "
            f"{g.halves} products a pass, {g.threads} threads, {g.blocks} "
            f"blocks, {g.smem} bytes of shared memory a block, weights "
            f"{'resident in it' if g.resident else 'from the global table'}"
            f"; ptxas: {x.get('registers')} registers, "
            f"{x.get('stack_bytes')} bytes stack frame, "
            f"{x.get('spill_store_bytes')}/{x.get('spill_load_bytes')} "
            f"bytes spill stores/loads; {rows} rows, {r['ms']:.3f} ms "
            f"({1e3 * r['ms'] / rows:.3f} us a row) against the bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}): "
            f"{100 * r['share_of_bound']:.2f}% of it; before: {old:.3f} ms "
            f"({old / r['ms']:.2f}x)")


def _rns_replay_line(name, label, r, K, b) -> str:
    """K14's or K15's geometry at K and B curves (curves a block, products
    a pass, threads, blocks, shared memory a block, whether the weights
    are resident in it), its instantiation's ptxas report, its share of
    the bound and the bytes its row loads move (r["row_loads"] rows of
    (2K+1)*4 bytes a curve: K14 two an entry slot, K15 a Pb row an entry
    and a Pa row where pa changes), added to its record r, and its ms
    beside the ms before its redesign (RNS_REPLAY_KERNELS)."""
    from tpu_ecm_torch.limbs import rns_kernels
    k, geometry, kernel, before = RNS_REPLAY_KERNELS[name]
    g = getattr(rns_kernels, geometry)(K, b)
    halves = getattr(g, "halves", 1)
    ptxas = _lanes_ptxas(kernel)
    gathered = r["row_loads"] * (2 * K + 1) * b * 4
    r.update(geometry=g._asdict(),
             ptxas=ptxas.get((g.tile, halves), ptxas.get(g.tile)),
             share_of_bound=r["bound_ms"] / r["ms"],
             gathered_bytes=gathered,
             gathered_gb_per_s=gathered / r["ms"] / 1e6)
    x, old = r["ptxas"], before[label]
    return (f"{k} at {label} (K={K}, B={b}): T={g.tile} curves a block, "
            f"{halves} products a pass, {g.threads} threads, {g.blocks} "
            f"blocks, {g.smem} bytes of shared memory a block, weights "
            f"{'resident in it' if g.resident else 'from the global table'}"
            f"; ptxas: {x.get('registers')} registers, "
            f"{x.get('stack_bytes')} bytes stack frame, "
            f"{x.get('spill_store_bytes')}/{x.get('spill_load_bytes')} "
            f"bytes spill stores/loads; {r['entries']} live entries in "
            f"{r['slots']} slots, {r['ms']:.3f} ms "
            f"({r['ms_per_entry']:.6f} per live entry) against the bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}): "
            f"{100 * r['share_of_bound']:.2f}% of it; row loads move "
            f"{gathered / 1e9:.1f} GB, {r['gathered_gb_per_s']:.0f} GB/s; "
            f"before: {old:.3f} ms ({old / r['ms']:.2f}x)")


def phase_kernels(record):
    """Fills record[name] with the main-path timing of every kernel (and
    record[name]["fold"] with K1-K9's at M1277, the mersenne job's
    depths)."""
    import numpy as np
    import torch
    from tpu_ecm_torch.limbs import kernels
    rng = np.random.default_rng(20261016)
    worst = {}
    for label, n, mers, b in (("N64", N64, None, 128),
                              ("flagship", N416, None, 2048),
                              ("M127", M127, (127, 1), 128),
                              ("M1277", M1277, (1277, 1), 2048)):
        ctx = _make_ctx(n, mers)
        nw = ctx.p.nw
        smem = kernels.resident_smem(nw, "cuda")
        cap = kernels.resident_slab_rows(nw, b, "cuda")
        depth, plain_b = {
            "flagship": (main_path_depth(nw, nw, b, FLAGSHIP, ed_ops=256,
                                         cap=cap), None),
            "M1277": (main_path_depth(nw, nw, b, MERSENNE_JOB, ed_ops=256,
                                      cap=cap), PLAIN_CURVES),
        }.get(label, (SHORT, None))
        same = {}
        cases, slots = _kernel_cases(rng, ctx, b, depth, plain_b, same)
        shown = {k: v for k, v in depth.items() if k != "calls"}
        for name, (kern, plain, bound) in cases.items():
            # at M1277 the compared launch is the timed one: each runs for
            # seconds at these depths (the smoke's time limit)
            got, ms = _timed(kern, 1)
            if name in same and label in ("flagship", "M1277"):
                # K6 on the same entries: the same digits, and its time
                k6, k6_ms = _timed(same[name], 1)
                _compare("replay_gather on K8's entries", label, got, k6)
                same[name] = k6_ms / slots[name][0]
                del k6
            with _graphed_products():
                want, plain_ms = _timed(plain, 1)
            if plain_b is not None:
                got = got[..., :plain_b]
            err = _compare(name, label, got, want)
            worst[name] = max(worst.get(name, 0), err)
            del got, want
            if label == "flagship":
                # the mean of two launches after the compared one
                record[name] = _record(_timed(kern, 2)[1], plain_ms, bound,
                                       worst[name], slots.get(name))
            elif label == "M1277":
                record[name]["fold"] = dict(
                    _record(ms, plain_ms, bound, err, slots.get(name)),
                    plain_curves=plain_b, depth=shown)
        if label in ("flagship", "M1277"):
            call = depth["calls"]["resident"]
            r8 = record["replay_resident"]
            r8 = r8 if label == "flagship" else r8["fold"]
            r8.update(cap=call.cap,
                      slabs=int(np.unique(call.slabs[:, 0]).size),
                      smem_bytes=smem.static + smem.block_bytes(call.cap),
                      k6_ms_per_entry_same=same["replay_resident"])
            for name in LANE_KERNELS:
                r = record[name] if label == "flagship" else \
                    record[name]["fold"]
                print("  " + _lanes_line(name, label, r, nw, b,
                                         depth["rows"]), flush=True)
        del cases
        torch.cuda.empty_cache()
    from tpu_ecm_torch.limbs import rns
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    for label, n, b in (("N256", N256, 128), ("row21", row21_n(), 1024)):
        ctx = _make_ctx(n)
        host = rns.make_rns(ctx, cw=rns.choose_cw(ctx.p.nbits))
        rc = rns.device_ctx(host, "cuda")
        depth = (main_path_depth(ctx.p.nw, rc.rows, b, RNS_JOB)
                 if label == "row21" else RNS_SHORT)
        cases, slots = _rns_kernel_cases(rng, gen, host, rc, b, depth)
        shown = {k: v for k, v in depth.items() if k != "calls"}
        for name, (kern, plain, bound) in cases.items():
            got = kern()
            with _graphed_products():
                want, plain_ms = _timed(plain, 1)
            err = _compare(name, label, got, want)
            worst[name] = max(worst.get(name, 0), err)
            del got, want
            if label == "row21":
                record[name] = _record(_timed(kern, 2)[1], plain_ms, bound,
                                       worst[name], slots.get(name))
        del cases
        torch.cuda.empty_cache()
    print("  " + _k10_line("row21", record["rns_tape"], rc.K, 1024),
          flush=True)
    for name in ROWS_KERNELS:
        print("  " + _rows_line(name, "row21", record[name], rc.K, 1024,
                                depth["rows"]), flush=True)
    for name in RNS_REPLAY_KERNELS:
        print("  " + _rns_replay_line(name, "row21", record[name], rc.K,
                                      1024), flush=True)
    print(f"  rns depths at row 21 (K={rc.K}, B=1024): {shown}", flush=True)
    print(f"  fold depths at M1277 (B=2048): {record['tape']['fold']['depth']}"
          f"; plain versions on the first {PLAIN_CURVES} curves", flush=True)
    per = lambda r: (f", {r['entries']} live entries in {r['slots']} slots, "
                     f"{r['ms_per_entry']:.5f} ms per live entry"
                     if "entries" in r else "")
    for name, r in record.items():
        fold = r.get("fold")
        print(f"  {name}: {r['ms']:.3f} ms (plain {r['plain_ms']:.1f}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']}{per(r)})"
              + (f"; fold at M1277: {fold['ms']:.3f} ms (plain on "
                 f"{fold['plain_curves']} curves {fold['plain_ms']:.1f}, "
                 f"bound {fold['bound_ms']:.4f} by {fold['bound_by']}"
                 f"{per(fold)})" if fold else ""), flush=True)
    cross = _crossover(rng, gen)
    fold = _fold_datum(rng)
    torch.cuda.empty_cache()
    return ("K1-K9 equal their plain versions at N64/B=128 (short "
            "stacks), 416-bit/B=2048 (main-path depths) and, in fold mode, "
            "M127/B=128 and M1277/B=2048 (the mersenne job's depths, "
            f"plain on {PLAIN_CURVES} curves); K10-K15 "
            "at N256/B=128 (short stacks) and row 21/B=1024 (main-path "
            "depths); " + cross + "; " + fold)


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


def acceptance_row(num: int) -> tuple:
    """Row `num` of test.csh (tpu_ecm_torch/acceptance.py)."""
    from tpu_ecm_torch import acceptance
    return next(r for r in acceptance.REFSWEEP_ROWS if r[0] == num)


def row21_n() -> int:
    """N of row 21 of test.csh (2397 bits)."""
    from tpu_ecm_torch.io import calc
    return calc.calc(acceptance_row(21)[1])


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


def _driver(tmp, **kw):
    """A driver on the card writing its files under tmp (quiet unless
    kw sets verbose)."""
    from tpu_ecm_torch import driver
    os.makedirs(tmp, exist_ok=True)
    kw.setdefault("verbose", 0)
    return driver.ECMDriver(driver.RunConfig(
        save_b1_path=os.path.join(tmp, "save_b1.txt"),
        checkpoint_path=os.path.join(tmp, "checkpoint.txt"),
        results_path=os.path.join(tmp, "ecm_results.txt"),
        device="cuda", **kw))


def _run(tmp, **kw):
    return _driver(tmp, **kw).run()


def _job_line(j, bits, res, wall, counts) -> str:
    t = res.timings
    return (f"{j['curves']} curves x {bits} bits, B1={j['b1']}, "
            f"B2={j['b2']}: stage1 {t['stage1']:.2f} s, stage2_init "
            f"{t['stage2_init']:.2f} s, stage2 {t['stage2']:.2f} s, "
            f"wall {wall:.2f} s, {j['curves'] / wall:.2f} curves/s; "
            f"launches {counts}; factors {len(res.factors)}")


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
    kernels.reset_launches()
    res = _run(os.path.join(tmp, "o6"), n=M101, curves=12, b1=10_000,
               b2=1_000_000, sigma=500, stop_on_factor=False)
    hits = {(h.sigma, h.stage) for h in res.factors if h.factor == M101_P13}
    if not {(511, 1), (502, 2)} <= hits or res.work_modulus != M101:
        raise AssertionError(f"M101 pinned finds missing: {sorted(hits)}")
    if not all(kernels.launches[k] for k in _job_kernels("digit")):
        raise AssertionError(f"M101 skipped a digit kernel: "
                             f"{kernels.launches}")
    ed = {}
    for tag, sigma, b2, stage, want_sigma in (("o7", 44, 300, 1, 46),
                                              ("o8", 28, 10000, 2, 29)):
        res = _run(os.path.join(tmp, tag), n=N71, curves=4, b1=300, b2=b2,
                   sigma=sigma, curve_mode="edwards")
        hit = [h for h in res.factors if h.factor == P35]
        if not hit or (hit[0].stage, hit[0].sigma) != (stage, want_sigma):
            raise AssertionError(f"Edwards N71 stage-{stage} find missing: "
                                 f"{res.factors}")
        ed[stage] = want_sigma
    if not kernels.launches["ed_tape"]:
        raise AssertionError("the Edwards runs did not launch K9")
    # the same finds through the gather, parow and resident replays (K6,
    # K7, K8, K14)
    for tag, n, engine, mode in (("o9", N71, "digit", "gather"),
                                 ("o10", N71, "digit", "parow"),
                                 ("o11", N71, "rns", "gather"),
                                 ("o12", n2355(), "auto", "gather"),
                                 ("o15", N71, "digit", "resident")):
        kernels.reset_launches()
        res = _run(os.path.join(tmp, tag), n=n, curves=4, b1=300, b2=10000,
                   sigma=110, engine=engine, replay=mode,
                   stop_on_factor=False)
        own = _ops("digit" if engine == "digit" else "rns"
                   ).replay_kernels[mode]
        if not any(h.factor % P35 == 0 and (h.stage, h.sigma) == (2, 112)
                   for h in res.factors) or not kernels.launches[own]:
            raise AssertionError(f"{n.bit_length()} bits, {engine} {mode}: "
                                 f"sigma-112 find or {own} launch missing: "
                                 f"{res.factors}, {kernels.launches}")
    for tag, mode in (("o13", "gather"), ("o14", "parow"),
                      ("o16", "resident")):
        kernels.reset_launches()
        res = _run(os.path.join(tmp, tag), n=M101, curves=12, b1=10_000,
                   b2=1_000_000, sigma=500, stop_on_factor=False,
                   replay=mode)
        own = _ops("digit").replay_kernels[mode]
        if ((M101_P13, 2, 502) not in {(h.factor, h.stage, h.sigma)
                                       for h in res.factors}
                or not kernels.launches[own]):
            raise AssertionError(f"M101 {mode}: sigma-502 stage-2 find or "
                                 f"{own} launch missing: {res.factors}")
    return (f"(P35, 2, 112) found; golden sweep {len(got)}/{len(want)} "
            "equal; RNS: N71 (P35, 2, 112) found, N256 stage-1 residues "
            "equal to the digit engine's, 2355 bits routed to RNS and P35 "
            "found in stage 2 at sigma 112; M101 (fold): P13 at sigma 511 "
            "in stage 1 and sigma 502 in stage 2; Edwards N71: P35 at sigma "
            f"{ed[1]} in stage 1 and sigma {ed[2]} in stage 2; replay "
            "gather, parow and resident: N71 (P35, 2, 112) on both engines "
            "(digit only for parow and resident), 2355 bits (gather) and "
            "M101 (P13, 2, 502)")


def phase_flagship(tmp, record):
    from tpu_ecm_torch.limbs import kernels
    f = FLAGSHIP
    kernels.reset_launches()
    t0 = time.time()
    res = _run(tmp, n=N416, curves=f["curves"], b1=f["b1"], b2=f["b2"],
               sigma=f["sigma"], stop_on_factor=False)
    wall = time.time() - t0
    counts = _launches(record, "flagship", _job_kernels("digit"))
    missing = [k for k, c in counts.items() if c == 0]
    if missing or kernels.launches["ed_tape"]:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}, or K9 launched: "
                             f"{kernels.launches['ed_tape']}")
    _check_save(os.path.join(tmp, "save_b1.txt"), N416, f)
    if res.curves_run != f["curves"]:
        raise AssertionError(f"ran {res.curves_run} curves")
    return _job_line(f, 416, res, wall, counts)


def _launches(record, job: str, names) -> dict:
    """The launch counts of `names` in the job just run, kept in
    record[name]["launches_by_job"][job]; the flagship's (and for K9 the
    edwards job's) are the JSON line's "launches"."""
    from tpu_ecm_torch.limbs import kernels
    counts = {k: kernels.launches[k] for k in names}
    for name, c in counts.items():
        record[name].setdefault("launches_by_job", {})[job] = c
    return counts


def _check_save(path, n, job, program="AVX-ECM"):
    """save_b1.txt holds one canonical record per curve of the job, with N
    the input and the program tag of its curve family."""
    from tpu_ecm_torch.io import savefile
    with open(path) as fh:
        recs = list(savefile.parse_records(fh))
    sigmas = {r.sigma for r in recs}
    if (len(recs) != job["curves"]
            or any(r.n != n or r.b1 != job["b1"] or not 0 <= r.x < n
                   or not 0 < r.z < n or r.program != program for r in recs)
            or sigmas != set(range(job["sigma"],
                                   job["sigma"] + job["curves"]))):
        raise AssertionError(f"{path} does not hold one canonical "
                             f"{program} record per curve")
    return recs


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
    counts = _launches(record, "rns", _job_kernels("rns"))
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"RNS kernels never launched: {missing}")
    digit = {k: c for k, c in kernels.launches.items()
             if c and not k.startswith("rns_")}
    if digit:
        raise AssertionError(f"digit kernels launched in the rns job: "
                             f"{digit}")
    _check_save(os.path.join(tmp, "save_b1.txt"), n, j)
    if res.curves_run != j["curves"]:
        raise AssertionError(f"ran {res.curves_run} curves")
    return _job_line(j, n.bit_length(), res, wall, counts)


def _suyama_oracle(ctx, residues, b1: int) -> None:
    """Each (sigma, X, Z) of a driver's stage-1 residues equals the exact
    integer replay of its curve (curve/oracle.py over per-prime PRAC tapes,
    as tests/test_e2e.py:227-254 does)."""
    from tpu_ecm_torch.curve import oracle, prac, suyama
    from tpu_ecm_torch.primes import primes_range
    dom = oracle.IntDomain(ctx)
    for sigma, gx, gz in residues:
        ci = suyama.build_one_curve(ctx, sigma)
        X, Z, s = ci.x_mont, ci.z_mont, ci.s_mont
        for _ in range(prac.stage1_powers_of_two(b1)):
            X, Z = oracle.xdbl_int(dom, X, Z, s)
        for q in primes_range(3, b1).tolist():
            k = 1
            while True:
                tape = []
                prac.prac_tape(int(q), tape)
                X, Z = oracle.run_tape_int(ctx, tape, X, Z, s)[0]
                k *= q
                if k * q >= b1:
                    break
        if (gx, gz) != (ctx.from_mont_int(X), ctx.from_mont_int(Z)):
            raise AssertionError(f"sigma {sigma}: stage-1 residue differs "
                                 "from the integer oracle")


def _edwards_oracle(ctx, recs, b1: int) -> None:
    """Each AVX-ECM-ED record's (U : W) equals (Z+Y : Z-Y) of
    edwards.oracle_scalar_mul's [s]P for its sigma, projectively."""
    from tpu_ecm_torch.curve import edwards
    from tpu_ecm_torch.primes import primes_range
    n = ctx.n_int
    s = edwards.stage1_scalar(primes_range(0, b1), b1)
    for r in recs:
        c = edwards.build_one_curve(ctx, r.sigma)
        u, w = edwards.to_montgomery_xz(
            edwards.oracle_scalar_mul(s, c.x0, c.y0, c.d, n), n)
        if r.x * w % n != r.z * u % n:
            raise AssertionError(f"sigma {r.sigma}: Edwards stage-1 point "
                                 "differs from the integer oracle")


def phase_mersenne(tmp, record):
    """M1277 through the driver at full width, reduced by the fold."""
    from tpu_ecm_torch.limbs import kernels
    j = MERSENNE_JOB
    kernels.reset_launches()
    t0 = time.time()
    d = _driver(tmp, n=M1277, curves=j["curves"], b1=j["b1"], b2=j["b2"],
                sigma=j["sigma"], stop_on_factor=False)
    if not (d.ctx.is_mersenne and d.engine == "digit"):
        raise AssertionError("M1277 did not take the fold on the digit "
                             "engine")
    res = d.run()
    wall = time.time() - t0
    counts = _launches(record, "mersenne", _job_kernels("digit"))
    if not all(counts.values()) or kernels.launches["ed_tape"]:
        raise AssertionError(f"mersenne job launches: {kernels.launches}")
    _check_save(os.path.join(tmp, "save_b1.txt"), M1277, j)
    t1 = time.time()
    _suyama_oracle(d.ctx, res.stage1_residues[:4], j["b1"])
    return (_job_line(j, 1277, res, wall, counts)
            + f"; w={d.ctx.p.w}, nw={d.ctx.p.nw}; the first 4 stage-1 "
            f"residues equal the integer oracle ({time.time() - t1:.2f} s)")


def phase_edwards(tmp, record):
    """The flagship job with Edwards curves: K9 for stage 1, K2-K5 for
    the Montgomery stage 2."""
    from tpu_ecm_torch.limbs import kernels
    j = FLAGSHIP
    kernels.reset_launches()
    t0 = time.time()
    d = _driver(tmp, n=N416, curves=j["curves"], b1=j["b1"], b2=j["b2"],
                sigma=j["sigma"], curve_mode="edwards", stop_on_factor=False)
    # stage 2 runs its point ladders through K1: stage 1 must not
    stage2, k1_stage1 = d._run_stage2, []

    def run_stage2(*args, **kw):
        k1_stage1.append(kernels.launches["tape"])
        return stage2(*args, **kw)

    d._run_stage2 = run_stage2
    res = d.run()
    wall = time.time() - t0
    counts = _launches(record, "edwards",
                       ("ed_tape",) + _job_kernels("digit"))
    if (k1_stage1 != [0] or kernels.launches["rns_tape"]
            or not all(c for k, c in counts.items() if k != "tape")):
        raise AssertionError(f"edwards job launches: {kernels.launches}, "
                             f"K1 in stage 1: {k1_stage1}")
    recs = _check_save(os.path.join(tmp, "save_b1.txt"), N416, j,
                       program="AVX-ECM-ED")
    t1 = time.time()
    _edwards_oracle(d.ctx, recs[:4], j["b1"])
    return (_job_line(j, 416, res, wall, counts)
            + f" (K1: stage 2's ladders only); ed_normalize "
            f"{res.timings.get('ed_normalize', 0.0):.2f} s; the first 4 "
            f"stage-1 points equal the integer oracle "
            f"({time.time() - t1:.2f} s)")


def replay_n() -> int:
    """Phase 8's 416-bit N: _prp(random.Random(REPLAY_SEED), 66), a
    20-digit prime, times the next 350-bit prp of the same stream."""
    rng = random.Random(REPLAY_SEED)
    n = _prp(rng, 66) * _prp(rng, 350)
    if n.bit_length() != 416:
        raise AssertionError(f"replay N has {n.bit_length()} bits")
    return n


def phase_replay(tmp, record, runs):
    """The replay modes at full width (stop_on_factor=False): each run
    launches its mode's kernel and no other replay kernel, and the modes'
    (factor, stage, sigma) sets, with at least one stage-2 find, and their
    paired, ptadds and numinv counters are identical.  Each run's finds,
    counters, stage-1 residues and a copy of its save_b1.txt go into
    runs[(engine, mode)] for phase 9."""
    from tpu_ecm_torch.limbs import kernels
    lines = []
    for engine, n, j, modes in (
            ("digit", replay_n(), REPLAY_JOB,
             ("stream", "gather", "parow", "resident")),
            ("rns", n2355(), RNS_REPLAY_JOB, ("stream", "gather"))):
        names = list(_ops(engine).replay_kernels.values())
        seen = {}
        for mode in modes:
            kernels.reset_launches()
            t0 = time.time()
            d = _driver(os.path.join(tmp, f"{engine}_{mode}"), n=n,
                        curves=j["curves"], b1=j["b1"], b2=j["b2"],
                        sigma=j["sigma"], engine=engine, replay=mode,
                        stop_on_factor=False)
            res = d.run()
            wall = time.time() - t0
            t = res.timings
            counts = _launches(record, f"replay_{engine}_{mode}", names)
            own = _ops(engine).replay_kernels[mode]
            if not counts[own] or any(c for k, c in counts.items()
                                      if k != own):
                raise AssertionError(f"{engine} {mode}: replay launches "
                                     f"{counts}")
            seen[mode] = ({(h.factor, h.stage, h.sigma)
                           for h in res.factors},
                          tuple(res.counters[k]
                                for k in ("paired", "ptadds", "numinv")))
            save = os.path.join(tmp, f"save_b1_{engine}_{mode}.txt")
            shutil.copy(os.path.join(tmp, f"{engine}_{mode}", "save_b1.txt"),
                        save)
            runs[(engine, mode)] = dict(
                n=n, job=j, finds=seen[mode][0], counters=res.counters,
                residues=res.stage1_residues, save=save, wall=wall,
                timings=t)
            lines.append(
                f"{engine} {mode}: {j['curves'] / wall:.2f} curves/s, "
                f"stage1 {t['stage1']:.2f} s, stage2_init "
                f"{t['stage2_init']:.2f} s, stage2 {t['stage2']:.2f} s, "
                f"{res.counters['paired']} entries in {d.replay_slots} "
                f"slots, {counts[own]} launches of {own}")
            print("  " + lines[-1], flush=True)
        ref = seen[modes[0]]
        if any(v != ref for v in seen.values()):
            raise AssertionError(f"{engine}: the replay modes differ: "
                                 f"{seen}")
        if not any(stage == 2 for _f, stage, _s in ref[0]):
            raise AssertionError(f"{engine}: no stage-2 find: {ref[0]}")
        lines.append(f"{engine} ({n.bit_length()} bits, {j['curves']} "
                     f"curves, B1={j['b1']}, B2={j['b2']}): {len(ref[0])} "
                     f"finds ({sum(st == 2 for _f, st, _s in ref[0])} in "
                     f"stage 2), identical in {', '.join(modes)}")
    return "; ".join(lines)


def _finds_line(hits) -> str:
    return (f"{len(hits)} finds ({sum(st == 2 for _f, st, _s in hits)} in "
            f"stage 2)")


def phase_surface(tmp, record, runs):
    """The rest of the single-process surface at phase 8's full width:
    noinv (cross="noinv") on phase 8's digit job, whose finds must be a
    subset of the stream run's with a stage-2 find, no inversion, K1 and
    K2 launched and K3-K8 not; resume_stage2 of phase 8's digit and RNS
    stream save_b1.txt to their B2, with the stream runs' finds and paired
    counts, the engine's stage-2 kernels launched and (RNS) no digit
    kernel; and stage 1 of the digit job with full_prac=True, whose
    residues must equal the reduced rule set's as points (X1*Z2 = X2*Z1
    mod n: another chain, the same point) with K1 launched."""
    from tpu_ecm_torch import driver
    from tpu_ecm_torch.limbs import kernels
    lines = []
    ref = runs[("digit", "stream")]
    n, j = ref["n"], ref["job"]

    kernels.reset_launches()
    t0 = time.time()
    res = _run(os.path.join(tmp, "noinv"), n=n, curves=j["curves"],
               b1=j["b1"], b2=j["b2"], sigma=j["sigma"], engine="digit",
               cross="noinv", stop_on_factor=False)
    wall = time.time() - t0
    counts = _launches(record, "surface_noinv", (
        "tape", "chain", "prefix", "apply_inverse", "replay",
        "replay_gather", "replay_parow", "replay_resident"))
    hits = {(h.factor, h.stage, h.sigma) for h in res.factors}
    if (not counts["tape"] or not counts["chain"]
            or any(c for k, c in counts.items() if k not in ("tape",
                                                            "chain"))):
        raise AssertionError(f"noinv launches: {counts}")
    if (not hits <= ref["finds"] or not any(st == 2 for _f, st, _s in hits)
            or res.counters["numinv"]):
        raise AssertionError(f"noinv: finds {sorted(hits)} not a subset of "
                             f"stream's with a stage-2 find, or numinv "
                             f"{res.counters['numinv']}")
    t = res.timings
    lines.append(f"noinv: {res.counters['paired']} entries, stage1 "
                 f"{t['stage1']:.2f} s, stage2_init {t['stage2_init']:.2f} "
                 f"s, stage2 {t['stage2']:.2f} s (stream's "
                 f"{ref['timings']['stage2']:.2f}), wall {wall:.2f} s, "
                 f"{_finds_line(hits)} of stream's "
                 f"{_finds_line(ref['finds'])}, numinv 0, launches {counts}")
    print("  " + lines[-1], flush=True)

    for engine in ("digit", "rns"):
        r = runs[(engine, "stream")]
        kernels.reset_launches()
        t0 = time.time()
        res = driver.resume_stage2(
            r["save"], r["job"]["b2"], verbose=0, device="cuda",
            engine=engine, results_path=os.path.join(tmp, f"resume_{engine}.txt"))
        wall = time.time() - t0
        names = _job_kernels(engine)
        counts = _launches(record, f"surface_resume_{engine}", names)
        stage2 = [k for k in names if k not in ("tape", "rns_tape")]
        other = {k: c for k, c in kernels.launches.items()
                 if c and k not in names}
        hits = {(h.factor, h.stage, h.sigma) for h in res.factors}
        if hits != r["finds"] or (res.counters["paired"]
                                  != r["counters"]["paired"]):
            raise AssertionError(
                f"resume {engine}: finds missing {sorted(r['finds'] - hits)}"
                f", extra {sorted(hits - r['finds'])}, paired "
                f"{res.counters['paired']} against {r['counters']['paired']}")
        if not all(counts[k] for k in stage2) or other:
            raise AssertionError(f"resume {engine} launches: {counts}, "
                                 f"others {other}")
        t = res.timings
        lines.append(f"resume {engine} ({res.curves_run} records to B2="
                     f"{r['job']['b2']}): build {t['build']:.2f} s, "
                     f"stage2_init {t['stage2_init']:.2f} s, stage2 "
                     f"{t['stage2']:.2f} s, wall {wall:.2f} s, "
                     f"{_finds_line(hits)} as phase 8's stream run, paired "
                     f"{res.counters['paired']}, launches {counts}")
        print("  " + lines[-1], flush=True)

    kernels.reset_launches()
    t0 = time.time()
    res = _run(os.path.join(tmp, "full_prac"), n=n, curves=j["curves"],
               b1=j["b1"], b2=j["b1"], sigma=j["sigma"], engine="digit",
               full_prac=True, stop_on_factor=False)
    wall = time.time() - t0
    counts = _launches(record, "surface_full_prac", ("tape",))
    pairs = list(zip(res.stage1_residues, ref["residues"]))
    if (len(pairs) != j["curves"] or not counts["tape"]
            or any(s1 != s2 or (x1 * z2 - x2 * z1) % n
                   for (s1, x1, z1), (s2, x2, z2) in pairs)):
        raise AssertionError("full PRAC: stage-1 residues differ from the "
                             f"reduced rule set's, or K1 launches {counts}")
    lines.append(f"full PRAC: stage 1 {res.timings['stage1']:.2f} s "
                 f"(reduced: {ref['timings']['stage1']:.2f}), "
                 f"{res.counters['ptadds']} adds and "
                 f"{res.counters['ptdups']} doublings, {len(pairs)} "
                 f"residues equal as points, wall "
                 f"{wall:.2f} s, launches {counts}")
    return "; ".join(lines)


def phase_multidevice(tmp, record, runs):
    """Phase 8's digit and RNS stream jobs with the curve axis split:
    Sharder(["cuda:0", "cuda:0"]) on one card, every card when there are
    more; each run must give phase 8's one-device stream run exactly (its
    finds, paired and numinv counters and save_b1.txt bytes) through the
    engine's kernels; then run_multihost in this one process on the digit
    job, with the same finds and bytes."""
    import torch
    from tpu_ecm_torch.limbs import kernels
    from tpu_ecm_torch.parallel import Sharder, distributed
    cards = torch.cuda.device_count()
    sharder = Sharder(None if cards > 1 else ["cuda:0", "cuda:0"])
    lines = [f"devices {[str(d) for d in sharder.devices]}"]

    def check(label, ref, res, d, wall, names):
        counts = {k: kernels.launches[k] for k in names}
        hits = {(h.factor, h.stage, h.sigma) for h in res.factors}
        with open(os.path.join(d, "save_b1.txt"), "rb") as fh, \
                open(ref["save"], "rb") as gh:
            same_save = fh.read() == gh.read()
        keys = ("paired", "numinv")
        if (hits != ref["finds"] or not same_save
                or any(res.counters[k] != ref["counters"][k] for k in keys)
                or not all(counts.values())):
            raise AssertionError(
                f"{label}: finds missing {sorted(ref['finds'] - hits)}, "
                f"extra {sorted(hits - ref['finds'])}, save_b1.txt "
                f"{'equal' if same_save else 'DIFFERS'}, counters "
                f"{[res.counters[k] for k in keys]} against "
                f"{[ref['counters'][k] for k in keys]}, launches {counts}")
        j, t = ref["job"], res.timings
        lines.append(
            f"{label}: {j['curves'] / wall:.2f} curves/s (phase 8: "
            f"{j['curves'] / ref['wall']:.2f}), wall {wall:.2f} s (phase 8:"
            f" {ref['wall']:.2f}), stage1 {t['stage1']:.2f} / stage2_init "
            f"{t['stage2_init']:.2f} / stage2 {t['stage2']:.2f} s (phase 8:"
            f" {ref['timings']['stage1']:.2f} / "
            f"{ref['timings']['stage2_init']:.2f} / "
            f"{ref['timings']['stage2']:.2f}), {_finds_line(hits)}, "
            f"paired {res.counters['paired']}, numinv "
            f"{res.counters['numinv']}, save_b1.txt equal, launches "
            f"{counts}")
        print("  " + lines[-1], flush=True)

    for engine in ("digit", "rns"):
        ref = runs[(engine, "stream")]
        n, j = ref["n"], ref["job"]
        d = os.path.join(tmp, engine)
        kernels.reset_launches()
        t0 = time.time()
        res = _run(d, n=n, curves=j["curves"], b1=j["b1"], b2=j["b2"],
                   sigma=j["sigma"], engine=engine, replay="stream",
                   stop_on_factor=False, sharder=sharder)
        wall = time.time() - t0
        names = _job_kernels(engine)
        _launches(record, f"multidevice_{engine}", names)
        check(f"{engine} over {sharder.n} shards", ref, res, d, wall, names)

    ref = runs[("digit", "stream")]
    n, j = ref["n"], ref["job"]
    d = os.path.join(tmp, "multihost")
    os.makedirs(d)
    kernels.reset_launches()
    t0 = time.time()
    res = distributed.run_multihost(
        n, total_curves=j["curves"], b1=j["b1"], b2=j["b2"],
        sigma=j["sigma"], engine="digit", stop_on_factor=False, verbose=0,
        save_b1_path=os.path.join(d, "save_b1.txt"),
        checkpoint_path=os.path.join(d, "checkpoint.txt"),
        results_path=os.path.join(d, "ecm_results.txt"))
    wall = time.time() - t0
    _launches(record, "multidevice_multihost", _job_kernels("digit"))
    check(f"run_multihost, one process ({cards} card"
          f"{'s' if cards > 1 else ''})", ref, res, d, wall,
          _job_kernels("digit"))
    return "; ".join(lines)


def phase_acceptance(record):
    """Row 13 of test.csh at full bounds through the sweep's row runner:
    it must match the reference's (factor, stage, sigma), its stage 2
    must walk more than one prime chunk, and K1-K5 must launch."""
    from tpu_ecm_torch import acceptance
    from tpu_ecm_torch.limbs import kernels
    row = acceptance_row(13)
    kernels.reset_launches()
    rec = acceptance.run_row(row, "cuda")
    counts = _launches(record, "acceptance", _job_kernels("digit"))
    t, s2 = rec["timings"], rec["stage2"]
    line = (f"row 13: {rec['bits']} bits, engine {rec['engine']} (nw="
            f"{rec['nw']}), {rec['curves_run']} curves, B1={row[2]}, "
            f"B2={row[3]}: wall {rec['wall']:.2f} s, stage1 "
            f"{t['stage1']:.2f} / stage2_init {t['stage2_init']:.2f} / "
            f"stage2 {t['stage2']:.2f} / plan_wait "
            f"{t.get('stage2_plan_wait', 0):.2f} s, chunks {s2['chunks']}, "
            f"D={s2['D']}, U={s2['U']}, pa_group {s2['pa_group']}, "
            f"launches {counts}; hits {rec['hits']}")
    missing = [k for k, c in counts.items() if c == 0]
    if not rec["ok"] or missing or s2["chunks"] < 2:
        raise AssertionError(f"row 13 does not match the reference's "
                             f"(factor {row[5]}, stage {row[6]}, sigma "
                             f"{row[4]}), or kernels {missing} never "
                             f"launched, or one chunk: {line}")
    return line


# job -> (N, bounds, driver options, warm-up run of the same path)
PROFILE_JOBS = {
    "flagship": (N416, FLAGSHIP, {}, dict(n=N71, engine="digit")),
    "rns": (None, RNS_JOB, {}, dict(n=N71, engine="rns")),
    "mersenne": (M1277, MERSENNE_JOB, {}, dict(n=M101)),
    "edwards": (N416, FLAGSHIP, dict(curve_mode="edwards"),
                dict(n=N71, curve_mode="edwards")),
}


def _profile_launches(per_name) -> dict:
    """name -> (kernels.launches, launches the profile lists) for each of
    the port's kernels launched in the profiled run; a profile entry is
    the kernel whose template (LANE_KERNELS' for the lane-core kernels,
    name + "_kernel" for the others) its demangled name calls."""
    from tpu_ecm_torch.limbs import kernels
    listed = {}
    for name, (count, _us) in per_name.items():
        hit = re.search(r"(\w+_kernel)[<(]", name)
        if hit:
            listed[hit.group(1)] = listed.get(hit.group(1), 0) + count
    return {k: (c, listed.get(LANE_KERNELS[k][1] if k in LANE_KERNELS
                              else k + "_kernel", 0))
            for k, c in kernels.launches.items() if c}


def profile_job(tmp, out_dir, job: str):
    """One job once under torch.profiler (after a small warm-up run of the
    same path, so lazy set-up stays outside the window): device time per
    kernel, and the union of the card's kernel intervals against the job's
    wall time, which gives the card's idle share of the job; each of the
    port's kernels' launches in the profile against kernels.launches of
    the same run (_profile_launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpu_ecm_torch.limbs import kernels
    n, j, opts, warm = PROFILE_JOBS[job]
    n = n or row21_n()
    _run(os.path.join(tmp, "o1"), curves=4, b1=300, b2=10000, sigma=110,
         **warm)
    sub = os.path.join(tmp, job)
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = _run(sub, n=n, curves=j["curves"], b1=j["b1"], b2=j["b2"],
                   sigma=j["sigma"], stop_on_factor=False, **opts)
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
    counts = _profile_launches(per_name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_{job}.txt")
    with open(path, "w") as fh:
        fh.write(f"{smi_line()}\n")
        for name, (count, us) in rows:
            fh.write(f"{us / 1e6:12.6f} s {count:8d}x  {name}\n")
        fh.write(f"launches (kernels.launches, profile): {counts}\n")
    for name, (count, us) in rows[:8]:
        print(f"  {us / 1e6:12.6f} s {count:8d}x  {name[:70]}")
    differ = {k: c for k, c in counts.items() if c[0] != c[1]}
    print(f"  launches (kernels.launches, profile): {counts}"
          + (f"; DIFFER: {differ}" if differ else "; equal"), flush=True)
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
    ap.add_argument("--job", choices=tuple(PROFILE_JOBS) + ("all",),
                    default="all", help="the job(s) --profile runs")
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
            jobs = tuple(PROFILE_JOBS) if args.job == "all" else (args.job,)
            for job in jobs:
                phase("profile",
                      lambda: profile_job(tmp, args.profile, job))
            return 0
        phase("kernels", lambda: phase_kernels(record))
        phase("oracle", lambda: phase_oracle(tmp))
        runs = {}
        for name, fn in (("flagship", phase_flagship), ("rns", phase_rns),
                         ("mersenne", phase_mersenne),
                         ("edwards", phase_edwards),
                         ("replay", lambda t, r: phase_replay(t, r, runs)),
                         ("surface",
                          lambda t, r: phase_surface(t, r, runs)),
                         ("multidevice",
                          lambda t, r: phase_multidevice(t, r, runs))):
            phase(name, lambda: fn(os.path.join(tmp, name), record))
        phase("acceptance", lambda: phase_acceptance(record))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # "launches" is the count of the kernel's main path: the flagship job
    # for the digit kernels of its default replay mode, the edwards job for
    # K9, the rns job for RNS (with K15, its default replay), phase 8's run
    # in its own mode for the other replay kernels (K6, K7, K8, K14)
    main_job = {k: f"replay_{e}_{m}" for e in ("digit", "rns")
                for m, k in _ops(e).replay_kernels.items()}
    main_job.update(dict.fromkeys(_job_kernels("digit"), "flagship"))
    main_job.update(dict.fromkeys(_job_kernels("rns"), "rns"),
                    ed_tape="edwards")
    out = []
    for name, (source, replaces) in kernels.KERNELS.items():
        r = record[name]
        launches = r["launches_by_job"]
        if not any(launches.values()):
            raise AssertionError(f"{name} never launched in any job")
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[main_job[name]], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            launches_by_job=launches,
            **{k: r[k] for k in ("cap", "slabs", "smem_bytes",
                                 "k6_ms_per_entry_same", "geometry",
                                 "ptxas", "share_of_bound", "fold")
               if k in r}))
    print(json.dumps({"kernels": out}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
