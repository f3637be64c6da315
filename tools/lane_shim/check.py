"""Run the lane core of tpu_ecm_torch/csrc/arith_lanes.cuh (K1's
arithmetic) and the kernel bodies of K2 (csrc/chain.cu), K3 and K4
(csrc/batch_inverse.cu), K5 (csrc/replay.cu), K6 and K7
(csrc/replay_gather.cu), K8 (csrc/replay_resident.cu) and K9
(csrc/ed_tape.cu), and
K10's, K11's, K12's, K13's, K14's and K15's (csrc/rns_tape.cu,
csrc/rns_chain.cu, csrc/rns_batch_inverse.cu, csrc/rns_replay_gather.cu,
csrc/rns_replay.cu, on the tensor-core core csrc/rns_mma.cuh), on the CPU
and hold them against their plain versions.

The CUDA source is built by g++ against cuda_runtime.h beside this file,
which runs every CUDA thread as a std::thread and shuffles through a
per-warp buffer between barriers (see its header).  lanes_check.cpp's
entry points run a product step per curve (a*b, a*a, or a*b written over
a's slot, each paired with b*b) and the DUP and ADD programs,
lanes_replay runs K5 on one call, lanes_replay_gather K6 or K7 on one
call, lanes_replay_resident K8 on one call, lanes_ed_tape K9 on one
Edwards tape,
lanes_chain K2 on one chain, lanes_prefix K3 and lanes_apply_inverse K4
on one stack; they are compared digit for digit with limbs/torch_ops.mulmod /
sqrmod, curve/ops.xdbl / xadd, limbs/kernels.replay_plain,
replay_gather_plain, replay_parow_plain, replay_resident_plain,
curve/edops.run_tape, limbs/kernels.chain_plain, prefix_plain and
apply_inverse_plain on CPU tensors.  K3's-K8's cp.async copies
land at once and, in a second run, at their wait
(cuda_pipeline_primitives.h).  K10's to K15's bodies are built apart
(rns_check.cpp, with mma.h standing in for nvcuda::wmma) and held residue
for residue against limbs/rns_exec.run_tape on a tape of every opcode,
against rns_kernels.chain_plain on chains of 1 to 5 rows, against
rns_kernels.prefix_plain and apply_inverse_plain on stacks of 1 to 5 rows,
against rns_kernels.replay_gather_plain on calls of v-sorted entries and
pads (K14's entry copies landing at once and at their wait) and against
rns_kernels.replay_plain on stream calls with pads and entries past the
count (K15's entry copies landing at once and at their wait), at a small
K, K=200 (the rns job's; its weights in shared memory), K=224 (past the
shared-memory limit: the fragments load from the global table) and
ragged batches.
From the repository root:

    python tools/lane_shim/check.py              # -O2 build
    python tools/lane_shim/check.py --sanitize   # ASan + UBSan build

The libraries go to build/lane_shim/ (a directory .gitignore lists),
named by a hash of the sources and flags.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tpu_ecm_torch import params  # noqa: E402
from tpu_ecm_torch.curve import edops, edwards  # noqa: E402
from tpu_ecm_torch.curve import ops as curve_ops  # noqa: E402
from tpu_ecm_torch.limbs import build, kernels, layout, torch_ops  # noqa: E402
from tpu_ecm_torch.limbs import rns, rns_exec, rns_kernels  # noqa: E402

BUILD_DIR = os.path.join(REPO, "build", "lane_shim")
SOURCES = (os.path.join(HERE, "cuda_runtime.h"),
           os.path.join(HERE, "lanes_check.cpp"),
           os.path.join(HERE, "cuda_pipeline_primitives.h"),
           os.path.join(build.CSRC, "arith.cuh"),
           os.path.join(build.CSRC, "arith_lanes.cuh"),
           os.path.join(build.CSRC, "replay.cu"),
           os.path.join(build.CSRC, "replay_gather.cu"),
           os.path.join(build.CSRC, "replay_passes.cuh"),
           os.path.join(build.CSRC, "replay_resident.cu"),
           os.path.join(build.CSRC, "ed_tape.cu"),
           os.path.join(build.CSRC, "chain.cu"),
           os.path.join(build.CSRC, "batch_inverse.cu"))
RNS_SOURCES = (os.path.join(HERE, "cuda_runtime.h"),
               os.path.join(HERE, "rns_check.cpp"),
               os.path.join(HERE, "mma.h"),
               os.path.join(HERE, "cuda_pipeline_primitives.h"),
               os.path.join(build.CSRC, "rns_mma.cuh"),
               os.path.join(build.CSRC, "rns_ring.cuh"),
               os.path.join(build.CSRC, "rns_tape.cu"),
               os.path.join(build.CSRC, "rns_chain.cu"),
               os.path.join(build.CSRC, "rns_batch_inverse.cu"),
               os.path.join(build.CSRC, "rns_replay_gather.cu"),
               os.path.join(build.CSRC, "rns_replay.cu"))
SANITIZE = ("-O1", "-g", "-fsanitize=address,undefined")


def build_lib(sanitize: bool = False, sources=SOURCES,
              name: str = "lanes") -> str:
    """g++ build of sources[1] (lanes_check.cpp, or rns_check.cpp with
    RNS_SOURCES) unless this source hash is built; returns the library's
    path."""
    flags = ["-std=c++20", "-fPIC", "-shared", "-pthread",
             *(SANITIZE if sanitize else ("-O2",)), "-I", HERE,
             "-I", build.CSRC, f"-DTPUECM_NW_MAX={build.NW_MAX}",
             f"-DTPUECM_CL_MAX={build.CL_MAX}"]
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", *flags, "-o", tmp, sources[1]], check=True)
        os.replace(tmp, out)
    return out


def load_rns(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rns_tape_run.argtypes = [P, ctypes.c_longlong, P, P, P, P, I, I, I]
    lib.rns_tape_run.restype = I
    lib.tpuecm_rns_tape_geometry.argtypes = [I, I, I, P]
    lib.tpuecm_rns_tape_geometry.restype = I
    lib.rns_reduce.argtypes = [P, P, I, ctypes.c_uint, ctypes.c_uint, P]
    lib.rns_reduce.restype = None
    lib.rns_chain_run.argtypes = [P, P, P, P, I, P, P, I, I, I]
    lib.rns_chain_run.restype = I
    lib.tpuecm_rns_chain_geometry.argtypes = [I, I, I, P]
    lib.tpuecm_rns_chain_geometry.restype = I
    lib.rns_prefix_run.argtypes = [P, P, P, I, P, P, I, I, I]
    lib.rns_prefix_run.restype = I
    lib.rns_apply_inverse_run.argtypes = [P, P, P, P, P, I, P, P, I, I, I]
    lib.rns_apply_inverse_run.restype = I
    for name in ("tpuecm_rns_prefix_geometry",
                 "tpuecm_rns_apply_inverse_geometry"):
        getattr(lib, name).argtypes = [I, I, I, P]
        getattr(lib, name).restype = I
    lib.rns_gather_run.argtypes = [P, P, P, P, P, P, I, I, P, P, I, I, I,
                                   I]
    lib.rns_gather_run.restype = I
    lib.tpuecm_rns_gather_geometry.argtypes = [I, I, I, P]
    lib.tpuecm_rns_gather_geometry.restype = I
    lib.rns_replay_run.argtypes = [P, P, P, P, P, I, P, P, I, I, I, I]
    lib.rns_replay_run.restype = I
    lib.tpuecm_rns_replay_geometry.argtypes = [I, I, I, P]
    lib.tpuecm_rns_replay_geometry.restype = I
    return lib


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lanes_mul.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                              I]
    lib.lanes_point.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                                I]
    lib.lanes_replay.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                                 I, I, I, I]
    lib.lanes_ed_tape.argtypes = [P, ctypes.c_longlong, P, P, P, P, I, I, I,
                                  I, I, I, I, I, I, I]
    lib.lanes_chain.argtypes = [P, P, P, P, I, P, P, I, I, I, I, I, I, I, I,
                                I, I]
    lib.lanes_mul.restype = lib.lanes_point.restype = I
    lib.lanes_replay.restype = lib.lanes_ed_tape.restype = I
    lib.lanes_prefix.argtypes = [P, P, P, I, P, P, I, I, I, I, I, I, I, I,
                                 I, I, I]
    lib.lanes_apply_inverse.argtypes = [P, P, P, P, P, I, P, P, I, I, I, I,
                                        I, I, I, I, I, I, I]
    lib.lanes_chain.restype = lib.lanes_prefix.restype = I
    lib.lanes_apply_inverse.restype = I
    lib.lanes_replay_gather.argtypes = [P, P, P, P, P, P, I, I, P, P, I, I,
                                        I, I, I, I, I, I, I, I, I, I]
    lib.lanes_replay_gather.restype = I
    lib.lanes_replay_resident.argtypes = [P, P, P, P, I, P, P, I, I, I, P,
                                          P, I, I, I, I, I, I, I, I, I, I,
                                          I]
    lib.lanes_replay_resident.restype = I
    return lib


def _mod(d):
    p = d.p
    return (d.n.data_ptr(), d.c.data_ptr(), int(d.c.shape[0]),
            d.mersenne_e, d.mersenne_c_sign, p.nw, p.w, d.nprime,
            int(p.norm_inputs))


def _values(ctx, d, rng, count, b):
    """count operands [nw, B]: reduced random values through one product
    and a difference."""
    p = ctx.p
    k = (p.nbits - 1) // p.w

    def reduced():
        a = np.zeros((p.nw, b), np.int32)
        a[:k] = rng.integers(0, 1 << p.w, (k, b))
        return torch.from_numpy(a)

    return [torch_ops.submod_n(torch_ops.mulmod(reduced(), y, d, pre=True),
                               y, d)
            for y in (reduced() for _ in range(count))]


def compare(lib, ctx, b: int, lanes=None, seed: int = 0) -> list:
    """(what, equal) of each product and point program of the lane core
    against the plain version on B curves, at tape_geometry's lanes or at
    `lanes` (then D = ceil(nw / lanes), at least 2)."""
    d = torch_ops.device_ctx(ctx, "cpu")
    nw = ctx.p.nw
    if lanes is None:
        lanes, digits, _, _ = kernels.tape_geometry(nw, b)
    else:
        digits = max(2, -(-nw // lanes))
    rng = np.random.default_rng(seed)
    a, y, s, *pts = _values(ctx, d, rng, 9, b)
    out, res = [], []
    want2 = torch_ops.sqrmod(y, d, pre=True)
    for op, want in ((0, torch_ops.mulmod(a, y, d, pre=True)),
                     (1, torch_ops.sqrmod(a, d, pre=True)),
                     (2, torch_ops.mulmod(a, y, d, pre=True))):
        got, got2 = torch.zeros_like(a), torch.zeros_like(a)
        if lib.lanes_mul(a.data_ptr(), y.data_ptr(), got.data_ptr(),
                         got2.data_ptr(), *_mod(d), b, lanes, digits, op):
            raise ValueError(f"no instantiation for D={digits}")
        res.append((("a*b", "a*a", "a*b over a")[op] + " with b*b",
                    torch.equal(got, want) and torch.equal(got2, want2)))
    stack = torch.stack(pts).contiguous()
    for add, want in ((0, curve_ops.xdbl(pts[0], pts[1], s, d)),
                      (1, curve_ops.xadd(*pts, d))):
        got = torch.zeros((2, nw, b), dtype=torch.int32)
        if lib.lanes_point(stack.data_ptr(), got.data_ptr(), s.data_ptr(),
                           *_mod(d), b, lanes, digits, add):
            raise ValueError(f"no instantiation for D={digits}")
        res.append((("xdbl", "xadd")[add],
                    torch.equal(got, torch.stack(want))))
    return [(f"nw={nw} L={lanes} D={digits} B={b} {what}", ok)
            for what, ok in res]


def replay_call(ctx, b: int, count: int, seed: int = 0):
    """A K5 call's inputs on CPU tensors: acc, pa_ext (G = 5 rows and the
    one), pbx (7 rows, row 0 zero) and idx [count, e...] whose live entries
    are v-sorted Pa runs that change inside quadruples (pa = i*G // n) with
    random Pb rows, the last two pads G << 16 | 0 (count >= 3), followed by
    three entries past count that must not be read."""
    d = torch_ops.device_ctx(ctx, "cpu")
    rng = np.random.default_rng(seed)
    g, pb_rows = 5, 7
    acc, *rows = _values(ctx, d, rng, 1 + g + pb_rows, b)
    one = torch.from_numpy(layout.broadcast_int(ctx.r_mod_n, ctx.p.w,
                                                ctx.p.nw, b))
    pa_ext = torch.stack(rows[:g] + [one]).contiguous()
    pbx = torch.stack(rows[g:]).contiguous()
    pbx[0] = 0
    pads = 2 if count >= 3 else 0
    n = count - pads
    pa = np.arange(n) * g // max(n, 1)
    pb = rng.integers(0, pb_rows, n)
    ent = np.concatenate([(pa << 16) | pb, np.full(pads, g << 16),
                          (rng.integers(0, g, 3) << 16)
                          | rng.integers(1, pb_rows, 3)])
    idx = np.concatenate([[count], ent]).astype(np.int32)
    return d, acc, pa_ext, pbx, idx


def compare_replay(lib, ctx, b: int, count: int, lanes=None,
                   seed: int = 0) -> list:
    """(what, equal) of K5's kernel body on a replay_call of `count` live
    entries at B curves against kernels.replay_plain, its Pb copies landing
    at once and at their wait, at tape_geometry's lanes or at `lanes`."""
    nw = ctx.p.nw
    if lanes is None:
        lanes, digits, _, _ = kernels.tape_geometry(nw, b)
    else:
        digits = max(2, -(-nw // lanes))
    d, acc, pa_ext, pbx, idx = replay_call(ctx, b, count, seed)
    want = kernels.replay_plain(acc, pa_ext, pbx, idx, d)
    dev = torch.from_numpy(idx)
    res = []
    for late in (0, 1):
        got = torch.full_like(acc, -7)
        if lib.lanes_replay(acc.data_ptr(), got.data_ptr(),
                            pa_ext.data_ptr(), pbx.data_ptr(),
                            dev.data_ptr(), *_mod(d), b, lanes, digits,
                            late):
            raise ValueError(f"no instantiation for D={digits}")
        res.append((f"nw={nw} L={lanes} D={digits} B={b} K5 count={count}"
                    f" copies {('at once', 'at their wait')[late]}",
                    torch.equal(got, want)))
    return res


def gather_lanes_call(ctx, b: int, e: int, steps: int, seed: int = 0,
                      sort: bool = True, wide: bool = False):
    """A K6 and a K7 call's inputs on CPU tensors: acc, pa_ext (G = 5 rows
    and the pad row G), pbx (7 rows, row 0 zero), `one` (R mod n in REDC
    mode, 1 in the fold, 2^24 moved from digit 1 into digit 0: the same
    value in a form that a lazy pass changes and whose products' columns
    wrap; also pa_ext[G]), K6's pairs [steps*e, 2] and K7's steps
    [steps, 1 + e].
    acc and the rows are reduced values (_values) or, when `wide`, every
    digit random below 2^(w+6): values past R, whose products are not
    near-canonical (a REDC or fold output of values below about 2n is
    nearly always the canonical one, whatever the association), and
    differences whose columns wrap without their lazy pass.
    K6: v-sorted Pa runs that change inside steps (pa = i*G // live), or
    random rows when not `sort`, random Pb rows, the last three entries
    pads (G, 0).  K7: a step's pa sorted (or not) at random, its Pb rows
    random with pads pb = 0 inside steps (e > 1), the last step a whole
    pad step (pa = G, every pb 0)."""
    d = torch_ops.device_ctx(ctx, "cpu")
    rng = np.random.default_rng(seed)
    g, pb_rows, p = 5, 7, ctx.p
    if wide:
        acc, *rows = torch.from_numpy(rng.integers(
            0, 1 << (p.w + 6), (1 + g + pb_rows, p.nw, b), dtype=np.int32))
    else:
        acc, *rows = _values(ctx, d, rng, 1 + g + pb_rows, b)
    one = torch.from_numpy(layout.broadcast_int(ctx.r_mod_n, p.w, p.nw, b))
    one[0] += 1 << 24
    one[1] -= 1 << (24 - p.w)
    pa_ext = torch.stack(rows[:g] + [one]).contiguous()
    pbx = torch.stack(rows[g:]).contiguous()
    pbx[0] = 0
    n = steps * e
    live = max(n - 3, 0)
    pairs = np.full((n, 2), (g, 0), np.int32)
    pairs[:live, 0] = (np.arange(live) * g // max(live, 1) if sort
                       else rng.integers(0, g, live))
    pairs[:live, 1] = rng.integers(1, pb_rows, live)
    st = np.zeros((steps, 1 + e), np.int32)
    pa = rng.integers(0, g, steps)
    st[:, 0] = np.sort(pa) if sort else pa
    st[:, 1:] = rng.integers(1, pb_rows, (steps, e))
    if e > 1:
        st[:, 1:][rng.random((steps, e)) < 0.25] = 0
    if steps:
        st[-1] = [g] + [0] * e
    return d, acc, pa_ext, pbx, one, pairs, st


def run_replay_gather(lib, d, acc, pa_ext, pbx, idx, one, e: int,
                      lanes: int, digits: int, parow: int,
                      late: int) -> torch.Tensor:
    """K6's (parow 0, idx pairs) or K7's (parow 1, idx steps) kernel body
    on one call, into an output filled with -7 first."""
    got = torch.full_like(acc, -7)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    nsteps = idx.shape[0] // e if not parow else idx.shape[0]
    if lib.lanes_replay_gather(acc.data_ptr(), got.data_ptr(),
                               pa_ext.data_ptr(), pbx.data_ptr(),
                               idx.ctypes.data, one.data_ptr(), nsteps, e,
                               *_mod(d), int(acc.shape[-1]), lanes, digits,
                               parow, late):
        raise ValueError(f"no instantiation for D={digits} or E={e}")
    return got


def compare_replay_gather(lib, ctx, b: int, e: int, steps: int, lanes=None,
                          seed: int = 0, sort: bool = True,
                          wide: bool = False) -> list:
    """(what, equal) of K6's and K7's kernel body on a gather_lanes_call
    (sorted or not, wide or not) of `steps` steps of e entries at B curves
    against
    kernels.replay_gather_plain and replay_parow_plain, their copies
    landing at once and at their wait, at tape_geometry's lanes or at
    `lanes`."""
    nw = ctx.p.nw
    if lanes is None:
        lanes, digits, _, _ = kernels.tape_geometry(nw, b)
    else:
        digits = max(2, -(-nw // lanes))
    d, acc, pa_ext, pbx, one, pairs, st = gather_lanes_call(
        ctx, b, e, steps, seed, sort, wide)
    want = (kernels.replay_gather_plain(acc, pa_ext, pbx, pairs, e, d),
            kernels.replay_parow_plain(acc, pa_ext, pbx, st, one, d))
    head = (f"nw={nw} L={lanes} D={digits} B={b} E={e} steps={steps}"
            f"{'' if sort else ' unsorted'}{' wide' if wide else ''}")
    res = []
    for parow, idx in ((0, pairs), (1, st)):
        for late in (0, 1):
            got = run_replay_gather(lib, d, acc, pa_ext, pbx, idx, one, e,
                                    lanes, digits, parow, late)
            res.append((f"{head} {('K6', 'K7')[parow]} copies "
                        f"{('at once', 'at their wait')[late]}",
                        torch.equal(got, want[parow])))
    return res


def ed_tape_ops(rng, ops: int, tp: int) -> np.ndarray:
    """A [ops, 2] Edwards tape (ops >= 8) holding every opcode (ED_DBL,
    ED_DBLT, ED_ADD, ED_SUB, ED_NOP) in random order, its adds and
    subtractions reading table rows 0 and tp - 1 and random rows between;
    the args of the other ops are random too (the kernel must not read
    them)."""
    op = rng.integers(edwards.ED_DBL, edwards.ED_NOP + 1, ops)
    op[:8] = rng.permutation([edwards.ED_DBL, edwards.ED_DBLT, edwards.ED_ADD,
                              edwards.ED_SUB, edwards.ED_NOP, edwards.ED_ADD,
                              edwards.ED_SUB, edwards.ED_DBL])
    arg = rng.integers(0, tp, ops)
    adds = np.flatnonzero((op == edwards.ED_ADD) | (op == edwards.ED_SUB))
    arg[adds[0]], arg[adds[-1]] = 0, tp - 1
    return np.stack([op, arg], 1).astype(np.int32)


def ed_state(ctx, b: int, tp: int, seed: int = 0):
    """Random K9 inputs on CPU tensors: an accumulator [4, NW, B] of
    products (as every op leaves it) and a window table [tp, 3, NW, B] of
    reduced values (as the host packs it)."""
    d = torch_ops.device_ctx(ctx, "cpu")
    rng = np.random.default_rng(seed)
    p = ctx.p
    k = (p.nbits - 1) // p.w

    def reduced(*shape):
        a = np.zeros(shape + (p.nw, b), np.int32)
        a[..., :k, :] = rng.integers(0, 1 << p.w, shape + (k, b))
        return torch.from_numpy(a)

    acc = torch_ops.mulmod(reduced(4), reduced(4), d, pre=True).contiguous()
    return d, acc, reduced(tp, 3)


def run_ed_tape(lib, d, acc, tape, table, lanes, digits) -> torch.Tensor:
    """K9's kernel body over a copy of acc; returns the copy."""
    got = acc.clone()
    t = torch.from_numpy(np.ascontiguousarray(tape, dtype=np.int32))
    if lib.lanes_ed_tape(t.data_ptr(), t.shape[0], got.data_ptr(),
                         table.data_ptr(), *_mod(d), int(acc.shape[-1]),
                         lanes, digits):
        raise ValueError(f"no instantiation for D={digits}")
    return got


def compare_ed_tape(lib, ctx, b: int, ops: int, lanes=None,
                    seed: int = 0) -> list:
    """(what, equal) of K9's kernel body on an ed_tape_ops tape of `ops`
    ops over ed_state at B curves against curve/edops.run_tape, at
    tape_geometry's lanes or at `lanes`."""
    nw = ctx.p.nw
    if lanes is None:
        lanes, digits, _, _ = kernels.tape_geometry(nw, b)
    else:
        digits = max(2, -(-nw // lanes))
    tp = 1 << (edwards.DEFAULT_W - 2)
    d, acc, table = ed_state(ctx, b, tp, seed)
    tape = ed_tape_ops(np.random.default_rng(seed + 1), ops, tp)
    want = edops.run_tape(acc.clone(), tape, table, d)
    got = run_ed_tape(lib, d, acc, tape, table, lanes, digits)
    return [(f"nw={nw} L={lanes} D={digits} B={b} K9 ops={ops}",
             torch.equal(got, want))]


def chain_points(ctx, b: int, seed: int = 0):
    """Random K2 inputs on CPU tensors: p1, p2 and pd [2, NW, B], each
    coordinate a reduced value through one product and a difference (as
    the chain's own rows leave them)."""
    d = torch_ops.device_ctx(ctx, "cpu")
    vals = _values(ctx, d, np.random.default_rng(seed), 6, b)
    return d, *(torch.stack(vals[i:i + 2]).contiguous() for i in (0, 2, 4))


def run_chain(lib, d, p1, p2, pd, count: int, lanes: int,
              digits: int) -> torch.Tensor:
    """K2's kernel body: `count` chain rows [count, 2, NW, B] from (p1, p2)
    with difference pd, into an output filled with -7 first."""
    out = torch.full((count,) + tuple(p1.shape), -7, dtype=torch.int32)
    if lib.lanes_chain(p1.data_ptr(), p2.data_ptr(), pd.data_ptr(),
                       out.data_ptr(), count, *_mod(d), int(p1.shape[-1]),
                       lanes, digits):
        raise ValueError(f"no instantiation for D={digits}")
    return out


def compare_chain(lib, ctx, b: int, count: int, lanes=None,
                  seed: int = 0) -> list:
    """(what, equal) of K2's kernel body on chain_points at B curves,
    `count` rows, against kernels.chain_plain, at tape_geometry's lanes or
    at `lanes`."""
    nw = ctx.p.nw
    if lanes is None:
        lanes, digits, _, _ = kernels.tape_geometry(nw, b)
    else:
        digits = max(2, -(-nw // lanes))
    d, p1, p2, pd = chain_points(ctx, b, seed)
    want = kernels.chain_plain(p1, p2, pd, count, d)
    got = run_chain(lib, d, p1, p2, pd, count, lanes, digits)
    return [(f"nw={nw} L={lanes} D={digits} B={b} K2 count={count}",
             torch.equal(got, want))]


def batch_stack(ctx, b: int, count: int, seed: int = 0):
    """Random K3 and K4 inputs on CPU tensors: xs and zs [count, NW, B]
    (reduced values through one product and a difference, as the chain's
    rows leave them), one (R mod n in REDC mode, 1 in the fold), pres[i] =
    one * zs[0..i-1] and total_inv, a value as the host packs it."""
    d = torch_ops.device_ctx(ctx, "cpu")
    vals = _values(ctx, d, np.random.default_rng(seed), 2 * count + 1, b)
    xs = torch.stack(vals[:count]).contiguous()
    zs = torch.stack(vals[count:2 * count]).contiguous()
    one = torch.from_numpy(layout.broadcast_int(ctx.r_mod_n, ctx.p.w,
                                                ctx.p.nw, b))
    pre = kernels.prefix_plain(zs, one, d)
    pres = torch.cat([one[None], pre[:-1]]).contiguous()
    return d, xs, zs, one, pres, vals[-1]


def run_prefix(lib, d, zs, one, lanes: int, digits: int,
               late: int) -> torch.Tensor:
    """K3's kernel body, into an output filled with -7 first."""
    out = torch.full_like(zs, -7)
    if lib.lanes_prefix(zs.data_ptr(), one.data_ptr(), out.data_ptr(),
                        int(zs.shape[0]), *_mod(d), int(zs.shape[-1]), lanes,
                        digits, late):
        raise ValueError(f"no instantiation for D={digits}")
    return out


def run_apply_inverse(lib, d, xs, zs, pres, total_inv, lanes: int,
                      digits: int, late: int) -> torch.Tensor:
    """K4's kernel body, into an output filled with -7 first."""
    out = torch.full_like(xs, -7)
    if lib.lanes_apply_inverse(xs.data_ptr(), zs.data_ptr(), pres.data_ptr(),
                               total_inv.data_ptr(), out.data_ptr(),
                               int(xs.shape[0]), *_mod(d),
                               int(xs.shape[-1]), lanes, digits, late):
        raise ValueError(f"no instantiation for D={digits}")
    return out


def compare_batch_inverse(lib, ctx, b: int, count: int, lanes=None,
                          seed: int = 0) -> list:
    """(what, equal) of K3's and K4's kernel bodies on batch_stack at B curves, `count` rows,
    against kernels.prefix_plain and apply_inverse_plain, their cp.async
    copies landing at once and at their wait, at tape_geometry's lanes or
    at `lanes`."""
    nw = ctx.p.nw
    if lanes is None:
        lanes, digits, _, _ = kernels.tape_geometry(nw, b)
    else:
        digits = max(2, -(-nw // lanes))
    d, xs, zs, one, pres, tinv = batch_stack(ctx, b, count, seed)
    want3 = kernels.prefix_plain(zs, one, d)
    want4 = kernels.apply_inverse_plain(xs, zs, pres, tinv, d)
    head = f"nw={nw} L={lanes} D={digits} B={b} count={count}"
    res = []
    for late in (0, 1):
        when = ("at once", "at their wait")[late]
        got = run_prefix(lib, d, zs, one, lanes, digits, late)
        res.append((f"{head} K3, copies {when}", torch.equal(got, want3)))
        got = run_apply_inverse(lib, d, xs, zs, pres, tinv, lanes, digits,
                                late)
        res.append((f"{head} K4, copies {when}", torch.equal(got, want4)))
    return res


def rns_residues(rng, rc, shape) -> torch.Tensor:
    """Random canonical residues [.., 2K+1, B] on the CPU (any canonical
    residues, consistent across channels or not, are K10's inputs)."""
    p = rc.p.numpy().astype(np.int64)
    r = rng.integers(0, 1 << 30, shape) % p
    return torch.from_numpy(r.astype(np.int32))


def rns_tape_shim(lib, pts, tape, s_const, rc) -> torch.Tensor:
    """K10's kernel body over a copy of pts at tape_geometry's tile;
    returns the copy."""
    b = int(pts.shape[-1])
    tile = rns_kernels.tape_geometry(rc.K, b, lib).tile
    got = pts.clone()
    t = np.ascontiguousarray(tape, dtype=np.int32)
    code = lib.rns_tape_run(t.ctypes.data, t.shape[0], got.data_ptr(),
                            s_const.data_ptr(), rc.tab.data_ptr(),
                            rc.wmma.data_ptr(), rc.K, b, tile)
    if code:
        raise ValueError(f"K10 refused K={rc.K} B={b} tile={tile}: {code}")
    return got


def rns_ctx_at(bits: int) -> rns.RnsCtx:
    """The RNS context make_rns builds for a random odd `bits`-bit N, on
    the CPU (K grows with the bits: 24 at 256, 200 at 2397, 224 at
    2700)."""
    import random
    n = random.Random(bits).getrandbits(bits) | 1 | (1 << (bits - 1))
    ctx = params.make_monty(n)
    return rns.device_ctx(rns.make_rns(ctx, cw=rns.choose_cw(ctx.p.nbits)),
                          "cpu")


def compare_rns_tape(lib, rc, b: int, seed: int = 0) -> list:
    """(what, equal) of K10's kernel body on chip_smoke.RNS_EDGE_TAPE
    (every opcode, dst aliasing a, b and c) over random residues at B
    curves against rns_exec.run_tape."""
    tape = np.asarray(chip_smoke.RNS_EDGE_TAPE, dtype=np.int32)
    rng = np.random.default_rng(seed)
    pts = rns_residues(rng, rc, (6, 2, rc.rows, b))
    sc = rns_residues(rng, rc, (rc.rows, b))
    want = rns_exec.run_tape(pts.clone(), tape, sc, rc)
    got = rns_tape_shim(lib, pts, tape, sc, rc)
    g = rns_kernels.tape_geometry(rc.K, b, lib)
    return [(f"K={rc.K} T={g.tile} resident={g.resident} B={b} K10 "
             f"ops={len(tape)}", torch.equal(got, want))]


def rns_chain_shim(lib, p1, p2, pd, count: int, rc, tile=None
                   ) -> torch.Tensor:
    """K11's kernel body on one chain of `count` rows, at chain_geometry's
    tile or the one given (the number of halves follows from it), into an
    output filled with -7 first."""
    b = int(p1.shape[-1])
    geo = rns_kernels.chain_geometry(rc.K, b, lib, tile or 0)
    out = torch.full((count,) + tuple(p1.shape), -7, dtype=torch.int32)
    code = lib.rns_chain_run(p1.data_ptr(), p2.data_ptr(), pd.data_ptr(),
                             out.data_ptr(), count, rc.tab.data_ptr(),
                             rc.wmma.data_ptr(), rc.K, b, geo.tile)
    if code:
        raise ValueError(f"K11 refused K={rc.K} B={b} tile={geo.tile} "
                         f"count={count}: {code}")
    return out


def compare_rns_chain(lib, rc, b: int, count: int, seed: int = 0,
                      tile=None) -> list:
    """(what, equal) of K11's kernel body on random seed points p1, p2 and
    Pd at B curves against rns_kernels.chain_plain, at chain_geometry's
    tile or the one given."""
    rng = np.random.default_rng(seed)
    p1, p2, pd = (rns_residues(rng, rc, (2, rc.rows, b)) for _ in range(3))
    want = rns_kernels.chain_plain(p1, p2, pd, count, rc)
    got = rns_chain_shim(lib, p1, p2, pd, count, rc, tile)
    geo = rns_kernels.chain_geometry(rc.K, b, lib, tile or 0)
    return [(f"K={rc.K} T={geo.tile} H={geo.halves} B={b} K11 "
             f"count={count}", torch.equal(got, want))]


def rns_prefix_shim(lib, zs, one, rc, tile=None) -> torch.Tensor:
    """K12's kernel body on one stack, at prefix_geometry's tile or the one
    given, into an output filled with -7 first."""
    b, count = int(one.shape[-1]), int(zs.shape[0])
    geo = rns_kernels.prefix_geometry(rc.K, b, lib, tile or 0)
    out = torch.full(tuple(zs.shape), -7, dtype=torch.int32)
    code = lib.rns_prefix_run(zs.data_ptr(), one.data_ptr(), out.data_ptr(),
                              count, rc.tab.data_ptr(), rc.wmma.data_ptr(),
                              rc.K, b, geo.tile)
    if code:
        raise ValueError(f"K12 refused K={rc.K} B={b} tile={geo.tile} "
                         f"count={count}: {code}")
    return out


def rns_apply_inverse_shim(lib, xs, zs, pres, tinv, rc, tile=None
                           ) -> torch.Tensor:
    """K13's kernel body on one stack, at apply_inverse_geometry's tile or
    the one given (the number of halves follows from it), into an output
    filled with -7 first."""
    b, count = int(tinv.shape[-1]), int(xs.shape[0])
    geo = rns_kernels.apply_inverse_geometry(rc.K, b, lib, tile or 0)
    out = torch.full(tuple(xs.shape), -7, dtype=torch.int32)
    code = lib.rns_apply_inverse_run(
        xs.data_ptr(), zs.data_ptr(), pres.data_ptr(), tinv.data_ptr(),
        out.data_ptr(), count, rc.tab.data_ptr(), rc.wmma.data_ptr(), rc.K,
        b, geo.tile)
    if code:
        raise ValueError(f"K13 refused K={rc.K} B={b} tile={geo.tile} "
                         f"count={count}: {code}")
    return out


def compare_rns_prefix(lib, rc, b: int, count: int, seed: int = 0,
                       tile=None) -> list:
    """(what, equal) of K12's kernel body on a random stack of `count` z
    rows and a random `one` at B curves against rns_kernels.prefix_plain,
    at prefix_geometry's tile or the one given."""
    rng = np.random.default_rng(seed)
    zs = rns_residues(rng, rc, (count, rc.rows, b))
    one = rns_residues(rng, rc, (rc.rows, b))
    want = rns_kernels.prefix_plain(zs, one, rc)
    got = rns_prefix_shim(lib, zs, one, rc, tile)
    geo = rns_kernels.prefix_geometry(rc.K, b, lib, tile or 0)
    return [(f"K={rc.K} T={geo.tile} B={b} K12 count={count}",
             torch.equal(got, want))]


def compare_rns_apply_inverse(lib, rc, b: int, count: int, seed: int = 0,
                              tile=None) -> list:
    """(what, equal) of K13's kernel body on random stacks xs, zs, pres of
    `count` rows and a random total_inv at B curves against
    rns_kernels.apply_inverse_plain, at apply_inverse_geometry's tile or
    the one given (any canonical residues: the kernel does not rely on
    pres being zs's prefix)."""
    rng = np.random.default_rng(seed)
    xs, zs, pres = (rns_residues(rng, rc, (count, rc.rows, b))
                    for _ in range(3))
    tinv = rns_residues(rng, rc, (rc.rows, b))
    want = rns_kernels.apply_inverse_plain(xs, zs, pres, tinv, rc)
    got = rns_apply_inverse_shim(lib, xs, zs, pres, tinv, rc, tile)
    geo = rns_kernels.apply_inverse_geometry(rc.K, b, lib, tile or 0)
    return [(f"K={rc.K} T={geo.tile} H={geo.halves} B={b} K13 "
             f"count={count}", torch.equal(got, want))]


def gather_call(rng, rc, b: int, e: int, steps: int, g: int = 5,
                pb_rows: int = 7, pads: int = 3):
    """A K14 call's inputs on CPU tensors: acc, pa_ext (g rows and the
    pad row g), pbx (pb_rows rows, row 0 zero) of random residues, and idx
    [steps*e, 2] of v-sorted (pa, pb) entries over few rows (so rows
    repeat) ending in `pads` pad entries (g, 0)."""
    acc = rns_residues(rng, rc, (rc.rows, b))
    pa_ext = rns_residues(rng, rc, (g + 1, rc.rows, b))
    pbx = rns_residues(rng, rc, (pb_rows, rc.rows, b))
    pbx[0] = 0
    n = steps * e
    live = max(n - pads, 0)
    idx = np.full((n, 2), (g, 0), np.int32)
    idx[:live, 0] = np.sort(rng.integers(0, g, live))
    idx[:live, 1] = rng.integers(1, pb_rows, live)
    return acc, pa_ext, pbx, idx


def rns_gather_shim(lib, acc, pa_ext, pbx, idx, e: int, rc, tile=None,
                    late: int = 0) -> torch.Tensor:
    """K14's kernel body on one call, at gather_geometry's tile or the one
    given (the number of halves follows from it), its entry copies landing
    at once or (late) at their wait, into an output filled with -7 first;
    scratch holds only the planes the geometry gives."""
    b = int(acc.shape[-1])
    geo = rns_kernels.gather_geometry(rc.K, b, lib, tile or 0)
    out = torch.full_like(acc, -7)
    scratch = torch.full((geo.scratch,) + tuple(acc.shape), -7,
                         dtype=torch.int32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    code = lib.rns_gather_run(acc.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), pa_ext.data_ptr(),
                              pbx.data_ptr(),
                              idx.ctypes.data, idx.shape[0] // e, e,
                              rc.tab.data_ptr(), rc.wmma.data_ptr(), rc.K, b,
                              geo.tile, late)
    if code:
        raise ValueError(f"K14 refused K={rc.K} B={b} tile={geo.tile} "
                         f"E={e}: {code}")
    return out


def compare_rns_gather(lib, rc, b: int, e: int, steps: int, seed: int = 0,
                       tile=None, lates=(0, 1)) -> list:
    """(what, equal) of K14's kernel body on a gather_call of `steps`
    steps of e entries at B curves against rns_kernels.replay_gather_plain,
    at gather_geometry's tile or the one given, its entry copies landing
    at once (late 0) and at their wait (late 1)."""
    rng = np.random.default_rng(seed)
    acc, pa_ext, pbx, idx = gather_call(rng, rc, b, e, steps)
    want = rns_kernels.replay_gather_plain(acc, pa_ext, pbx, idx, e, rc)
    geo = rns_kernels.gather_geometry(rc.K, b, lib, tile or 0)
    res = []
    for late in lates:
        got = rns_gather_shim(lib, acc, pa_ext, pbx, idx, e, rc, tile, late)
        res.append((f"K={rc.K} T={geo.tile} H={geo.halves}"
                    f" B={b} K14 E={e} steps={steps} copies "
                    f"{('at once', 'at their wait')[late]}",
                    torch.equal(got, want)))
    return res


def stream_call(rng, rc, b: int, count: int, pa: str = "sorted",
                g: int = 5, pb_rows: int = 7, pads: int = 2, past: int = 3):
    """A K15 call's inputs on CPU tensors: acc, pa_ext (g rows and the pad
    row g), pbx (pb_rows rows, row 0 zero) of random residues, and idx
    [1 + count + past]: the count, then count entries pa << 16 | pb whose
    last `pads` (at most half of them) are pads g << 16 | 0 and whose live
    entries take their Pa rows v-sorted over few rows (pa "sorted": rows
    repeat), a new row at every entry (pa "every") or one row throughout
    (pa "one"), then `past` entries past the count that name other rows
    (read, they would change the product)."""
    acc = rns_residues(rng, rc, (rc.rows, b))
    pa_ext = rns_residues(rng, rc, (g + 1, rc.rows, b))
    pbx = rns_residues(rng, rc, (pb_rows, rc.rows, b))
    pbx[0] = 0
    pads = min(pads, count // 2)
    live = count - pads
    rows = {"sorted": lambda: np.sort(rng.integers(0, g, live)),
            "every": lambda: np.arange(live) % g,
            "one": lambda: np.full(live, g - 1)}[pa]()
    ent = np.concatenate([(rows << 16) | rng.integers(1, pb_rows, live),
                          np.full(pads, g << 16),
                          (rng.integers(0, g, past) << 16)
                          | rng.integers(1, pb_rows, past)])
    return acc, pa_ext, pbx, np.concatenate([[count], ent]).astype(np.int32)


def rns_replay_shim(lib, acc, pa_ext, pbx, idx, rc, tile=None,
                    late: int = 0) -> torch.Tensor:
    """K15's kernel body on one call (idx as rns_kernels.replay takes it:
    the count, then the entries, the slots past the count included), at
    replay_geometry's tile or the one given, its entry copies landing at
    once or (late) at their wait, into an output filled with -7 first."""
    b = int(acc.shape[-1])
    geo = rns_kernels.replay_geometry(rc.K, b, lib, tile or 0)
    out = torch.full_like(acc, -7)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    code = lib.rns_replay_run(acc.data_ptr(), out.data_ptr(),
                              pa_ext.data_ptr(), pbx.data_ptr(),
                              idx[1:].ctypes.data, int(idx[0]),
                              rc.tab.data_ptr(), rc.wmma.data_ptr(), rc.K, b,
                              geo.tile, late)
    if code:
        raise ValueError(f"K15 refused K={rc.K} B={b} tile={geo.tile} "
                         f"count={int(idx[0])}: {code}")
    return out


def compare_rns_replay(lib, rc, b: int, count: int, seed: int = 0,
                       tile=None, lates=(0, 1), pa: str = "sorted") -> list:
    """(what, equal) of K15's kernel body on a stream_call of `count`
    entries at B curves against rns_kernels.replay_plain, at
    replay_geometry's tile or the one given, its entry copies landing at
    once (late 0) and at their wait (late 1)."""
    rng = np.random.default_rng(seed)
    acc, pa_ext, pbx, idx = stream_call(rng, rc, b, count, pa)
    want = rns_kernels.replay_plain(acc, pa_ext, pbx, idx, rc)
    geo = rns_kernels.replay_geometry(rc.K, b, lib, tile or 0)
    res = []
    for late in lates:
        got = rns_replay_shim(lib, acc, pa_ext, pbx, idx, rc, tile, late)
        res.append((f"K={rc.K} T={geo.tile} B={b} K15 count={count} "
                    f"pa {pa}, copies {('at once', 'at their wait')[late]}",
                    torch.equal(got, want)))
    return res


# K10's cases (bits of a random N, B): K=24 at ragged batches (B % 4 != 0:
# the scalar loads; B % 8 == 4: a block's second curve group empty), K=200
# (the rns job's, weights in shared memory) and K=224 (past the
# shared-memory limit, T = 4)
RNS_CASES = ((256, 9), (256, 12), (2397, 9), (2700, 3))
# K11's cases (bits of a random N, B, count): the same geometries, counts
# 1, 2 (the seeds as differences only), 3 and 5 (out[i-2] read back)
RNS_CHAIN_CASES = ((256, 9, 5), (256, 12, 1), (256, 9, 2), (2397, 9, 3),
                   (2700, 3, 3))
# K12's and K13's cases (bits of a random N, B, count): the same
# geometries, counts 1, 2, 3 and 5
RNS_BATCH_CASES = ((256, 9, 5), (256, 12, 1), (256, 9, 2), (2397, 9, 3),
                   (2700, 3, 3))
# K14's cases (bits of a random N, B, E, steps): the same geometries, E =
# 16 (the main path's) over three steps, E = 1 and 2 and an odd count of
# steps
GATHER_CASES = ((256, 9, 16, 3), (256, 12, 2, 3), (256, 9, 1, 5),
                (2397, 9, 16, 2), (2700, 3, 16, 2))
# K15's cases (bits of a random N, B, count): the same geometries, counts
# 0, 1, 2, 3 and 260 (past four of the ring's 64-entry chunks)
RNS_REPLAY_CASES = ((256, 9, 3), (256, 12, 2), (256, 9, 0), (256, 7, 1),
                    (256, 9, 260), (2397, 9, 3), (2700, 3, 3))


def resident_lanes_call(ctx, b: int, e: int, steps: int, cap: int = 4,
                        seed: int = 0, sort: bool = True,
                        wide: bool = False):
    """A K8 call's inputs on CPU tensors: gather_lanes_call's acc, pa_ext
    (G = 5 rows and the pad row G, the moved `one`) and its reduced or
    wide values, a Pb table of 2*cap + max(cap // 2, 1) rows (row 0 zero),
    so three slabs of cap rows, the last short (past cap = 1), and the
    call's entries [T, 2]
    (pa, slab row u) and segments [3, 3] (lo, first step, steps): `steps`
    steps of e entries over each slab, u random in 1..rows of its slab,
    pa in v-sorted runs that change inside steps ((i+1)*G // (live+1)) or
    random when not `sort`, the last three live entries pads (G, 0) and a
    whole pad step ending the last segment."""
    d, acc, pa_ext, pbx, one, _pairs, _st = gather_lanes_call(
        ctx, b, e, 1, seed, sort, wide)
    rng = np.random.default_rng(seed + 1)
    g, pb_rows = pa_ext.shape[0] - 1, 2 * cap + max(cap // 2, 1)
    if wide:
        pbx = torch.from_numpy(rng.integers(
            0, 1 << (ctx.p.w + 6), (pb_rows, ctx.p.nw, b), dtype=np.int32))
    else:
        pbx = torch.stack(_values(ctx, d, rng, pb_rows, b)).contiguous()
    pbx[0] = 0
    segs = np.asarray([[lo, h * steps, steps + (h == 2)]
                       for h, lo in enumerate(range(0, pb_rows, cap))],
                      np.int32)
    n = int(segs[:, 2].sum()) * e
    live = n - e - 3
    ent = np.full((n, 2), (g, 0), np.int32)
    ent[:live, 0] = ((np.arange(live) + 1) * g // (live + 1) if sort
                     else rng.integers(0, g, live))
    for lo, s0, ns in segs:
        a, z = s0 * e, min((s0 + ns) * e, live)
        ent[a:z, 1] = rng.integers(1, min(cap, pb_rows - lo) + 1, z - a)
    return d, acc, pa_ext, pbx, ent, segs


def run_replay_resident(lib, d, acc, pa_ext, pbx, ent, segs, cap: int,
                        e: int, lanes: int, digits: int,
                        late: int) -> torch.Tensor:
    """K8's kernel body on one call, into an output filled with -7
    first."""
    got = torch.full_like(acc, -7)
    ent = np.ascontiguousarray(ent, dtype=np.int32)
    segs = np.ascontiguousarray(segs, dtype=np.int32)
    if lib.lanes_replay_resident(acc.data_ptr(), got.data_ptr(),
                                 pa_ext.data_ptr(), pbx.data_ptr(),
                                 int(pbx.shape[0]), ent.ctypes.data,
                                 segs.ctypes.data, segs.shape[0], cap, e,
                                 *_mod(d), int(acc.shape[-1]), lanes, digits,
                                 late):
        raise ValueError(f"no instantiation for D={digits}, E={e} or "
                         f"cap={cap}")
    return got


def compare_replay_resident(lib, ctx, b: int, e: int, steps: int,
                            lanes=None, seed: int = 0, sort: bool = True,
                            wide: bool = False, cap: int = 4) -> list:
    """(what, equal) of K8's kernel body on a resident_lanes_call against
    kernels.replay_resident_plain, its slab fills landing at once and at
    their wait, at tape_geometry's lanes or at `lanes`."""
    nw = ctx.p.nw
    if lanes is None:
        lanes, digits, _, _ = kernels.tape_geometry(nw, b)
    else:
        digits = max(2, -(-nw // lanes))
    d, acc, pa_ext, pbx, ent, segs = resident_lanes_call(
        ctx, b, e, steps, cap, seed, sort, wide)
    want = kernels.replay_resident_plain(acc, pa_ext, pbx, ent, segs, cap, e,
                                         d)
    head = (f"nw={nw} L={lanes} D={digits} B={b} E={e} steps={steps} "
            f"cap={cap}{'' if sort else ' unsorted'}{' wide' if wide else ''}"
            " K8")
    return [(f"{head} fills {('at once', 'at their wait')[late]}",
             torch.equal(run_replay_resident(lib, d, acc, pa_ext, pbx, ent,
                                             segs, cap, e, lanes, digits,
                                             late), want))
            for late in (0, 1)]


def ctx_at_nw(nw: int):
    """A REDC context with exactly nw digits at the largest radix whose
    column bound holds there: a random odd N of w*(nw-1) - 4 bits."""
    import random
    w = next(w for w in range(13, 5, -1)
             if params._digit_bound_fixed_point(w, nw, True) < 0.95 * 2**31)
    bits = w * (nw - 1) - 4
    n = random.Random(nw).getrandbits(bits) | 1 | (1 << (bits - 1))
    ctx = params.make_monty(n, force_w=w)
    assert ctx.p.nw == nw
    return ctx


N416 = (205688069665150755269371147819668813122841983204197482918578443
        * 411376139330301510538742295639337626245683966408394965837157771)
# (modulus, mersenne, force_w, B, lanes): REDC with norm_inputs on and
# off, Mersenne and pseudo-Mersenne folds (c > 1 of several digits,
# c = -1, c < 0), at tape_geometry's lanes and others
CASES = (
    (N416, None, None, 20, None), (N416, None, 10, 20, None),
    (N416, None, None, 5, 16), (N416, None, None, 7, 32),
    ((1 << 127) - 1, (127, 1), None, 9, None),
    ((1 << 200) - 1234567890123, (200, 1234567890123), None, 10, None),
    ((1 << 201) + 1, (201, -1), None, 10, 8),
    ((1 << 301) + 987654321, (301, -987654321), 9, 6, None),
    ((1 << 1277) - 1, (1277, 1), None, 3, None),
)
# K5's cases (modulus, mersenne, force_w, B, lanes): REDC at the flagship's
# nw = 36 (two blocks, the second part empty) and with norm_inputs off
# (nw = 43), the fold at M127 (nw = 10) and M1277 (nw = 118), and c = -1
# at 8 lanes a curve; each at the live counts REPLAY_COUNTS
REPLAY_CASES = (
    (N416, None, None, 20, None), (N416, None, 10, 5, None),
    ((1 << 127) - 1, (127, 1), None, 9, None),
    ((1 << 1277) - 1, (1277, 1), None, 3, None),
    ((1 << 201) + 1, (201, -1), None, 10, 8),
)
REPLAY_COUNTS = (0, 3, 8, 9, 10, 11)
# K6's and K7's cases: REPLAY_CASES at every E a step may take, each over
# a few steps (E = 16, the main path's, over three), and nsteps = 0
GATHER_LANES_STEPS = {1: 7, 2: 5, 4: 5, 8: 3, 16: 3}
# K8's cases: REPLAY_CASES at every E, each over three slab segments of
# these steps (the last segment one whole pad step longer)
RESIDENT_LANES_STEPS = {1: 3, 2: 2, 4: 2, 8: 1, 16: 1}
# K9's cases (modulus, mersenne, force_w, B, lanes, ops): REDC at the
# flagship's nw = 36 with norm_inputs on and off (w = 10, nw = 43), the
# fold at M127, at a pseudo-Mersenne 2^200 - c of three digits of c and at
# M1277 (nw = 118, 16 lanes of 8 digits), and c = -1 at 4 lanes a curve;
# every B leaves its last block part empty
ED_CASES = (
    (N416, None, None, 20, None, 24), (N416, None, 10, 9, None, 24),
    ((1 << 127) - 1, (127, 1), None, 37, None, 24),
    ((1 << 200) - 1234567890123, (200, 1234567890123), None, 10, None, 24),
    ((1 << 1277) - 1, (1277, 1), None, 3, None, 10),
    ((1 << 201) + 1, (201, -1), None, 33, 4, 16),
)


# K2's cases (modulus, mersenne, force_w, B, lanes, count): REDC at the
# flagship's nw = 36 with norm_inputs on and off (w = 10, nw = 43), the
# fold at M127, at a pseudo-Mersenne 2^200 - c of three digits of c and at
# M1277 (nw = 118, 16 lanes of 8 digits), and c = -1 at 4 lanes a curve;
# counts 1, 2, 3 and even and odd counts past 3, so the last row falls on
# either program; every B leaves its last block part empty
CHAIN_CASES = (
    (N416, None, None, 20, None, 8), (N416, None, 10, 9, None, 3),
    ((1 << 127) - 1, (127, 1), None, 37, None, 2),
    ((1 << 200) - 1234567890123, (200, 1234567890123), None, 10, None, 1),
    ((1 << 1277) - 1, (1277, 1), None, 3, None, 4),
    ((1 << 201) + 1, (201, -1), None, 33, 4, 5),
)


# K3's and K4's cases (modulus, mersenne, force_w, B, lanes): REDC at the
# flagship's nw = 36 with norm_inputs on and off (w = 10, nw = 43), the
# fold at M127, at a pseudo-Mersenne 2^200 - c of three digits of c and at
# M1277 (nw = 118, 16 lanes of 8 digits), and c = -1 at 4 lanes a curve;
# each at the counts BATCH_COUNTS (K4's last row on either parity of its
# step pairs); every B leaves its last block part empty
BATCH_CASES = (
    (N416, None, None, 20, None), (N416, None, 10, 9, None),
    ((1 << 127) - 1, (127, 1), None, 37, None),
    ((1 << 200) - 1234567890123, (200, 1234567890123), None, 10, None),
    ((1 << 1277) - 1, (1277, 1), None, 3, None),
    ((1 << 201) + 1, (201, -1), None, 33, 4),
)
BATCH_COUNTS = (1, 2, 3, 4, 5, 8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sanitize", action="store_true",
                    help="build with ASan and UBSan (rerun under their "
                         "runtimes through LD_PRELOAD)")
    args = ap.parse_args()
    path = build_lib(args.sanitize)
    if args.sanitize and "LD_PRELOAD" not in os.environ:
        libs = [subprocess.run(["g++", f"-print-file-name={n}"], check=True,
                               capture_output=True, text=True).stdout.strip()
                for n in ("libasan.so", "libubsan.so")]
        env = dict(os.environ, LD_PRELOAD=":".join(libs),
                   ASAN_OPTIONS="detect_leaks=0")
        return subprocess.run([sys.executable, *sys.argv], env=env).returncode
    lib = load(path)
    bad = 0
    rlib = load_rns(build_lib(args.sanitize, RNS_SOURCES, "rns"))
    for bits, b in RNS_CASES:
        for what, ok in compare_rns_tape(rlib, rns_ctx_at(bits), b):
            print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
            bad += not ok
    for bits, b, count in RNS_CHAIN_CASES:
        for what, ok in compare_rns_chain(rlib, rns_ctx_at(bits), b, count):
            print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
            bad += not ok
    for bits, b, count in RNS_BATCH_CASES:
        rc = rns_ctx_at(bits)
        for what, ok in (compare_rns_prefix(rlib, rc, b, count)
                         + compare_rns_apply_inverse(rlib, rc, b, count)):
            print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
            bad += not ok
    for bits, b, e, steps in GATHER_CASES:
        for what, ok in compare_rns_gather(rlib, rns_ctx_at(bits), b, e,
                                           steps):
            print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
            bad += not ok
    for bits, b, count in RNS_REPLAY_CASES:
        for what, ok in compare_rns_replay(rlib, rns_ctx_at(bits), b, count):
            print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
            bad += not ok
    for n, mers, fw, b, lanes in CASES:
        ctx = params.make_monty(n, mersenne=mers, force_w=fw)
        for what, ok in compare(lib, ctx, b, lanes):
            print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
            bad += not ok
    for n, mers, fw, b, lanes, ops in ED_CASES:
        ctx = params.make_monty(n, mersenne=mers, force_w=fw)
        for what, ok in compare_ed_tape(lib, ctx, b, ops, lanes):
            print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
            bad += not ok
    for n, mers, fw, b, lanes, count in CHAIN_CASES:
        ctx = params.make_monty(n, mersenne=mers, force_w=fw)
        for what, ok in compare_chain(lib, ctx, b, count, lanes):
            print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
            bad += not ok
    for n, mers, fw, b, lanes in BATCH_CASES:
        ctx = params.make_monty(n, mersenne=mers, force_w=fw)
        for count in BATCH_COUNTS:
            for what, ok in compare_batch_inverse(lib, ctx, b, count, lanes):
                print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
                bad += not ok
    for n, mers, fw, b, lanes in REPLAY_CASES:
        ctx = params.make_monty(n, mersenne=mers, force_w=fw)
        for count in REPLAY_COUNTS:
            for what, ok in compare_replay(lib, ctx, b, count, lanes):
                print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
                bad += not ok
        for e, steps in GATHER_LANES_STEPS.items():
            for what, ok in compare_replay_gather(lib, ctx, b, e, steps,
                                                  lanes):
                print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
                bad += not ok
        for e, steps in RESIDENT_LANES_STEPS.items():
            for what, ok in compare_replay_resident(lib, ctx, b, e, steps,
                                                    lanes):
                print(f"{what}: {'equal' if ok else 'DIFFER'}", flush=True)
                bad += not ok
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
