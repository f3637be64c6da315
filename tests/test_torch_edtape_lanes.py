"""K9's CUDA source run on the CPU (no card needed).

csrc/ed_tape.cu runs K9, the Edwards stage-1 tape, on the lane core
csrc/arith_lanes.cuh: L lanes per curve, X, Y, Z and T in shared-memory
slots for the whole launch, each op a program of four paired product steps
with the sums, differences and negations (STEP_NEG, no lazy pass) between
them, an add's table row loaded into the k slots (ED_SUB with its first
two planes swapped).  tools/lane_shim builds its kernel body with g++
against a CPU stand-in of the CUDA runtime (a std::thread per CUDA thread,
shuffles through a per-warp buffer).  Each case holds the kernel body digit
for digit against curve/edops.run_tape on CPU tensors: REDC at nw = 36
with norm_inputs on and off, Mersenne and pseudo-Mersenne folds (M127,
2^200 - c, M1277 at 16 lanes of 8 digits, c = -1), tapes holding every
opcode with table rows 0 and Tp - 1, batches that leave their last block
part empty; and once, on a real Edwards state handed across by convert.py,
against tpu_ecm.curve.edops.run_tape (JAX on the CPU).
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpu_ecm import params as j_params  # noqa: E402
from tpu_ecm.curve import edops as j_edops  # noqa: E402
from tpu_ecm.limbs import jnp_ops  # noqa: E402
from tpu_ecm_torch import convert, params  # noqa: E402
from tpu_ecm_torch.curve import edops, edwards  # noqa: E402
from tpu_ecm_torch.limbs import kernels, torch_ops  # noqa: E402
from tpu_ecm_torch.primes import primes_range  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TP = 1 << (edwards.DEFAULT_W - 2)


def _lane_shim():
    """tools/lane_shim/check.py, loaded by path (tools is no package)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K9's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ed_cases_cover_the_edges():
    """The shim's K9 cases: REDC with norm_inputs on and off, a Mersenne
    (c = 1), a pseudo-Mersenne (|c| of several digits) and a c = -1 fold,
    M1277's nw = 118; every batch leaves its last block part empty, at
    most 64 curves and 64 ops; the tapes hold every opcode and table rows
    0 and Tp - 1."""
    shim = _lane_shim()
    kinds, nws = set(), set()
    for case, (n, mers, w, b, lanes, ops) in enumerate(shim.ED_CASES):
        ctx = params.make_monty(n, mersenne=mers, force_w=w)
        nws.add(ctx.p.nw)
        if mers is None:
            kinds.add(f"norm={ctx.p.norm_inputs}")
        else:
            kinds.add({1: "c=1", -1: "c=-1"}.get(mers[1], "c>1"))
        per_block = kernels.TAPE_BLOCK // (
            lanes or kernels.tape_geometry(ctx.p.nw, b)[0])
        assert b % per_block, "every case leaves its last block part empty"
        assert b <= 64 and ops <= 64
        # compare_ed_tape's tape for seed=case
        tape = shim.ed_tape_ops(np.random.default_rng(case + 1), ops, TP)
        assert set(tape[:, 0]) == {edwards.ED_DBL, edwards.ED_DBLT,
                                   edwards.ED_ADD, edwards.ED_SUB,
                                   edwards.ED_NOP}
        rows = tape[np.isin(tape[:, 0], (edwards.ED_ADD, edwards.ED_SUB)), 1]
        assert {0, TP - 1} <= set(rows)
    assert {"norm=True", "norm=False", "c=1", "c>1", "c=-1"} <= kinds
    assert {36, 118} <= nws


@pytest.mark.parametrize("case", range(6))
def test_ed_tape_source_on_cpu(case):
    """csrc/ed_tape.cu's kernel body, built by g++ through tools/lane_shim,
    equals curve/edops.run_tape digit for digit on a tape of every
    opcode."""
    shim = _lane_shim()
    assert len(shim.ED_CASES) == 6
    n, mers, force_w, b, lanes, ops = shim.ED_CASES[case]
    lib = shim.load(shim.build_lib())
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    results = shim.compare_ed_tape(lib, ctx, b, ops, lanes, seed=case)
    assert len(results) == 1 and all(ok for _what, ok in results), results


def test_ed_tape_source_matches_jax():
    """On a real Edwards state (N416, 20 curves from sigma 7000, the first
    47 ops of the B1=2000 tape and a NOP) handed across by convert.py,
    csrc/ed_tape.cu's kernel body equals tpu_ecm's jnp edops.run_tape and
    the plain K9 digit for digit."""
    shim = _lane_shim()
    n = shim.N416
    tctx = params.make_monty(n)
    jctx = j_params.make_monty(n)
    b1, b = 2000, 20
    tape, lead = edwards.stage1_tape(primes_range(0, b1 + 100), b1)
    tape = np.concatenate([tape[:47], [[edwards.ED_NOP, 3]]]).astype(np.int32)
    assert set(tape[:, 0]) == {0, 1, 2, 3, 4}
    curves = [edwards.build_one_curve(tctx, s) for s in range(7000, 7000 + b)]
    pts, table = edwards.build_batch_tables(tctx, curves)
    acc0 = edwards.init_accumulator(tctx, pts, lead)
    want = np.asarray(jax.jit(j_edops.run_tape)(
        jnp.asarray(acc0), jnp.asarray(tape), jnp.asarray(table),
        jnp_ops.device_ctx(jctx)))
    acc, tab = convert.ed_state(acc0, table, tctx.p, "cpu")
    d = torch_ops.device_ctx(tctx, "cpu")
    lanes, digits, _per, _blocks = kernels.tape_geometry(tctx.p.nw, b)
    got = shim.run_ed_tape(shim.load(shim.build_lib()), d, acc, tape, tab,
                           lanes, digits)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = edops.run_tape(acc.clone(), tape, tab, d)
    assert torch.equal(got, plain)
