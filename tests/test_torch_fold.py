"""The fold reduction (special forms M = 2^e - c) through the port's plain
versions of K1-K5, held against the JAX package: the stage-1 tape
bit-identical to jax.jit(ops.run_tape) (M61) and to the Pallas tape kernel
in interpret mode (M89), chain / prefix / apply-inverse bit-identical to
the Pallas executors, the replay equal mod M, and the port's Stage2Runner
equal to the JAX runner.  The CUDA kernels take the same fold from
csrc/arith_lanes.cuh; tests/test_torch_gpu.py holds them to these plain
versions on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpu_ecm import params  # noqa: E402
from tpu_ecm.curve import ops as j_ops  # noqa: E402
from tpu_ecm.limbs import jnp_ops, pallas_ops  # noqa: E402
from tpu_ecm_torch.curve import prac  # noqa: E402
from tpu_ecm_torch.limbs import kernels, torch_ops  # noqa: E402
from tpu_ecm_torch.primes import primes_range  # noqa: E402

from test_torch_curve import _curve_file  # noqa: E402
from test_torch_stage2 import (_chain_prefix_apply, _replay,  # noqa: E402
                               _runners)

torch.set_num_threads(1)

M61 = (1 << 61) - 1


def _m61():
    ctx = params.make_monty(M61, mersenne=(61, 1))
    assert ctx.is_mersenne
    return ctx


def test_fold_tape_plain_matches_jnp():
    """K1's plain version on M61 at B=128 with a 14-op stage-1 tape (as
    tests/test_pallas.py:48-60) plus NOP, self-aliasing ADD and DUP
    entries: every slot equals jax.jit(ops.run_tape)."""
    ctx = _m61()
    jd, td = jnp_ops.device_ctx(ctx), torch_ops.device_ctx(ctx, "cpu")
    pts, s = _curve_file(ctx, 128)
    tape = np.concatenate([
        prac.stage1_tape(primes_range(0, 40), 40)[:14],
        [[2, 5, 0, 0, 0], [1, 3, 3, 3, 3], [0, 2, 2, 0, 0]]]).astype(np.int32)
    want = np.asarray(jax.jit(j_ops.run_tape)(
        jnp.asarray(pts), jnp.asarray(tape), jnp.asarray(s), jd))
    kernels.reset_launches()
    got = kernels.tape(torch.from_numpy(pts.copy()), tape,
                       torch.from_numpy(s), td)
    np.testing.assert_array_equal(got.numpy(), want)
    assert kernels.launches["tape"] == 0      # CPU tensors: plain version


def test_fold_tape_plain_matches_pallas_interpret():
    """K1's plain version against the Pallas tape kernel in interpret mode
    in fold mode, on M89 = 2^89 - 1 (w=13, nw=9, norm_inputs on) at B=128
    with an 8-op tape: the whole register file is equal.  (The JAX package
    marks its M61 interpret-mode runs slow; M89 with a short tape keeps
    this one near 15 s.)"""
    ctx = params.make_monty((1 << 89) - 1, mersenne=(89, 1))
    td = torch_ops.device_ctx(ctx, "cpu")
    pts, s = _curve_file(ctx, 128)
    tape = prac.stage1_tape(primes_range(0, 40), 40)[:8]
    run = pallas_ops.make_tape_executor(ctx, 128, chunk=len(tape),
                                        interpret=True)
    want = np.asarray(run(jnp.asarray(pts), jnp.asarray(tape),
                          jnp.asarray(s)))
    got = kernels.tape(torch.from_numpy(pts.copy()), tape,
                       torch.from_numpy(s), td)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fold_chain_prefix_apply_plain_match_pallas_interpret():
    """K2, K3, K4's plain versions on M89 = 2^89 - 1 at B=128, count 6:
    digits equal the Pallas executors' in interpret mode."""
    _chain_prefix_apply(params.make_monty((1 << 89) - 1, mersenne=(89, 1)))


def test_fold_replay_plain_matches_pallas_stream_mod_m():
    """K5's plain version on M61 against the Pallas stream replay: equal
    mod M to it and to the sequential jnp product."""
    _replay(_m61())


def test_fold_stage2_runner_matches_jax_runner():
    """The port's Stage2Runner against the JAX CPU runner in fold mode on
    M101 = 2^101 - 1 (sigma 500-503, B1=300, B2=5000): canonical acc, Pb
    table, factors and counters equal."""
    _runners(params.make_monty((1 << 101) - 1, mersenne=(101, 1)),
             range(500, 504), 300, 5000)
