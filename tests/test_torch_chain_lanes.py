"""K2's CUDA source run on the CPU (no card needed).

csrc/chain.cu runs K2, the stage-2 differential-add chain, on the lane
core csrc/arith_lanes.cuh: L lanes per curve, the running pair and Pd's
sum and difference in shared-memory slots for the whole launch, each row
three paired product steps whose last writes the new point over the
previous one's slots, so that the two programs K2_A and K2_B alternate.
tools/lane_shim builds its kernel body with g++ against a CPU stand-in of
the CUDA runtime (a std::thread per CUDA thread, shuffles through a
per-warp buffer).  Each case holds the kernel body digit for digit against
kernels.chain_plain on CPU tensors: REDC at nw = 36 with norm_inputs on
and off, Mersenne and pseudo-Mersenne folds (M127, 2^200 - c, M1277 at 16
lanes of 8 digits, c = -1), counts 1, 2, 3 and past 3 (the last row on
either program), batches that leave their last block part empty; and
once, on a real stage-2 state handed across by convert.py, against
tpu_ecm's Pallas chain executor in interpret mode.
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
from tpu_ecm.curve import ops as j_ops  # noqa: E402
from tpu_ecm.curve import suyama  # noqa: E402
from tpu_ecm.limbs import jnp_ops, layout, pallas_ops  # noqa: E402
from tpu_ecm_torch import convert, params  # noqa: E402
from tpu_ecm_torch.limbs import kernels, torch_ops  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
N64 = 2545580083 * 2551628647


def _lane_shim():
    """tools/lane_shim/check.py, loaded by path (tools is no package)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K2's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chain_cases_cover_the_edges():
    """The shim's K2 cases: REDC with norm_inputs on and off, a Mersenne
    (c = 1), a pseudo-Mersenne (|c| of several digits) and a c = -1 fold,
    M1277's nw = 118 at 16 lanes of 8 digits; counts 1, 2, 3, an even and
    an odd count past 3; every batch leaves its last block part empty, at
    most 64 curves and 8 rows."""
    shim = _lane_shim()
    kinds, nws, counts = set(), set(), set()
    for n, mers, w, b, lanes, count in shim.CHAIN_CASES:
        ctx = params.make_monty(n, mersenne=mers, force_w=w)
        nws.add(ctx.p.nw)
        counts.add(count)
        if mers is None:
            kinds.add(f"norm={ctx.p.norm_inputs}")
        else:
            kinds.add({1: "c=1", -1: "c=-1"}.get(mers[1], "c>1"))
        geometry = kernels.tape_geometry(ctx.p.nw, b)
        if ctx.p.nw == 118:
            assert geometry[:2] == (16, 8)
        per_block = kernels.TAPE_BLOCK // (lanes or geometry[0])
        assert b % per_block, "every case leaves its last block part empty"
        assert b <= 64 and count <= 8
    assert {"norm=True", "norm=False", "c=1", "c>1", "c=-1"} <= kinds
    assert {36, 118} <= nws
    assert {1, 2, 3} <= counts
    assert any(c > 3 and c % 2 == 0 for c in counts)
    assert any(c > 3 and c % 2 == 1 for c in counts)


@pytest.mark.parametrize("case", range(6))
def test_chain_source_on_cpu(case):
    """csrc/chain.cu's kernel body, built by g++ through tools/lane_shim,
    equals kernels.chain_plain digit for digit."""
    shim = _lane_shim()
    assert len(shim.CHAIN_CASES) == 6
    n, mers, force_w, b, lanes, count = shim.CHAIN_CASES[case]
    lib = shim.load(shim.build_lib())
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    results = shim.compare_chain(lib, ctx, b, count, lanes, seed=case)
    assert len(results) == 1 and all(ok for _what, ok in results), results


def test_chain_source_matches_jax():
    """On a real stage-2 state (N64, 128 Suyama curves from sigma 5000,
    q1 their points and q2 = 2*q1, as tests/test_torch_stage2.py builds
    them) handed across by convert.py, csrc/chain.cu's kernel body chains 5
    rows from (q2, q1) with difference q1 equal to tpu_ecm's Pallas
    make_chain_executor in interpret mode and to the plain K2, digit for
    digit."""
    shim = _lane_shim()
    jctx, tctx = j_params.make_monty(N64), params.make_monty(N64)
    b, count = 128, 5
    p = jctx.p
    cs = [suyama.build_one_curve(jctx, 5000 + i) for i in range(b)]
    q1 = np.stack([layout.pack_batch([c.x_mont for c in cs], p.w, p.nw),
                   layout.pack_batch([c.z_mont for c in cs], p.w, p.nw)])
    s = jnp.asarray(layout.pack_batch([c.s_mont for c in cs], p.w, p.nw))
    q2 = np.stack(jax.jit(j_ops.xdbl)(jnp.asarray(q1[0]), jnp.asarray(q1[1]),
                                      s, jnp_ops.device_ctx(jctx)))
    want = np.asarray(pallas_ops.make_chain_executor(
        jctx, b, count, interpret=True)(jnp.asarray(q2), jnp.asarray(q1),
                                        jnp.asarray(q1)))
    p1, p2, pd = (convert.planes(a, tctx.p, "cpu") for a in (q2, q1, q1))
    d = torch_ops.device_ctx(tctx, "cpu")
    lanes, digits, _per, _blocks = kernels.tape_geometry(tctx.p.nw, b)
    got = shim.run_chain(shim.load(shim.build_lib()), d, p1, p2, pd, count,
                         lanes, digits)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, kernels.chain_plain(p1, p2, pd, count, d))
