"""K3's and K4's CUDA source run on the CPU (no card needed).

csrc/batch_inverse.cu runs K3 (prefix products) and K4 (the suffix walk
that applies the batch inverse) on the lane core csrc/arith_lanes.cuh: L
lanes per curve, the running product in a shared-memory slot for the
whole launch, the next rows' planes cp.async'd into spare slots.  K3 forms
one product a row, in a step of its own; K4's
three products a row run as one stream of paired steps, two rows in three
steps.  tools/lane_shim builds both kernel bodies with g++ against a CPU
stand-in of the CUDA runtime (a std::thread per CUDA thread, shuffles
through a per-warp buffer, cp.async copies landing at once or at their
wait).  Each case holds them digit for digit against kernels.prefix_plain
and kernels.apply_inverse_plain on CPU tensors: REDC at nw = 36 with
norm_inputs on and off, Mersenne and pseudo-Mersenne folds (M127,
2^200 - c, M1277 at 16 lanes of 8 digits, c = -1), counts 1, 2, 3, 4, 5
and 8 (K4's last row on either parity of its step pairs), batches that
leave their last block part empty; and once, on a real stage-2 state
handed across by convert.py, against tpu_ecm's Pallas prefix and
apply-inverse executors in interpret mode.
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
from tpu_ecm_torch.stage2 import exec as t_exec  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
N64 = 2545580083 * 2551628647


def _lane_shim():
    """tools/lane_shim/check.py, loaded by path (tools is no package)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K3's and K4's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_batch_inverse_cases_cover_the_edges():
    """The shim's K3 and K4 cases: REDC with norm_inputs on and off, a
    Mersenne (c = 1), a pseudo-Mersenne (|c| of several digits) and a
    c = -1 fold, M1277's nw = 118 at 16 lanes of 8 digits; counts 1-5 and
    8, so K4's last row lands on either parity of its step pairs and its
    copies cross the last row at every position; every batch leaves its
    last block part empty, at most 64 curves."""
    shim = _lane_shim()
    kinds, nws = set(), set()
    for n, mers, w, b, lanes in shim.BATCH_CASES:
        ctx = params.make_monty(n, mersenne=mers, force_w=w)
        nws.add(ctx.p.nw)
        if mers is None:
            kinds.add(f"norm={ctx.p.norm_inputs}")
        else:
            kinds.add({1: "c=1", -1: "c=-1"}.get(mers[1], "c>1"))
        geometry = kernels.tape_geometry(ctx.p.nw, b)
        if ctx.p.nw == 118:
            assert geometry[:2] == (16, 8)
        per_block = kernels.TAPE_BLOCK // (lanes or geometry[0])
        assert b % per_block, "every case leaves its last block part empty"
        assert b <= 64
    assert {"norm=True", "norm=False", "c=1", "c>1", "c=-1"} <= kinds
    assert {36, 118} <= nws
    assert set(shim.BATCH_COUNTS) == {1, 2, 3, 4, 5, 8}


@pytest.mark.parametrize("case", range(6))
def test_batch_inverse_source_on_cpu(case):
    """csrc/batch_inverse.cu's kernel bodies, built by g++ through
    tools/lane_shim, equal kernels.prefix_plain (K3) and
    kernels.apply_inverse_plain (K4) digit for digit at every count of BATCH_COUNTS, their copies landing at
    once and at their wait."""
    shim = _lane_shim()
    assert len(shim.BATCH_CASES) == 6
    n, mers, force_w, b, lanes = shim.BATCH_CASES[case]
    lib = shim.load(shim.build_lib())
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    results = []
    for count in shim.BATCH_COUNTS:
        results += shim.compare_batch_inverse(lib, ctx, b, count, lanes,
                                              seed=case + count)
    assert len(results) == 4 * len(shim.BATCH_COUNTS)
    assert all(ok for _what, ok in results), [r for r in results
                                              if not r[1]]


def test_batch_inverse_source_matches_jax():
    """On a real stage-2 state (N64, 128 Suyama curves from sigma 5000,
    q1 their points, q2 = 2*q1, and 5 chain rows from (q2, q1) with
    difference q1 by tpu_ecm's Pallas chain executor, as tests/
    test_torch_stage2.py builds them) handed across by convert.py,
    csrc/batch_inverse.cu's kernel bodies equal tpu_ecm's Pallas
    make_prefix_executor and make_apply_inverse_executor in interpret mode
    and the plain K3 and K4, digit for digit, with the total's inverse
    from the host's one modinv."""
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
    rows = np.asarray(pallas_ops.make_chain_executor(
        jctx, b, count, interpret=True)(jnp.asarray(q2), jnp.asarray(q1),
                                        jnp.asarray(q1)))
    xs, zs = np.ascontiguousarray(rows[:, 0]), np.ascontiguousarray(rows[:, 1])
    one = layout.broadcast_int(jctx.r_mod_n, p.w, p.nw, b)
    want_pre = np.asarray(pallas_ops.make_prefix_executor(
        jctx, b, count, interpret=True)(jnp.asarray(zs), jnp.asarray(one)))
    inv_ints, found = t_exec.host_batch_inverse(
        tctx, layout.unpack_batch(want_pre[-1], p.w))
    assert not found
    tinv = layout.pack_batch(inv_ints, p.w, p.nw)
    pres = np.concatenate([one[None], want_pre[:-1]])
    want_app = np.asarray(pallas_ops.make_apply_inverse_executor(
        jctx, b, count, interpret=True)(jnp.asarray(xs), jnp.asarray(zs),
                                        jnp.asarray(pres),
                                        jnp.asarray(tinv)))

    d = torch_ops.device_ctx(tctx, "cpu")
    t_xs, t_zs, t_pres = (convert.planes(a, tctx.p, "cpu")
                          for a in (xs, zs, pres))
    t_one, t_tinv = (convert.planes(a, tctx.p, "cpu") for a in (one, tinv))
    lanes, digits, _per, _blocks = kernels.tape_geometry(tctx.p.nw, b)
    lib = shim.load(shim.build_lib())
    got = shim.run_prefix(lib, d, t_zs, t_one, lanes, digits, 1)
    np.testing.assert_array_equal(got.numpy(), want_pre)
    assert torch.equal(got, kernels.prefix_plain(t_zs, t_one, d))
    got = shim.run_apply_inverse(lib, d, t_xs, t_zs, t_pres, t_tinv, lanes,
                                 digits, 1)
    np.testing.assert_array_equal(got.numpy(), want_app)
    assert torch.equal(got, kernels.apply_inverse_plain(t_xs, t_zs, t_pres,
                                                        t_tinv, d))


def test_batch_inverse_source_has_lane_kernels_only():
    """csrc/batch_inverse.cu launches K3 and K4 only through launch_lanes,
    the lane core's launcher (no one-thread kernel beside them)."""
    from tpu_ecm_torch.limbs import build
    with open(os.path.join(build.CSRC, "batch_inverse.cu")) as f:
        src = f.read()
    for kernel in ("prefix_lanes_kernel", "apply_inverse_lanes_kernel"):
        assert f"launch_lanes<D>({kernel}<D>" in src
