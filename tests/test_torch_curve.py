"""Curve layer of the PyTorch port held against the JAX package: point
operations and the stage-1 tape replay bit-identical to tpu_ecm.curve.ops
and to the Pallas tape kernel in interpret mode, and the JAX-free copies of
the host planners (prac, suyama, layout, stage2.plan) equal to their
originals."""

from dataclasses import astuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpu_ecm import params  # noqa: E402
from tpu_ecm.curve import ops as j_ops  # noqa: E402
from tpu_ecm.curve import prac as j_prac  # noqa: E402
from tpu_ecm.curve import suyama as j_suyama  # noqa: E402
from tpu_ecm.limbs import jnp_ops, pallas_ops  # noqa: E402
from tpu_ecm.limbs import layout as j_layout  # noqa: E402
from tpu_ecm.primes import primes_range  # noqa: E402
from tpu_ecm.stage2 import plan as j_plan  # noqa: E402
from tpu_ecm_torch.curve import ops as t_ops  # noqa: E402
from tpu_ecm_torch.curve import prac as t_prac  # noqa: E402
from tpu_ecm_torch.curve import suyama as t_suyama  # noqa: E402
from tpu_ecm_torch.limbs import kernels, torch_ops  # noqa: E402
from tpu_ecm_torch.limbs import layout as t_layout  # noqa: E402
from tpu_ecm_torch.stage2 import plan as t_plan  # noqa: E402

from moduli import N416  # noqa: E402

torch.set_num_threads(1)

N64 = 2545580083 * 2551628647


def _curve_file(ctx, b, sigma0=100):
    """[6, 2, NW, B] point file with the Suyama start points in slot 0
    and mulmod outputs in the other slots, plus the s_const plane."""
    p = ctx.p
    cs = [j_suyama.build_one_curve(ctx, sigma0 + i) for i in range(b)]
    rng = np.random.default_rng(sigma0)
    pts = np.zeros((6, 2, p.nw, b), dtype=np.int32)
    pts[0, 0] = j_layout.pack_batch([c.x_mont for c in cs], p.w, p.nw)
    pts[0, 1] = j_layout.pack_batch([c.z_mont for c in cs], p.w, p.nw)
    for s in range(1, 6):
        vals = [int.from_bytes(rng.bytes(p.nbits // 8 + 8), "little")
                % ctx.n_int for _ in range(2 * b)]
        pts[s, 0] = j_layout.pack_batch(vals[:b], p.w, p.nw)
        pts[s, 1] = j_layout.pack_batch(vals[b:], p.w, p.nw)
    s_const = j_layout.pack_batch([c.s_mont for c in cs], p.w, p.nw)
    return pts, s_const


@pytest.mark.parametrize("n", [pytest.param(N64, id="N64"),
                               pytest.param(N416, id="N416")])
def test_xdbl_xadd_bitexact(n):
    ctx = params.make_monty(n)
    jd, td = jnp_ops.device_ctx(ctx), torch_ops.device_ctx(ctx, "cpu")
    pts, s = _curve_file(ctx, 8)
    j = jnp.asarray(pts)
    t = torch.from_numpy(pts)
    want = jax.jit(j_ops.xdbl)(j[0, 0], j[0, 1], jnp.asarray(s), jd)
    got = t_ops.xdbl(t[0, 0], t[0, 1], torch.from_numpy(s), td)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jax.jit(j_ops.xadd)(j[1, 0], j[1, 1], j[2, 0], j[2, 1], j[3, 0],
                               j[3, 1], jd)
    got = t_ops.xadd(t[1, 0], t[1, 1], t[2, 0], t[2, 1], t[3, 0], t[3, 1],
                     td)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_run_tape_bitexact():
    """Every slot of the register file after a real stage-1 tape (plus NOP,
    self-aliasing ADD and DUP entries) equals tpu_ecm.curve.ops.run_tape."""
    ctx = params.make_monty(N64)
    jd, td = jnp_ops.device_ctx(ctx), torch_ops.device_ctx(ctx, "cpu")
    pts, s = _curve_file(ctx, 16)
    tape = np.concatenate([
        t_prac.stage1_tape(primes_range(0, 60), 60),
        [[2, 5, 0, 0, 0], [1, 3, 3, 3, 3], [0, 2, 2, 0, 0]]]).astype(np.int32)
    want = jax.jit(j_ops.run_tape)(jnp.asarray(pts), jnp.asarray(tape),
                                   jnp.asarray(s), jd)
    got = t_ops.run_tape(torch.from_numpy(pts.copy()), tape,
                         torch.from_numpy(s), td)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tape_kernel_plain_matches_pallas_interpret():
    """The plain version of K1 (what kernels.tape runs for CPU tensors) is
    bit-identical to the Pallas _tape_kernel in interpret mode, in the
    setting of tests/test_pallas.py (N64, B=128, B1=40, chunk=16).  The
    Pallas executor pads to whole chunks with NOPs that write slot 5, so
    slots 0-4 are compared."""
    ctx = params.make_monty(N64)
    td = torch_ops.device_ctx(ctx, "cpu")
    pts, s = _curve_file(ctx, 128)
    pts[1:] = 0
    tape = t_prac.stage1_tape(primes_range(0, 40), 40)
    run = pallas_ops.make_tape_executor(ctx, 128, chunk=16, interpret=True)
    want = np.asarray(run(jnp.asarray(pts), jnp.asarray(tape),
                          jnp.asarray(s)))
    kernels.reset_launches()
    got = kernels.tape(torch.from_numpy(pts.copy()), tape,
                       torch.from_numpy(s), td)
    np.testing.assert_array_equal(got.numpy()[:5], want[:5])
    assert kernels.launches["tape"] == 0      # CPU tensors: plain version


@pytest.mark.parametrize("b1", [40, 2000, 100_000])
def test_prac_copy_bit_equal(b1):
    primes = primes_range(0, b1)
    for native in (True, False):
        if b1 > 2000 and not native:
            continue
        np.testing.assert_array_equal(
            t_prac.stage1_tape(primes, b1, allow_native=native),
            j_prac.stage1_tape(primes, b1, allow_native=native))
    for k in (1, 2, 3, 7, 2310, 4619):
        t_tape, t_res = t_prac.ladder_tape_result_slot(k)
        j_tape, j_res = j_prac.ladder_tape_result_slot(k)
        np.testing.assert_array_equal(t_tape, j_tape)
        assert t_res == j_res
        t_pair, j_pair = t_prac.ladder_pair_tape(k), j_prac.ladder_pair_tape(k)
        np.testing.assert_array_equal(t_pair[0], j_pair[0])
        assert t_pair[1:] == j_pair[1:]
    assert (t_ops.OP_DUP, t_ops.OP_ADD, t_ops.OP_NOP, t_ops.NUM_SLOTS) == (
        j_ops.OP_DUP, j_ops.OP_ADD, j_ops.OP_NOP, j_ops.NUM_SLOTS)


def test_suyama_and_layout_copies_equal():
    for n in (N64, N416):
        ctx = params.make_monty(n)
        for sigma in range(7000, 7016):
            assert astuple(t_suyama.build_one_curve(ctx, sigma)) \
                == astuple(j_suyama.build_one_curve(ctx, sigma))
        p = ctx.p
        rng = np.random.default_rng(7)
        vals = [int.from_bytes(rng.bytes(p.nbits // 8), "little")
                for _ in range(9)]
        np.testing.assert_array_equal(t_layout.pack_batch(vals, p.w, p.nw),
                                      j_layout.pack_batch(vals, p.w, p.nw))
        planes = j_layout.pack_batch(vals, p.w, p.nw) - 5
        assert t_layout.unpack_batch(planes, p.w) \
            == j_layout.unpack_batch(planes, p.w)
        np.testing.assert_array_equal(
            t_layout.broadcast_int(ctx.r_mod_n, p.w, p.nw, 4),
            j_layout.broadcast_int(ctx.r_mod_n, p.w, p.nw, 4))
    # a build that hits a factor raises in both (gcd(u, 15) = 5 at sigma 5)
    ctx = params.make_monty(15)
    with pytest.raises(t_suyama.FactorFoundDuringBuild):
        t_suyama.build_one_curve(ctx, 5)
    with pytest.raises(j_suyama.FactorFoundDuringBuild):
        j_suyama.build_one_curve(ctx, 5)


@pytest.mark.parametrize("b1,b2,nw,batch", [
    (300, 10000, None, None), (2000, 200000, None, None),
    (100_000, 10_000_000, 36, 2048), (1_000_000, 100_000_000, 27, 128)])
def test_stage2_plan_copy_equal(b1, b2, nw, batch):
    tp = t_plan.make_stage2_params(b1, b2, nw=nw, batch=batch)
    jp = j_plan.make_stage2_params(b1, b2, nw=nw, batch=batch)
    for f in ("D", "U", "L", "R", "umax", "amin0", "num_pb", "qmap",
              "qrmap"):
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(tp.rprime_map, jp.rprime_map)
    hi = min(b2, 300_000)
    primes = primes_range(b1, hi + 1000)
    for native in (True, False):
        tv, tu, ta, ts = t_plan.pair(tp, primes, b1, hi, allow_native=native)
        jv, ju, ja, js = j_plan.pair(jp, primes, b1, hi, allow_native=native)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tu, ju)
        assert (ta, ts) == (ja, js)


def test_wrappers_check_inputs():
    """The kernel wrappers reject what a kernel would misread: bad tape
    opcodes or slots, wrong dtype, shape or layout, replay entries outside
    the tables."""
    ctx = params.make_monty(N64)
    td = torch_ops.device_ctx(ctx, "cpu")
    nw, b = ctx.p.nw, 4
    pts = torch.zeros((6, 2, nw, b), dtype=torch.int32)
    s = torch.zeros((nw, b), dtype=torch.int32)
    for bad in ([[0, 6, 0, 0, 0]], [[3, 1, 0, 0, 0]], [[1, 1, 0, -1, 0]]):
        with pytest.raises(ValueError, match="tape"):
            kernels.tape(pts, np.asarray(bad, np.int32), s, td)
    with pytest.raises(ValueError, match="int32"):
        kernels.tape(pts.long(), np.zeros((1, 5), np.int32), s, td)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.prefix(torch.zeros((b, nw, 3), dtype=torch.int32)
                       .transpose(0, 2), s, td)
    with pytest.raises(ValueError, match="shape"):
        kernels.chain(pts[0], pts[1], pts[2, :, :-1], 3, td)
    with pytest.raises(ValueError, match="count"):
        kernels.chain(pts[0], pts[1], pts[2], 0, td)
    tab = torch.zeros((3, nw, b), dtype=torch.int32)
    with pytest.raises(ValueError, match="live count"):
        kernels.replay(s, tab, tab, np.asarray([2, 0], np.int32), td)
    with pytest.raises(ValueError, match="outside"):
        kernels.replay(s, tab, tab, np.asarray([1, 3 << 16], np.int32), td)
    with pytest.raises(ValueError, match="outside"):
        kernels.replay(s, tab, tab, np.asarray([1, 3], np.int32), td)
