"""Stage 2 of the PyTorch port held against the JAX package: the plain
versions of K2-K4 bit-identical to the Pallas chain / prefix /
apply-inverse kernels in interpret mode, the plain K5 equal to the Pallas
stream replay mod n, and the port's Stage2Runner equal to the JAX CPU
runner on the same stage-1 point, handed across through convert.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpu_ecm import params  # noqa: E402
from tpu_ecm import stage1 as j_stage1  # noqa: E402
from tpu_ecm.curve import ops as j_ops  # noqa: E402
from tpu_ecm.curve import suyama  # noqa: E402
from tpu_ecm.limbs import jnp_ops, layout, pallas_ops  # noqa: E402
from tpu_ecm.primes import PrimeStream, primes_range  # noqa: E402
from tpu_ecm.stage2 import exec as j_exec  # noqa: E402
from tpu_ecm.stage2 import plan as j_plan  # noqa: E402
from tpu_ecm_torch import convert  # noqa: E402
from tpu_ecm_torch.limbs import kernels, torch_ops  # noqa: E402
from tpu_ecm_torch.stage2 import exec as t_exec  # noqa: E402
from tpu_ecm_torch.stage2 import plan as t_plan  # noqa: E402

torch.set_num_threads(1)

N64 = 2545580083 * 2551628647
N71 = 34359738421 * 68719476767


def _t(a):
    return torch.from_numpy(np.array(a))


def test_chain_prefix_apply_plain_match_pallas_interpret():
    """K2, K3, K4 on CPU tensors (their plain versions) against the Pallas
    executors in interpret mode at N64, B=128, count 6: digits equal."""
    ctx = params.make_monty(N64)
    jd, td = jnp_ops.device_ctx(ctx), torch_ops.device_ctx(ctx, "cpu")
    b, k = 128, 6
    p = ctx.p
    cs = [suyama.build_one_curve(ctx, 5000 + i) for i in range(b)]
    q1 = np.stack([layout.pack_batch([c.x_mont for c in cs], p.w, p.nw),
                   layout.pack_batch([c.z_mont for c in cs], p.w, p.nw)])
    s = jnp.asarray(layout.pack_batch([c.s_mont for c in cs], p.w, p.nw))
    q2 = np.stack(jax.jit(j_ops.xdbl)(jnp.asarray(q1[0]), jnp.asarray(q1[1]),
                                      s, jd))
    one = layout.broadcast_int(ctx.r_mod_n, p.w, p.nw, b)

    want = np.asarray(pallas_ops.make_chain_executor(
        ctx, b, k, interpret=True)(jnp.asarray(q2), jnp.asarray(q1),
                                   jnp.asarray(q1)))
    kernels.reset_launches()
    got = kernels.chain(_t(q2), _t(q1), _t(q1), k, td)
    np.testing.assert_array_equal(got.numpy(), want)

    xs, zs = np.ascontiguousarray(want[:, 0]), np.ascontiguousarray(want[:, 1])
    want_pre = np.asarray(pallas_ops.make_prefix_executor(
        ctx, b, k, interpret=True)(jnp.asarray(zs), jnp.asarray(one)))
    got_pre = kernels.prefix(_t(zs), _t(one), td)
    np.testing.assert_array_equal(got_pre.numpy(), want_pre)

    inv_ints, found = t_exec.host_batch_inverse(
        ctx, layout.unpack_batch(want_pre[-1], p.w))
    assert not found
    tinv = layout.pack_batch(inv_ints, p.w, p.nw)
    pres = np.concatenate([one[None], want_pre[:-1]])
    want_app = np.asarray(pallas_ops.make_apply_inverse_executor(
        ctx, b, k, interpret=True)(jnp.asarray(xs), jnp.asarray(zs),
                                   jnp.asarray(pres), jnp.asarray(tinv)))
    got_app = kernels.apply_inverse(_t(xs), _t(zs), _t(pres), _t(tinv), td)
    np.testing.assert_array_equal(got_app.numpy(), want_app)
    assert sum(kernels.launches.values()) == 0


def test_replay_plain_matches_pallas_stream_mod_n():
    """K5 on CPU tensors against the Pallas stream replay at its default
    tree=4, in the pattern of tests/test_stage2.py:417: v-sorted entries
    with unequal runs and trailing pads, live counts T-2 and T; values
    equal mod n to each other and to the sequential jnp product."""
    ctx = params.make_monty(N64)
    jd, td = jnp_ops.device_ctx(ctx), torch_ops.device_ctx(ctx, "cpu")
    p = ctx.p
    n, b = N64, 128
    rng = np.random.default_rng(5)
    PA, PB, T = 17, 9, 16

    def mk(rows):
        return np.stack([layout.pack_batch(
            [int(v) for v in rng.integers(0, n, b, dtype=np.uint64)], p.w,
            p.nw) for _ in range(rows)])

    pa, pb = mk(PA), mk(PB)
    pa[-1] = layout.broadcast_int(ctx.r_mod_n, p.w, p.nw, b)
    pb[0] = 0
    acc0 = mk(1)[0]
    pav = np.sort(rng.integers(0, PA - 1, T - 2))
    idx = np.stack([np.concatenate([pav, [PA - 1, PA - 1]]),
                    np.concatenate([rng.integers(1, PB, T - 2), [0, 0]])],
                   1).astype(np.int32)
    acc = jnp.asarray(acc0)
    for v, u in idx.tolist()[:T - 2]:
        acc = jnp_ops.mulmod(acc, jnp.asarray(pa[v] - pb[u]), jd)
    ref = [x % n for x in layout.unpack_batch(np.asarray(acc), p.w)]
    packed = ((idx[:, 0] << 16) | idx[:, 1]).astype(np.int32)
    run = pallas_ops.make_replay_stream_executor(
        ctx, b, PA, PB, t_block=T, n_buffers=4, tree=4, interpret=True)
    for count in (T - 2, T):
        flat = np.concatenate([[count], packed]).astype(np.int32)
        want = layout.unpack_batch(np.asarray(run(
            jnp.asarray(acc0), jnp.asarray(pa), jnp.asarray(pb),
            jnp.asarray(flat))), p.w)
        got = layout.unpack_batch(kernels.replay(
            _t(acc0), _t(pa), _t(pb), flat, td).numpy(), p.w)
        assert [x % n for x in got] == [x % n for x in want] == ref, count


def _stage1_point(ctx, sigmas, b1):
    """The JAX package's stage-1 state for Suyama curves (jnp replay)."""
    jd = jnp_ops.device_ctx(ctx)
    cs = [suyama.build_one_curve(ctx, s) for s in sigmas]
    state = j_stage1.init_state(ctx, [c.x_mont for c in cs],
                                [c.z_mont for c in cs],
                                [c.s_mont for c in cs])
    for _chunk, state in j_stage1.run_stage1(state, jd, b1, PrimeStream()):
        pass
    return np.asarray(state.pts), np.asarray(state.s_const)


@pytest.mark.parametrize("group", [None, 64])
def test_stage2_runner_matches_jax_runner(monkeypatch, group):
    """The port's Stage2Runner on CPU against tpu_ecm's on the same stage-1
    point (N71, sigma 110-117, B1=300, B2=10000; the sigma-112 curve finds
    P35 in stage 2): canonical acc and Pb table, factors, paired, ptadds,
    ptdups and numinv equal, with the default Pa group and with 64-row
    groups on both sides."""
    if group:
        monkeypatch.setenv("TPU_ECM_PA_GROUP", str(group))
        monkeypatch.setitem(t_exec.PA_GROUP, "cpu", group)
    ctx = params.make_monty(N71)
    b1, b2 = 300, 10000
    pts, s_const = _stage1_point(ctx, range(110, 118), b1)
    primes = primes_range(b1, b2 + 1000)

    jd = jnp_ops.device_ctx(ctx)
    sp_j = j_plan.make_stage2_params(b1, b2)
    jr = j_exec.Stage2Runner(ctx, jd, sp_j, jnp.asarray(pts[0]),
                             jnp.asarray(s_const), b1)
    jr.init()
    jr.run_chunk(*j_plan.pair(sp_j, primes, b1, b2)[:3])
    want = jr.result()

    tdc = convert.device_ctx(np.asarray(jd.n), np.asarray(jd.c), jd.p,
                             jd.nprime, jd.mersenne_e, jd.mersenne_c_sign,
                             "cpu")
    state = convert.stage1_state(pts, s_const, ctx.p, "cpu")
    sp_t = t_plan.make_stage2_params(b1, b2)
    tr = t_exec.Stage2Runner(ctx, tdc, sp_t, state.pts[0], state.s_const)
    tr.init()
    tr.run_chunk(*t_plan.pair(sp_t, primes, b1, b2)[:3])
    got = tr.result()

    assert got.acc == want.acc
    assert got.factors == want.factors
    assert (got.paired, got.ptadds, got.ptdups, got.numinv) == (
        want.paired, want.ptadds, want.ptdups, want.numinv)
    n = ctx.n_int
    jt = convert.planes(np.asarray(jr.pbx), ctx.p, "cpu")
    for row in range(sp_t.num_pb):
        assert [v % n for v in layout.unpack_batch(tr.pbx[row].numpy(),
                                                   ctx.p.w)] \
            == [v % n for v in layout.unpack_batch(jt[row].numpy(),
                                                   ctx.p.w)], row
    # the sigma-112 curve's accumulator shares P35 with n
    import math
    assert math.gcd(got.acc[2], n) == 34359738421


def test_convert_checks_layout():
    ctx = params.make_monty(N64)
    jd = jnp_ops.device_ctx(ctx)
    tdc = convert.device_ctx(np.asarray(jd.n), np.asarray(jd.c), jd.p,
                             jd.nprime, jd.mersenne_e, jd.mersenne_c_sign,
                             "cpu")
    ref = torch_ops.device_ctx(ctx, "cpu")
    assert torch.equal(tdc.n, ref.n) and tdc.nprime == ref.nprime
    nw = ctx.p.nw
    acc = np.zeros((nw, 4), np.int32)
    assert convert.planes(acc, ctx.p, "cpu").shape == (nw, 4)
    with pytest.raises(ValueError):
        convert.planes(acc.astype(np.int64), ctx.p, "cpu")
    with pytest.raises(ValueError):
        convert.planes(np.zeros((nw + 1, 4), np.int32), ctx.p, "cpu")
    with pytest.raises(ValueError):
        convert.stage1_state(np.zeros((5, 2, nw, 4), np.int32), acc, ctx.p,
                             "cpu")
