"""The RNS engine of the PyTorch port held against the JAX package on the
CPU: host tables and every RnsCtx field equal make_rns's, the plain
mont_mul/add/sub bitwise equal to rns.mont_mul/add/sub on both of JAX's dot
paths (direct and 7-bit split), the plain K10 equal to rns_exec.run_tape,
the plain K11-K13 and K15 equal to the Pallas kernels in interpret mode
(K15 also to replay_segment mod n), the RNS Stage2Runner equal to JAX's,
and the driver's RNS runs: finds, residues and savefile bytes.  Inputs are
made from numpy seeds; tolerance 0 except where "mod n" is said."""

import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm import params  # noqa: E402
from tpu_ecm.curve import prac as j_prac  # noqa: E402
from tpu_ecm.curve import suyama  # noqa: E402
from tpu_ecm.limbs import jnp_ops  # noqa: E402
from tpu_ecm.limbs import rns as j_rns  # noqa: E402
from tpu_ecm.limbs import rns_exec as j_exec  # noqa: E402
from tpu_ecm.primes import primes_range  # noqa: E402
from tpu_ecm.stage2 import exec as j_s2  # noqa: E402
from tpu_ecm.stage2 import plan as j_plan  # noqa: E402
from tpu_ecm_torch import convert, driver  # noqa: E402
from tpu_ecm_torch.limbs import kernels, rns, rns_kernels  # noqa: E402
from tpu_ecm_torch.stage2 import exec as t_s2  # noqa: E402
from tpu_ecm_torch.stage2 import plan as t_plan  # noqa: E402

from moduli import N256  # noqa: E402

torch.set_num_threads(1)

P35, P36 = 34359738421, 68719476767
N71 = P35 * P36
# P35 * P1500: K=120 > 16, so JAX takes the 7-bit split dot as at N256
N1535 = P35 * chip_smoke._prp(random.Random(5), 1500)
MODULI = {"N71": N71, "N256": N256, "N1535": N1535}


def _hosts(n):
    ctx = params.make_monty(n)
    return ctx, j_rns.make_rns(ctx, cw=13), rns.make_rns(ctx, cw=13)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand_planes(rng, host, shape):
    """Consistent residues of random values mod n (Montgomery domain):
    [*shape, rows, B] int32."""
    n = host.ctx.n_int
    *lead, b = shape
    out = np.empty(tuple(lead) + (host.rows, b), dtype=np.int32)
    for ix in np.ndindex(*lead):
        out[ix] = host.pack([int.from_bytes(rng.bytes(48), "little") % n
                             for _ in range(b)])
    return out


@pytest.mark.parametrize("name", list(MODULI))
def test_host_tables_equal_jax(name):
    ctx, hj, ht = _hosts(MODULI[name])
    assert (ht.K, ht.pa, ht.pb, ht.P, ht.Q, ht.mr, ht.V) \
        == (hj.K, hj.pa, hj.pb, hj.P, hj.Q, hj.mr, hj.V)
    assert ht.mr_shift == hj.dev.mr_shift and ht.rows == hj.dev.rows
    rc = rns.device_ctx(ht, "cpu")
    for field in rns.TABLES:
        want = np.asarray(getattr(hj.dev, field))
        if field == "p":                    # JAX pads one copy of m_r
            want = want[:-1]
        np.testing.assert_array_equal(getattr(rc, field).numpy(), want,
                                      err_msg=field)
    assert hj.dev.use_split == (name != "N71")


@pytest.mark.parametrize("name", list(MODULI))
def test_mont_mul_add_sub_equal_jax(name):
    """Bitwise, on consistent residues of random values; N71 takes JAX's
    direct int32 dot, N256 and N1535 its 7-bit split dot."""
    ctx, hj, ht = _hosts(MODULI[name])
    rc = rns.device_ctx(ht, "cpu")
    rng = np.random.default_rng(3)
    x, y = (_rand_planes(rng, ht, (32,)) for _ in range(2))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    for jf, tf in ((j_rns.mont_mul, rns.mont_mul), (j_rns.add, rns.add),
                   (j_rns.sub, rns.sub)):
        np.testing.assert_array_equal(tf(_t(x), _t(y), rc).numpy(),
                                      np.asarray(jf(jx, jy, hj.dev)))


def _curves_state(ctx, hj, sigmas):
    cs = [suyama.build_one_curve(ctx, s) for s in sigmas]
    conv = ctx.from_mont_int
    return j_exec.init_state(hj, [conv(c.x_mont) for c in cs],
                             [conv(c.z_mont) for c in cs],
                             [conv(c.s_mont) for c in cs])


def test_run_tape_plain_equals_jax():
    """K10's plain version against rns_exec.run_tape on a 60-op stage-1
    tape at N256 (split dot), 8 curves: the register file bitwise."""
    ctx, hj, ht = _hosts(N256)
    rc = rns.device_ctx(ht, "cpu")
    pts, sc = _curves_state(ctx, hj, range(9000, 9008))
    tape = j_prac.stage1_tape(primes_range(0, 200), 200)[:60]
    want = jax.jit(j_exec.run_tape)(jnp.asarray(pts), jnp.asarray(tape),
                                    jnp.asarray(sc), hj.dev)
    kernels.reset_launches()
    got = rns_kernels.tape(_t(pts), tape, _t(sc), rc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sum(kernels.launches.values()) == 0


@pytest.fixture(scope="module")
def n71_stage2_inputs():
    ctx, hj, ht = _hosts(N71)
    rng = np.random.default_rng(11)
    b = 128
    r = lambda *shape: _rand_planes(rng, ht, shape + (b,))
    one = ht.pack([ht.to_mont_int(1)] * b)
    return ctx, hj, ht, rns.device_ctx(ht, "cpu"), b, r, one


def test_chain_plain_equals_pallas_interpret(n71_stage2_inputs):
    ctx, hj, ht, rc, b, r, one = n71_stage2_inputs
    p1, p2, pd = r(2), r(2), r(2)
    want = j_exec.make_rns_chain_executor(hj, b, 4, interpret=True)(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(pd))
    got = rns_kernels.chain(_t(p1), _t(p2), _t(pd), 4, rc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefix_apply_plain_equal_pallas_interpret(n71_stage2_inputs):
    ctx, hj, ht, rc, b, r, one = n71_stage2_inputs
    xs, zs, tinv = r(5), r(5), r()
    want_pre = np.asarray(j_exec.make_rns_prefix_executor(
        hj, b, 5, interpret=True)(jnp.asarray(zs), jnp.asarray(one)))
    got_pre = rns_kernels.prefix(_t(zs), _t(one), rc)
    np.testing.assert_array_equal(got_pre.numpy(), want_pre)
    pres = np.concatenate([one[None], want_pre[:-1]])
    want = j_exec.make_rns_apply_inverse_executor(hj, b, 5, interpret=True)(
        jnp.asarray(xs), jnp.asarray(zs), jnp.asarray(pres),
        jnp.asarray(tinv))
    got = rns_kernels.apply_inverse(_t(xs), _t(zs), _t(pres), _t(tinv), rc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_replay_plain_equals_pallas_stream(n71_stage2_inputs):
    """K15: the plain version multiplies entry by entry, as the Pallas
    stream kernel does, so residues are equal for live counts T-2 and T
    (the last two entries are pads); both equal replay_segment mod n."""
    ctx, hj, ht, rc, b, r, one = n71_stage2_inputs
    n = ctx.n_int
    PA, PB, T = 9, 7, 10
    pa, pb, acc = r(PA), r(PB), r()
    pa[-1] = one
    pb[0] = 0
    rng = np.random.default_rng(4)
    pav = np.sort(rng.integers(0, PA - 1, T - 2))
    idx = np.stack([np.concatenate([pav, [PA - 1, PA - 1]]),
                    np.concatenate([rng.integers(1, PB, T - 2), [0, 0]])],
                   1).astype(np.int32)
    ref = j_exec.replay_segment(jnp.asarray(acc), jnp.asarray(pa),
                                jnp.asarray(pb), jnp.asarray(idx[:T - 2]),
                                hj.dev)
    ref = [v % n for v in ht.unpack(np.asarray(ref))]
    packed = ((idx[:, 0] << 16) | idx[:, 1]).astype(np.int32)
    run = j_exec.make_rns_replay_stream_executor(
        hj, b, PA, PB, t_block=T, n_buffers=3, interpret=True)
    for count in (T - 2, T):
        flat = np.concatenate([[count], packed]).astype(np.int32)
        want = np.asarray(run(jnp.asarray(acc), jnp.asarray(pa),
                              jnp.asarray(pb), jnp.asarray(flat)))
        got = rns_kernels.replay(_t(acc), _t(pa), _t(pb), flat, rc).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(count))
        assert [v % n for v in ht.unpack(got)] == ref, count


def test_stage2_runner_rns_matches_jax_runner():
    """The port's Stage2Runner with RnsOps against tpu_ecm's with
    RnsOps(h) on the jnp path, from the same RNS stage-1 point (N71, sigma
    110-117, B1=300, B2=10000): accumulators mod n, factors and counters
    equal; the sigma-112 curve's accumulator shares P35 with n."""
    ctx, hj, ht = _hosts(N71)
    b1, b2 = 300, 10000
    pts, sc = _curves_state(ctx, hj, range(110, 118))
    tape = j_prac.stage1_tape(primes_range(0, b1), b1, include_two=True)
    pts = np.asarray(jax.jit(j_exec.run_tape)(
        jnp.asarray(pts), jnp.asarray(tape), jnp.asarray(sc), hj.dev))
    primes = primes_range(b1, b2 + 1000)

    sp_j = j_plan.make_stage2_params(b1, b2)
    jr = j_s2.Stage2Runner(ctx, jnp_ops.device_ctx(ctx), sp_j,
                           jnp.asarray(pts[0]), jnp.asarray(sc), b1,
                           use_pallas=False, ops=j_exec.RnsOps(hj))
    jr.init()
    jr.run_chunk(*j_plan.pair(sp_j, primes, b1, b2)[:3])
    want = jr.result()

    rc = convert.rns_ctx({f: np.asarray(getattr(hj.dev, f))
                          for f in rns.TABLES}, hj.K, hj.dev.mr_shift, "cpu")
    sp_t = t_plan.make_stage2_params(b1, b2)
    tr = t_s2.Stage2Runner(ctx, None, sp_t,
                           convert.rns_planes(pts[0], hj.K, "cpu"),
                           convert.rns_planes(sc, hj.K, "cpu"),
                           ops=t_s2.RnsOps(ht, rc))
    tr.init()
    tr.run_chunk(*t_plan.pair(sp_t, primes, b1, b2)[:3])
    got = tr.result()
    assert got.acc == want.acc
    assert got.factors == want.factors
    assert (got.paired, got.ptadds, got.ptdups, got.numinv) == (
        want.paired, want.ptadds, want.ptdups, want.numinv)
    assert math.gcd(got.acc[2], N71) == P35


def _cfg(tmp_path, **kw):
    kw.setdefault("save_b1_path", str(tmp_path / "save_b1.txt"))
    kw.setdefault("checkpoint_path", str(tmp_path / "checkpoint.txt"))
    kw.setdefault("results_path", str(tmp_path / "ecm_results.txt"))
    kw.setdefault("verbose", 0)
    kw.setdefault("device", "cpu")
    return driver.RunConfig(**kw)


@pytest.mark.parametrize("sigma,b2,want", [(172, 300, (P35, 1, 174)),
                                           (110, 10000, (P35, 2, 112))])
def test_rns_driver_n71_finds(tmp_path, sigma, b2, want):
    res = driver.ECMDriver(_cfg(tmp_path, n=N71, curves=4, b1=300, b2=b2,
                                sigma=sigma, engine="rns",
                                stop_on_factor=False)).run()
    assert want in {(h.factor, h.stage, h.sigma) for h in res.factors}


def test_rns_driver_1535bit_find(tmp_path):
    """P35 * P1500 on the RNS engine finds P35 in stage 2 at sigma 112, as
    tests/test_rns_engine.py:223 does on the JAX package."""
    res = driver.ECMDriver(_cfg(tmp_path, n=N1535, curves=4, b1=300,
                                b2=10000, sigma=110, engine="rns",
                                stop_on_factor=False)).run()
    assert any(h.factor % P35 == 0 and h.stage == 2 and h.sigma == 112
               for h in res.factors), res.factors


def test_rns_driver_matches_digit_and_jax(tmp_path):
    """N256, 4 curves from sigma 40, B1=B2=500: the port's RNS engine gives
    the stage-1 residues of its digit engine and of JAX's RNS engine, and
    a save_b1.txt byte-equal to its digit engine's."""
    kw = dict(n=N256, curves=4, b1=500, b2=500, sigma=40)
    out = {}
    for engine in ("rns", "digit"):
        d = tmp_path / engine
        d.mkdir()
        out[engine] = driver.ECMDriver(_cfg(
            d, engine=engine, **kw)).run().stage1_residues
    (tmp_path / "j").mkdir()
    want = j_driver.ECMDriver(j_driver.RunConfig(
        save_b1_path=str(tmp_path / "j" / "save_b1.txt"),
        checkpoint_path=str(tmp_path / "j" / "checkpoint.txt"),
        results_path=str(tmp_path / "j" / "ecm_results.txt"),
        cache_dir=str(tmp_path / "cache"), verbose=0, engine="rns",
        **kw)).run().stage1_residues
    assert out["rns"] == out["digit"] == want
    assert (tmp_path / "rns" / "save_b1.txt").read_bytes() \
        == (tmp_path / "digit" / "save_b1.txt").read_bytes()


def test_routing(tmp_path):
    """2355 bits: "auto" takes the RNS engine (no digit radix exists),
    "digit" raises naming the bound, an unknown engine raises; below the
    bound "auto" stays on the digit engine and "rns" is honoured."""
    n = chip_smoke.n2355()
    d = driver.ECMDriver(_cfg(tmp_path, n=n, curves=1, b1=100))
    assert not d.ctx.p.device_ok and d.engine == "rns"
    assert isinstance(d.ops, t_s2.RnsOps) and d.rhost.K == 192
    with pytest.raises(ValueError, match="digit engine's int32 column"):
        driver.ECMDriver(_cfg(tmp_path, n=n, curves=1, b1=100,
                              engine="digit"))
    with pytest.raises(ValueError, match="unknown engine"):
        driver.ECMDriver(_cfg(tmp_path, n=N71, curves=1, b1=100,
                              engine="mxu"))
    assert driver.ECMDriver(_cfg(tmp_path, n=N71, curves=1,
                                 b1=100)).engine == "digit"
    assert driver.ECMDriver(_cfg(tmp_path, n=N71, curves=1, b1=100,
                                 engine="rns")).engine == "rns"


def test_convert_rns_ctx_round_trips_jax_state():
    ctx, hj, ht = _hosts(N256)
    leaves = {f: np.asarray(getattr(hj.dev, f)) for f in rns.TABLES}
    got = convert.rns_ctx(leaves, hj.K, hj.dev.mr_shift, "cpu")
    ref = rns.device_ctx(ht, "cpu")
    for f in rns.TABLES + ("tab", "wmma"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert (got.K, got.mr_shift, got.rows) == (ref.K, ref.mr_shift, 49)
    with pytest.raises(ValueError, match="w1"):
        convert.rns_ctx(dict(leaves, w1=leaves["w1"][:, :-1]), hj.K,
                        hj.dev.mr_shift, "cpu")
    with pytest.raises(ValueError, match="int32"):
        convert.rns_ctx(dict(leaves, c1=leaves["c1"].astype(np.int64)),
                        hj.K, hj.dev.mr_shift, "cpu")
    pts = np.zeros((6, 2, hj.dev.rows, 4), np.int32)
    assert convert.rns_planes(pts, hj.K, "cpu").shape == pts.shape
    with pytest.raises(ValueError):
        convert.rns_planes(pts[..., :-1, :], hj.K, "cpu")


def test_kernel_tables_layout():
    """tab and the padded u8 weight planes (rns.mma_weights) as
    csrc/rns_mma.cuh reads them."""
    _ctx, _hj, ht = _hosts(N71)
    tab = rns.kernel_tables(ht.tables, ht.K)
    K, t = ht.K, ht.tables
    assert tab.shape == (9 * K + 5,)
    assert tab[2 * K] == ht.mr and tab[9 * K + 4] == t["qinv_r"][0, 0]
    np.testing.assert_array_equal(tab[7 * K + 3:9 * K + 4], t["f_sub"][:, 0])
    planes = rns.mma_weights(t, K)
    kpad, mpad = -(-K // 16) * 16, -(-(K + 1) // 32) * 32
    assert planes.shape == (4, mpad // 32, kpad // 16, 32, 16)
    assert planes.dtype == np.uint8
    # back from 32 x 16 row-major tiles to W^T [Mpad, Kpad]
    wt = planes.transpose(0, 1, 3, 2, 4).reshape(4, mpad, kpad).astype(
        np.int64)
    for m, name in enumerate(("w1", "w2")):
        np.testing.assert_array_equal(
            wt[2 * m, :K + 1, :K] + 256 * wt[2 * m + 1, :K + 1, :K],
            t[name].T)
        assert not wt[2 * m:2 * m + 2, K + 1:].any()
        assert not wt[2 * m:2 * m + 2, :, K:].any()
    assert planes[1::2].max() < 64 and planes.max() > 0
    assert planes[1, 0, 0, 3, 5] == t["w1"][5, 3] >> 8
    rc = rns.device_ctx(ht, "cpu")
    assert torch.equal(rc.wmma, torch.from_numpy(planes))
    assert rc.wmma.data_ptr() % 32 == 0
