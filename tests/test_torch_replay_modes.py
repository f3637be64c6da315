"""The stage-2 replay modes of the PyTorch port (stage2/exec.py: stream,
gather, parow, resident) held against the JAX package on the CPU, where
every wrapper runs its kernel's plain version: the plain K6 and K7 against
the Pallas
gather and shared-Pa-row kernels in interpret mode, the plain K14 against
the Pallas RNS gather kernel, the parow step packing against tpu_ecm's,
the fold's one, the runner and the driver in every mode against each other
and against tpu_ecm, and the errors.  Inputs come from seeded numpy or
random streams at B = 128; every comparison is exact (tolerance 0), of
digits or residues where the association is the kernel's and of values
mod n where it is not."""

import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm import params  # noqa: E402
from tpu_ecm.curve import prac as j_prac  # noqa: E402
from tpu_ecm.limbs import jnp_ops, layout, pallas_ops  # noqa: E402
from tpu_ecm.limbs import rns_exec as j_rns_exec  # noqa: E402
from tpu_ecm.primes import primes_range  # noqa: E402
from tpu_ecm.stage2 import exec as j_exec  # noqa: E402
from tpu_ecm.stage2 import plan as j_plan  # noqa: E402
from tpu_ecm_torch import convert, driver  # noqa: E402
from tpu_ecm_torch.limbs import kernels, rns, rns_kernels  # noqa: E402
from tpu_ecm_torch.limbs import torch_ops  # noqa: E402
from tpu_ecm_torch.stage2 import exec as t_exec  # noqa: E402
from tpu_ecm_torch.stage2 import plan as t_plan  # noqa: E402

from test_torch_rns import _curves_state, _hosts, _rand_planes  # noqa: E402
from test_torch_stage2 import _stage1_point  # noqa: E402

torch.set_num_threads(1)

N64 = 2545580083 * 2551628647
P35, P36 = 34359738421, 68719476767
N71 = P35 * P36
P61 = (1 << 61) - 1
M101 = (1 << 101) - 1
M101_P13 = 7432339208719


def _t(a):
    return torch.from_numpy(np.array(a))


def _digit_tables(ctx, rng, PA, PB, b=128):
    """Random reduced Pa rows with the one as the last row, Pb rows with the
    zero row first, and an acc: numpy digit planes."""
    p, n = ctx.p, ctx.n_int

    def mk(rows):
        return np.stack([layout.pack_batch([rng.randrange(n) for _ in range(b)],
                                           p.w, p.nw) for _ in range(rows)])

    pa, pb = mk(PA), mk(PB)
    pa[-1] = layout.broadcast_int(ctx.r_mod_n, p.w, p.nw, b)
    pb[0] = 0
    return pa, pb, mk(1)[0]


def _sequential(ctx, acc0, pa, pb, pairs):
    """acc times (pa[v] - pb[u]) entry by entry through jnp_ops: values."""
    jd = jnp_ops.device_ctx(ctx)
    acc = jnp.asarray(acc0)
    for v, u in pairs:
        acc = jnp_ops.mulmod(acc, jnp.asarray(pa[v] - pb[u]), jd)
    return [x % ctx.n_int for x in layout.unpack_batch(np.asarray(acc),
                                                       ctx.p.w)]


def _canon(plane, ctx):
    return [x % ctx.n_int for x in layout.unpack_batch(np.asarray(plane),
                                                       ctx.p.w)]


# ---------------------------------------------------------------------------
# K6, K7, K14 against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e", [4, 8, 16])
def test_gather_plain_matches_pallas_interpret(e):
    """Plain K6 against Pallas make_replay_executor in interpret mode on
    N64 (REDC), PA=17, PB=9, T=16 with two pad entries (G, 0): the plain
    version keeps the kernel's association (the same lazy pass per
    difference and the same pairwise tree), so the digits are equal, and
    the values equal the sequential jnp product mod n."""
    ctx = params.make_monty(N64)
    rng = random.Random(3)
    PA, PB, T = 17, 9, 16
    pa, pb, acc0 = _digit_tables(ctx, rng, PA, PB)
    idx = np.stack([np.array([rng.randrange(PA - 1) for _ in range(T)]),
                    np.array([rng.randrange(1, PB) for _ in range(T)])],
                   1).astype(np.int32)
    idx[-2:] = [PA - 1, 0]
    run = pallas_ops.make_replay_executor(ctx, 128, PA, PB, t_block=T,
                                          entries_per_step=e, interpret=True)
    want = np.asarray(run(jnp.asarray(acc0), jnp.asarray(pa),
                          jnp.asarray(pb), jnp.asarray(idx)))
    kernels.reset_launches()
    got = kernels.replay_gather(_t(acc0), _t(pa), _t(pb), idx,
                                torch_ops.device_ctx(ctx, "cpu"), e=e)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _canon(got, ctx) == _sequential(ctx, acc0, pa, pb,
                                           idx.tolist()[:T - 2])
    assert sum(kernels.launches.values()) == 0


@pytest.mark.parametrize("e", [4, 8])
def test_parow_plain_matches_pallas_interpret(e):
    """Plain K7 against Pallas make_replay_parow_executor in interpret mode
    on N64 (the shapes of tests/test_stage2.py:361-414): T=37 v-sorted
    entries with runs of unequal length (so T is not a multiple of E and
    short steps carry pb = 0 pads), packed by the port's
    pack_parow_steps, and two whole pad steps at pa = G.  Digits equal
    (the kernel's association), values equal the sequential product."""
    ctx = params.make_monty(N64)
    rng = random.Random(11)
    PA, PB, T = 17, 9, 37
    pa, pb, acc0 = _digit_tables(ctx, rng, PA, PB)
    pav = np.sort(np.array([rng.randrange(PA - 1) for _ in range(T)]))
    idx = np.stack([pav, np.array([rng.randrange(1, PB) for _ in range(T)])],
                   1).astype(np.int32)
    steps = t_exec.pack_parow_steps(idx, e)
    pad = np.zeros((2, 1 + e), np.int32)
    pad[:, 0] = PA - 1
    steps = np.concatenate([steps, pad])
    assert T % e and (steps[:-2, 1:] == 0).any()
    run = pallas_ops.make_replay_parow_executor(
        ctx, 128, PA, PB, nsteps=steps.shape[0], entries_per_step=e,
        interpret=True)
    want = np.asarray(run(jnp.asarray(acc0), jnp.asarray(pa), jnp.asarray(pb),
                          jnp.asarray(steps.reshape(-1))))
    got = kernels.replay_parow(_t(acc0), _t(pa), _t(pb), steps,
                               _t(pa[-1]), torch_ops.device_ctx(ctx, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert _canon(got, ctx) == _sequential(ctx, acc0, pa, pb, idx.tolist())


@pytest.mark.parametrize("e", [1, 4, 16])
def test_pack_parow_steps_equals_jax(e):
    """The port's pack_parow_steps is bit-equal to tpu_ecm's staticmethod
    on v-sorted entries with runs of every length, and conserves entries:
    each (pa, pb) lands in a step with its own Pa row."""
    rng = np.random.default_rng(17 + e)
    pav = np.sort(rng.integers(0, 40, 300))
    idx = np.stack([pav, rng.integers(1, 50, 300)], 1).astype(np.int32)
    got = t_exec.pack_parow_steps(idx, e)
    want = j_exec.Stage2Runner._pack_parow_steps(idx, e)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    entries = sorted((int(s[0]), int(u)) for s in got for u in s[1:] if u)
    assert entries == sorted(map(tuple, idx.tolist()))


@pytest.mark.parametrize("e", [4, 8])
def test_rns_gather_plain_equals_pallas_interpret(e):
    """Plain K14 against Pallas make_rns_replay_executor in interpret mode
    at N71 (the K of tests/test_torch_rns.py's K15 case), T=16 with a pad
    entry (G, 0) in the block: residues bitwise equal; values equal
    rns_exec.replay_segment's mod n."""
    ctx, hj, ht = _hosts(N71)
    rc = rns.device_ctx(ht, "cpu")
    rng = np.random.default_rng(21)
    b, PA, PB, T = 128, 9, 7, 16
    one = ht.pack([ht.to_mont_int(1)] * b)
    pa, pb, acc = (_rand_planes(rng, ht, (k, b)) for k in (PA, PB, 1))
    acc = acc[0]
    pa[-1] = one
    pb[0] = 0
    idx = np.stack([np.sort(rng.integers(0, PA - 1, T)),
                    rng.integers(1, PB, T)], 1).astype(np.int32)
    idx[-1] = [PA - 1, 0]
    run = j_rns_exec.make_rns_replay_executor(hj, b, PA, PB, t_block=T,
                                              entries_per_step=e,
                                              interpret=True)
    want = np.asarray(run(jnp.asarray(acc), jnp.asarray(pa), jnp.asarray(pb),
                          jnp.asarray(idx)))
    got = rns_kernels.replay_gather(_t(acc), _t(pa), _t(pb), idx, rc, e=e)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = j_rns_exec.replay_segment(jnp.asarray(acc), jnp.asarray(pa),
                                    jnp.asarray(pb), jnp.asarray(idx), hj.dev)
    n = ctx.n_int
    assert [v % n for v in ht.unpack(got.numpy())] \
        == [v % n for v in ht.unpack(np.asarray(ref))]


@pytest.mark.parametrize("e", [4, 16])
def test_fold_gather_parow_plain_match_sequential_mod_m(e):
    """The fold (M127 = 2^127 - 1, where the one is 1): plain K6 and K7
    with pad entries, pb = 0 pads and a whole pad step against the
    sequential jnp product mod M."""
    ctx = params.make_monty((1 << 127) - 1, mersenne=(127, 1))
    assert ctx.is_mersenne and ctx.r_mod_n == 1
    td = torch_ops.device_ctx(ctx, "cpu")
    rng = random.Random(5)
    PA, PB, T = 9, 6, 32
    pa, pb, acc0 = _digit_tables(ctx, rng, PA, PB)
    pav = np.sort(np.array([rng.randrange(PA - 1) for _ in range(T - 3)]))
    idx = np.stack([pav, [rng.randrange(1, PB) for _ in range(T - 3)]],
                   1).astype(np.int32)
    want = _sequential(ctx, acc0, pa, pb, idx.tolist())
    padded = np.concatenate([idx, np.tile([[PA - 1, 0]], (3, 1))])
    got = kernels.replay_gather(_t(acc0), _t(pa), _t(pb), padded, td, e=e)
    assert _canon(got, ctx) == want
    steps = t_exec.pack_parow_steps(idx, e)
    steps = np.concatenate([steps, [[PA - 1] + [0] * e]])
    got = kernels.replay_parow(_t(acc0), _t(pa), _t(pb), steps, _t(pa[-1]),
                               td)
    assert _canon(got, ctx) == want


# ---------------------------------------------------------------------------
# the runner and the driver in every mode
# ---------------------------------------------------------------------------

def _result_tuple(r):
    return (r.acc, r.factors, r.paired, r.ptadds, r.numinv)


def test_runner_modes_match_each_other_and_jax(monkeypatch):
    """The port's Stage2Runner at P61 (REDC), 128 curves from sigma 40,
    B1=300, B2=4000 in stream, gather and parow, with 32-entry replay
    blocks (so every mode runs several calls, and gather pads calls to
    whole steps): acc, factors, paired, ptadds and numinv equal across the
    modes and equal tpu_ecm's Stage2Runner on its jnp path
    (use_pallas=False)."""
    monkeypatch.setitem(t_exec.REPLAY_BLOCK, "cpu", 32)
    ctx = params.make_monty(P61)
    b1, b2 = 300, 4000
    pts, s_const = _stage1_point(ctx, range(40, 168), b1)
    primes = primes_range(b1, b2 + 1000)
    jd = jnp_ops.device_ctx(ctx)
    sp_j = j_plan.make_stage2_params(b1, b2)
    jr = j_exec.Stage2Runner(ctx, jd, sp_j, jnp.asarray(pts[0]),
                             jnp.asarray(s_const), b1, use_pallas=False)
    jr.init()
    jr.run_chunk(*j_plan.pair(sp_j, primes, b1, b2)[:3])
    want = jr.result()

    tdc = convert.device_ctx(np.asarray(jd.n), np.asarray(jd.c), jd.p,
                             jd.nprime, jd.mersenne_e, jd.mersenne_c_sign,
                             "cpu")
    state = convert.stage1_state(pts, s_const, ctx.p, "cpu")
    sp_t = t_plan.make_stage2_params(b1, b2)
    pairmap = t_plan.pair(sp_t, primes, b1, b2)[:3]
    got = {}
    for mode in ("stream", "gather", "parow"):
        tr = t_exec.Stage2Runner(ctx, tdc, sp_t, state.pts[0],
                                 state.s_const, replay=mode)
        tr.init()
        tr.run_chunk(*pairmap)
        got[mode] = tr.result()
    assert got["stream"].paired > 3 * 32
    for mode, r in got.items():
        assert _result_tuple(r) == (want.acc, want.factors, want.paired,
                                    want.ptadds, want.numinv), mode


def test_rns_runner_gather_matches_stream(monkeypatch):
    """The RNS engine's runner at N71 (8 curves from sigma 110, B1=300,
    B2=10000) in stream and gather, 32-entry blocks: accumulators mod n,
    factors and counters equal; the sigma-112 curve's accumulator shares
    P35 with n."""
    monkeypatch.setitem(t_exec.REPLAY_BLOCK, "cpu", 32)
    ctx, hj, ht = _hosts(N71)
    b1, b2 = 300, 10000
    pts, sc = _curves_state(ctx, hj, range(110, 118))
    tape = j_prac.stage1_tape(primes_range(0, b1), b1, include_two=True)
    pts = np.asarray(jax.jit(j_rns_exec.run_tape)(
        jnp.asarray(pts), jnp.asarray(tape), jnp.asarray(sc), hj.dev))
    rc = rns.device_ctx(ht, "cpu")
    sp = t_plan.make_stage2_params(b1, b2)
    pairmap = t_plan.pair(sp, primes_range(b1, b2 + 1000), b1, b2)[:3]
    got = {}
    for mode in ("stream", "gather"):
        tr = t_exec.Stage2Runner(ctx, None, sp, _t(pts[0]), _t(sc),
                                 ops=t_exec.RnsOps(ht, rc), replay=mode)
        tr.init()
        tr.run_chunk(*pairmap)
        got[mode] = tr.result()
    assert _result_tuple(got["gather"]) == _result_tuple(got["stream"])
    assert math.gcd(got["gather"].acc[2], N71) == P35


def _cfg(tmp_path, **kw):
    kw.setdefault("save_b1_path", str(tmp_path / "save_b1.txt"))
    kw.setdefault("checkpoint_path", str(tmp_path / "checkpoint.txt"))
    kw.setdefault("results_path", str(tmp_path / "ecm_results.txt"))
    kw.setdefault("verbose", 0)
    kw.setdefault("device", "cpu")
    return driver.RunConfig(**kw)


def _hits(res):
    return {(h.factor, h.stage, h.sigma) for h in res.factors}


@pytest.fixture(scope="module")
def n71_jax_hits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    return _hits(j_driver.ECMDriver(j_driver.RunConfig(
        n=N71, curves=4, b1=300, b2=10000, sigma=110, verbose=0,
        save_b1_path=str(tmp / "save_b1.txt"),
        checkpoint_path=str(tmp / "checkpoint.txt"),
        results_path=str(tmp / "ecm_results.txt"))).run())


@pytest.mark.parametrize("engine,mode", [("digit", "stream"),
                                         ("digit", "gather"),
                                         ("digit", "parow"),
                                         ("digit", "resident"),
                                         ("rns", "gather")])
def test_driver_n71_finds_in_every_mode(tmp_path, n71_jax_hits, engine,
                                        mode):
    """run_ecm on N71 (4 curves from sigma 110, B1=300, B2=10000) finds P35
    in stage 2 at sigma 112 in every mode, through the mode's own kernel
    (its plain version here), with tpu_ecm's (factor, stage, sigma) set."""
    kernels.reset_launches()
    res = driver.ECMDriver(_cfg(tmp_path, n=N71, curves=4, b1=300,
                                b2=10000, sigma=110, engine=engine,
                                replay=mode)).run()
    assert (P35, 2, 112) in _hits(res)
    assert _hits(res) == n71_jax_hits
    assert res.counters["paired"] > 0


@pytest.mark.parametrize("mode", ["gather", "parow", "resident"])
def test_driver_m101_stage2_find(tmp_path, mode):
    """tests/test_e2e.py:497-511's stage-2 find through the port's driver
    in the fold: on M101 = 2^101 - 1 the sigma-502 curve finds the P13
    7432339208719 in stage 2 in `mode`.  The bounds are cut from B1=1e4,
    B2=1e6 to what that curve needs: the point's order mod the P13 is
    3^a 5^b 7^c 73 * 1879 * 129011, so B1=2000, B2=150,000."""
    d = driver.ECMDriver(_cfg(tmp_path, n=M101, curves=1, b1=2000,
                              b2=150_000, sigma=502, replay=mode))
    assert d.ctx.is_mersenne
    assert _hits(d.run()) == {(M101_P13, 2, 502)}


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def test_replay_mode_errors(tmp_path):
    """resident (K8) and parow on the RNS engine raise (tpu_ecm substitutes
    gather there); an unknown mode raises; resident on the digit engine
    is taken."""
    kw = dict(n=N71, curves=1, b1=100)
    with pytest.raises(ValueError, match="resident"):
        driver.ECMDriver(_cfg(tmp_path, replay="resident", engine="rns",
                              **kw))
    assert driver.ECMDriver(_cfg(tmp_path, replay="resident",
                                 **kw)).replay == "resident"
    with pytest.raises(ValueError, match="parow"):
        driver.ECMDriver(_cfg(tmp_path, replay="parow", engine="rns", **kw))
    with pytest.raises(ValueError, match="unknown replay mode"):
        driver.ECMDriver(_cfg(tmp_path, replay="scatter", **kw))
    assert driver.ECMDriver(_cfg(tmp_path, replay="gather", engine="rns",
                                 **kw)).cfg.replay == "gather"


@pytest.mark.parametrize("engine,want", [("digit", "stream"),
                                         ("rns", "stream")])
def test_replay_default_follows_engine(tmp_path, engine, want):
    """With no replay= the driver and the runner take the engine's default
    mode (stream on the digit engine and on RNS); a named mode wins."""
    d = driver.ECMDriver(_cfg(tmp_path, n=N71, curves=1, b1=100,
                              engine=engine))
    assert d.cfg.replay is None and d.replay == want
    assert t_exec.replay_mode(None, d.ops) == want
    assert t_exec.replay_mode("stream", d.ops) == "stream"
    assert d.ops.replay_kernels[want] in kernels.KERNELS


@pytest.mark.parametrize("mode", ["stream", "gather", "parow", "resident"])
def test_replay_calls_pad_no_more_than_steps(mode):
    """replay_calls cuts 1,000 v-sorted entries of a 40-row group into
    calls of at most a 256-entry block: every entry is replayed once, in
    order (resident: in slab order, v-order within each slab of 7 Pb
    rows); gather pads the last call with (G, 0) to whole 16-entry steps
    only, resident each slab's part, parow runs no pad step, and stream
    carries each call's count; each call's slots are the entries its
    kernel steps through."""
    rng = np.random.default_rng(5)
    G, T, block, e, cap = 40, 1000, 256, t_exec.REPLAY_E, 7
    idx = np.stack([np.sort(rng.integers(0, G, T)), rng.integers(1, 60, T)],
                   1).astype(np.int32)
    calls, slots = zip(*t_exec.replay_calls(mode, idx, block, G, cap))
    per_slab = np.bincount(idx[:, 1] // cap)
    assert sum(slots) == {"stream": T, "gather": T + (-T % e),
                          "parow": e * sum(map(len, calls)),
                          "resident": int((-(-per_slab // e) * e).sum())
                          }[mode]
    if mode == "stream":
        assert all(c[0] == c.size - 1 <= block for c in calls)
        got = np.concatenate([c[1:] for c in calls]).view(np.uint32)
        got = np.stack([got >> 16, got & 0xFFFF], 1)
    elif mode == "gather":
        assert all(c.shape[0] <= block and c.shape[0] % e == 0
                   for c in calls)
        got = np.concatenate(calls)
        assert got.shape[0] == T + (-T % e)
        assert (got[T:] == [G, 0]).all()
        got = got[:T]
    elif mode == "resident":
        got = []
        for c in calls:
            assert c.entries.shape[0] <= block and c.cap == cap
            assert c.slabs[:, 2].sum() * e == c.entries.shape[0]
            for lo, first, n in c.slabs:
                seg = c.entries[first * e:(first + n) * e]
                live = seg[:, 1] > 0
                assert (seg[~live] == [G, 0]).all() and live.sum() > 0
                assert (seg[live, 1] <= cap).all()
                got += [(pa, lo + u - 1) for pa, u in seg[live]]
        idx = idx[np.argsort(idx[:, 1] // cap, kind="stable")]
    else:
        assert all(c.shape[0] <= block // e for c in calls)
        steps = np.concatenate(calls)
        np.testing.assert_array_equal(steps, t_exec.pack_parow_steps(idx, e))
        assert (steps[:, 1:] > 0).any(axis=1).all() and (steps[:, 0] < G).all()
        got = [(s[0], u) for s in steps for u in s[1:] if u]
    np.testing.assert_array_equal(np.asarray(got), idx)


def test_new_wrappers_check_inputs():
    """K6, K7 and K14 raise on an index outside its table, on an E that is
    not a power of two up to 16, on a block that is not whole steps, and on
    a device other than cpu or cuda."""
    ctx = params.make_monty(N64)
    td = torch_ops.device_ctx(ctx, "cpu")
    nw, b = ctx.p.nw, 4
    acc = torch.zeros((nw, b), dtype=torch.int32)
    tab = torch.zeros((3, nw, b), dtype=torch.int32)
    ok = np.zeros((4, 2), np.int32)
    for bad in ([[3, 0]] * 4, [[0, 3]] * 4, [[-1, 0]] * 4):
        with pytest.raises(ValueError, match="outside"):
            kernels.replay_gather(acc, tab, tab, np.asarray(bad), td, e=4)
    for e in (3, 32, 0):
        with pytest.raises(ValueError, match="power of two"):
            kernels.replay_gather(acc, tab, tab, np.zeros((e or 1, 2)), td,
                                  e=e)
    with pytest.raises(ValueError, match="multiple"):
        kernels.replay_gather(acc, tab, tab, ok[:3], td, e=2)
    for bad in ([[3, 1, 0]], [[0, 1, 3]], [[0, -1, 0]]):
        with pytest.raises(ValueError, match="outside"):
            kernels.replay_parow(acc, tab, tab, np.asarray(bad), acc, td)
    with pytest.raises(ValueError, match="power of two"):
        kernels.replay_parow(acc, tab, tab, np.zeros((1, 4), np.int32), acc,
                             td)
    with pytest.raises(ValueError, match="shape"):
        kernels.replay_parow(acc, tab, tab, np.zeros((1, 2), np.int32),
                             acc[:, :3].contiguous(), td)
    meta = torch_ops.device_ctx(ctx, "meta")
    m_acc, m_tab = acc.to("meta"), tab.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.replay_gather(m_acc, m_tab, m_tab, ok, meta, e=4)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.replay_parow(m_acc, m_tab, m_tab, np.zeros((1, 5), np.int32),
                             m_acc, meta)

    _ctx, _hj, ht = _hosts(N71)
    rc = rns.device_ctx(ht, "cpu")
    racc = torch.zeros((rc.rows, b), dtype=torch.int32)
    rtab = torch.zeros((3, rc.rows, b), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        rns_kernels.replay_gather(racc, rtab, rtab, np.asarray([[0, 3]]), rc,
                                  e=1)
    with pytest.raises(ValueError, match="power of two"):
        rns_kernels.replay_gather(racc, rtab, rtab, np.zeros((6, 2)), rc,
                                  e=6)
    rmeta = rns.device_ctx(ht, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rns_kernels.replay_gather(racc.to("meta"), rtab.to("meta"),
                                  rtab.to("meta"), ok, rmeta, e=4)
