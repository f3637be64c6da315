"""The resident-slab replay of the PyTorch port (K8, replay="resident")
held against the JAX package on the CPU, where the wrapper runs its
kernel's plain version: the plain K8 against the Pallas
make_replay_resident_executor in interpret mode, the port's slab partition
against tpu_ecm's _replay_resident, and the runner against tpu_ecm's jnp
runner.  Inputs come from seeded numpy or random streams at B = 128; every
comparison is exact (tolerance 0), of digits where the association is the
kernel's and of values mod n where it is not."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpu_ecm import params  # noqa: E402
from tpu_ecm.limbs import jnp_ops, pallas_ops  # noqa: E402
from tpu_ecm.primes import primes_range  # noqa: E402
from tpu_ecm.stage2 import exec as j_exec  # noqa: E402
from tpu_ecm.stage2 import plan as j_plan  # noqa: E402
from tpu_ecm_torch import convert  # noqa: E402
from tpu_ecm_torch.limbs import kernels, torch_ops  # noqa: E402
from tpu_ecm_torch.stage2 import exec as t_exec  # noqa: E402
from tpu_ecm_torch.stage2 import plan as t_plan  # noqa: E402

from test_torch_replay_modes import (N64, P61, _canon,  # noqa: E402
                                     _digit_tables, _result_tuple,
                                     _sequential, _t)
from test_torch_stage2 import _stage1_point  # noqa: E402

torch.set_num_threads(1)

M89 = (1 << 89) - 1


def _slab_entries(rng, pa_rows, pb_rows, cap, per_slab):
    """v-sorted [T, 2] (pa, pb) entries over pa_rows Pa rows with exactly
    per_slab entries in each slab of cap Pb rows (pb >= 1: row 0 is the
    zero row)."""
    pbs = []
    for lo in range(0, pb_rows, cap):
        pbs += [rng.randrange(max(lo, 1), min(lo + cap, pb_rows))
                for _ in range(per_slab)]
    rng.shuffle(pbs)
    pa = sorted(rng.randrange(pa_rows) for _ in pbs)
    return np.stack([pa, pbs], 1).astype(np.int32)


def _three_slabs(form, e):
    """(ctx, CPU ctx, pa, pbx, acc0, idx, entries, segs, cap): at N64
    (REDC) or M89 = 2^89 - 1 (the fold), B=128, 11 Pb rows in three slabs
    of cap=4 (the last short), 13 live v-sorted entries per slab, padded
    by the port's slab_segments with three (G, 0) entries to one 16-entry
    segment each; segs counted in steps of e entries."""
    mers = (89, 1) if form == "fold" else None
    ctx = params.make_monty(M89 if mers else N64, mersenne=mers)
    rng = random.Random(31 + e)
    PA, PB, cap, live = 17, 11, 4, 13
    g = PA - 1
    pa, pbx, acc0 = _digit_tables(ctx, rng, PA, PB)
    idx = _slab_entries(rng, g, PB, cap, live)
    entries, segs = t_exec.slab_segments(idx, cap, g)
    assert entries.shape[0] == 48 and (segs[:, 2] == 1).all()
    segs[:, 1:] *= t_exec.REPLAY_E // e       # the same segments in e steps
    assert (entries[13:16] == [g, 0]).all() and (entries[:, 1] <= cap).all()
    return (ctx, torch_ops.device_ctx(ctx, "cpu"), pa, pbx, acc0, idx,
            entries, segs, cap)


@pytest.mark.parametrize("form,e", [("redc", 4), ("redc", 8), ("redc", 16),
                                    ("fold", 4), ("fold", 8)])
def test_resident_plain_matches_pallas_interpret(form, e):
    """Plain K8 against Pallas make_replay_resident_executor in interpret
    mode on _three_slabs: Pallas runs one call per slab on [zero row, rows
    lo..lo+3] and carries acc; the plain version on the first segment
    alone equals Pallas after one slab, and on all three in one call
    equals Pallas after three, digit for digit (pads included); the values
    equal the sequential jnp product mod n.  (The fold at E=16 is
    test_fold_resident_e16_matches_plain_gather: its interpret-mode kernel
    compiles for more than ten minutes on the CPU.)"""
    ctx, td, pa, pbx, acc0, idx, entries, segs, cap = _three_slabs(form, e)
    PA = pa.shape[0]
    run = pallas_ops.make_replay_resident_executor(
        ctx, 128, PA, cap + 1, t_block=16, entries_per_step=e,
        interpret=True)
    acc = jnp.asarray(acc0)
    want = []
    for h, (lo, _first, _n) in enumerate(segs):
        slab = np.zeros((cap + 1,) + pbx.shape[1:], pbx.dtype)
        rows = pbx[lo:lo + cap]
        slab[1:1 + rows.shape[0]] = rows
        acc = run(acc, jnp.asarray(pa), jnp.asarray(slab),
                  jnp.asarray(entries[16 * h:16 * h + 16]))
        want.append(np.asarray(acc))

    kernels.reset_launches()
    one = kernels.replay_resident(_t(acc0), _t(pa), _t(pbx), entries[:16],
                                  segs[:1], cap, td, e=e)
    np.testing.assert_array_equal(one.numpy(), want[0])
    got = kernels.replay_resident(_t(acc0), _t(pa), _t(pbx), entries, segs,
                                  cap, td, e=e)
    np.testing.assert_array_equal(got.numpy(), want[-1])
    assert _canon(got, ctx) == _sequential(ctx, acc0, pa, pbx, idx.tolist())
    assert sum(kernels.launches.values()) == 0


def test_fold_resident_e16_matches_plain_gather():
    """The fold at E=16 on _three_slabs: plain K8 over the three segments
    equals, digit for digit, plain K6 (the twin of Pallas
    make_replay_executor) over the same entries mapped back to their pbx
    rows (pads to the zero row 0), and the sequential jnp product mod M."""
    ctx, td, pa, pbx, acc0, idx, entries, segs, cap = _three_slabs("fold", 16)
    got = kernels.replay_resident(_t(acc0), _t(pa), _t(pbx), entries, segs,
                                  cap, td, e=16)
    pairs = np.stack([entries[:, 0], kernels.pbx_rows(entries, segs, 16)],
                     1)
    want = kernels.replay_gather(_t(acc0), _t(pa), _t(pbx), pairs, td, e=16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert _canon(got, ctx) == _sequential(ctx, acc0, pa, pbx, idx.tolist())


def _jax_resident_calls(monkeypatch, idx, g, pb_rows, slab_mb, row_ints):
    """The (slab lo, live entries) of each call tpu_ecm's _replay_resident
    makes for idx, through a stub make_replay_resident, with its slab cap
    from TPU_ECM_REPLAY_SLAB_MB over a Pb table of pb_rows rows of row_ints
    int32 each (one curve)."""
    monkeypatch.setenv("TPU_ECM_REPLAY_SLAB_MB", slab_mb)
    calls = []

    class Ops:
        def make_replay_resident(self, b, pa_rows, slab_rows, t_block,
                                 entries_per_step):
            def run(acc, pa_ext, slab, blk):
                calls.append((slab, np.asarray(blk)))
                return acc
            return run

    r = object.__new__(j_exec.Stage2Runner)
    r.pa_group, r.replay_block, r.b, r.sharder = g, 64, 1, None
    r.pbx = jnp.zeros((pb_rows, row_ints, 1), jnp.int32)
    r._slabs, r._cache, r._ek, r.ops, r.acc = None, {}, "DigitOps", Ops(), 0
    r._replay_resident(None, idx)
    lo_of = {id(slab): lo for lo, slab in r._slabs}
    cap = int(r._slabs[0][1].shape[0]) - 1
    return cap, [(lo_of[id(slab)], blk[blk[:, 1] > 0]) for slab, blk in calls]


def _by_slab(calls):
    """[(lo, live entries)] -> {lo: entries in call order}, and the order
    in which the slabs first appear."""
    out, order = {}, []
    for lo, ent in calls:
        if lo not in out:
            order.append(lo)
            out[lo] = []
        out[lo].append(ent)
    return {lo: np.concatenate(v) for lo, v in out.items()}, order


@pytest.mark.parametrize("slab_mb,want_cap", [("0", 1), ("1", 7)])
def test_slab_partition_equals_jax(monkeypatch, slab_mb, want_cap):
    """For the same cap (1, and 7 = 1 MB over 128 KB rows less the zero
    row), the port's resident replay_calls partition 500 v-sorted entries
    of a 40-row Pa group over 60 Pb rows as tpu_ecm's _replay_resident
    does: the same slabs in the same order, and in each slab the same live
    entries (local rows) in the same order; the port's pads are (G, 0) and
    end each slab's part, and each call holds at most the block."""
    rng = np.random.default_rng(23)
    G, T, PB, block = 40, 500, 60, 64
    idx = np.stack([np.sort(rng.integers(0, G, T)), rng.integers(1, PB, T)],
                   1).astype(np.int32)
    cap, jcalls = _jax_resident_calls(monkeypatch, idx, G, PB, slab_mb,
                                      1 << 15)
    assert cap == want_cap
    want, want_order = _by_slab(jcalls)
    ours = []
    for call, slots in t_exec.replay_calls("resident", idx, block, G, cap):
        assert isinstance(call, t_exec.SlabCall) and call.cap == cap
        assert slots == call.entries.shape[0] <= block
        assert slots % t_exec.REPLAY_E == 0
        for lo, first, n in call.slabs:
            seg = call.entries[first * 16:(first + n) * 16]
            live = seg[:, 1] > 0
            assert (seg[~live] == [G, 0]).all()
            assert live[:live.sum()].all()            # pads end the part
            ours.append((lo, seg[live]))
    got, got_order = _by_slab(ours)
    assert got_order == want_order and len(got_order) > 1
    for lo in want:
        np.testing.assert_array_equal(got[lo], want[lo])


@pytest.fixture(scope="module")
def p61_stage2():
    """tpu_ecm's jnp Stage2Runner at P61, 128 curves from sigma 40, B1=300,
    B2=4000, and the port's inputs for the same run."""
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
    tdc = convert.device_ctx(np.asarray(jd.n), np.asarray(jd.c), jd.p,
                             jd.nprime, jd.mersenne_e, jd.mersenne_c_sign,
                             "cpu")
    sp_t = t_plan.make_stage2_params(b1, b2)
    return dict(ctx=ctx, want=jr.result(), tdc=tdc, sp=sp_t,
                state=convert.stage1_state(pts, s_const, ctx.p, "cpu"),
                pairmap=t_plan.pair(sp_t, primes, b1, b2)[:3])


@pytest.mark.parametrize("cap", [1, 7])
def test_resident_runner_matches_jax(monkeypatch, p61_stage2, cap):
    """The port's Stage2Runner in resident mode with slab_rows = 1 (99
    slabs of the 99-row Pb table) and 7 (15 slabs), 32-entry replay blocks:
    acc (canonical), factors, paired, ptadds and numinv equal tpu_ecm's jnp
    runner (use_pallas=False); slots count the pads."""
    monkeypatch.setitem(t_exec.REPLAY_BLOCK, "cpu", 32)
    s = p61_stage2
    tr = t_exec.Stage2Runner(s["ctx"], s["tdc"], s["sp"],
                             s["state"].pts[0], s["state"].s_const,
                             replay="resident", slab_rows=cap)
    assert tr.slab_rows == cap
    tr.init()
    kernels.reset_launches()
    tr.run_chunk(*s["pairmap"])
    got, want = tr.result(), s["want"]
    assert _result_tuple(got) == (want.acc, want.factors, want.paired,
                                  want.ptadds, want.numinv)
    assert got.slots > got.paired and got.slots % t_exec.REPLAY_E == 0
    assert sum(kernels.launches.values()) == 0


def test_resident_wrapper_checks_inputs():
    """K8 raises on a local row past the slab, on slab segments that do
    not cover the steps in order, on a slab or a live row outside pbx, on
    a cap below 1, and on a device other than cpu or cuda; the CPU default
    slab height is PLAIN_SLAB_ROWS."""
    ctx = params.make_monty(N64)
    td = torch_ops.device_ctx(ctx, "cpu")
    nw, b = ctx.p.nw, 4
    acc = torch.zeros((nw, b), dtype=torch.int32)
    tab = torch.zeros((5, nw, b), dtype=torch.int32)
    ent = np.asarray([[0, 1], [1, 2], [2, 0], [4, 0]], np.int32)
    ok = np.asarray([[0, 0, 2]], np.int32)
    call = lambda *a, **k: kernels.replay_resident(
        acc, tab, tab, *a, td, e=k.get("e", 2))
    assert call(ent, ok, 2).shape == (nw, b)
    with pytest.raises(ValueError, match="outside"):
        call(ent, ok, 1)                        # u = 2 > cap
    for bad in ([[0, 0, 1]], [[0, 1, 2]], [[0, 0, 1], [2, 0, 1]],
                [[5, 0, 2]], [[0, 0, 0], [0, 0, 2]]):
        with pytest.raises(ValueError, match="slabs"):
            call(ent, np.asarray(bad, np.int32), 2)
    with pytest.raises(ValueError, match="entry row outside pbx"):
        call(ent, np.asarray([[4, 0, 2]], np.int32), 2)  # row 4 + 2 - 1
    with pytest.raises(ValueError, match=">= 1"):
        call(np.zeros((4, 2), np.int32), ok, 0)
    meta = torch_ops.device_ctx(ctx, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.replay_resident(acc.to("meta"), tab.to("meta"),
                                tab.to("meta"), ent, ok, 2, meta, e=2)
    ops = t_exec.DigitOps(ctx, td)
    assert ops.slab_rows() == t_exec.PLAIN_SLAB_ROWS
