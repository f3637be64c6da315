"""Edwards stage 1 of the PyTorch port held against the JAX package: the
host copies (tapes, tables, accumulator) bit-equal to tpu_ecm.curve.edwards,
the plain K9 (curve/edops.run_tape) bit-equal to the JAX jnp replay and to
the Pallas Edwards kernel in interpret mode, in REDC and fold modes, and
the driver's finds, save_b1.txt and checkpoint.txt equal to the JAX
driver's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm import params as j_params  # noqa: E402
from tpu_ecm.curve import edops as j_edops  # noqa: E402
from tpu_ecm.curve import edwards as j_ed  # noqa: E402
from tpu_ecm.limbs import jnp_ops, pallas_ops  # noqa: E402
from tpu_ecm_torch import convert, driver  # noqa: E402
from tpu_ecm_torch import params as t_params  # noqa: E402
from tpu_ecm_torch.curve import edops, edwards  # noqa: E402
from tpu_ecm_torch.limbs import kernels, torch_ops  # noqa: E402
from tpu_ecm_torch.primes import primes_range  # noqa: E402

from test_e2e import N71, P35  # noqa: E402

torch.set_num_threads(1)

M127 = (1 << 127) - 1


def _ctxs(n, mersenne=None):
    return (t_params.make_monty(n, mersenne=mersenne),
            j_params.make_monty(n, mersenne=mersenne))


def _tape(ed, primes, b1):
    """The (tape, leading digit) of one package's planner: the port's
    stage1_tape, or tpu_ecm's cached_stage1_tape with its cache off."""
    if ed is edwards:
        return ed.stage1_tape(primes, b1)
    return ed.cached_stage1_tape(primes, b1, None)


def _state(ed, ctx, sigmas, b1):
    """(tape, lead, curves, table pts, cached table, accumulator) of one
    package's host planner."""
    primes = primes_range(0, b1 + 100)
    tape, lead = _tape(ed, primes, b1)
    curves = [ed.build_one_curve(ctx, s) for s in sigmas]
    pts, cached = ed.build_batch_tables(ctx, curves)
    return tape, lead, curves, pts, cached, ed.init_accumulator(ctx, pts,
                                                                 lead)


@pytest.mark.parametrize("b1", [300, 3000])
def test_host_copies_bit_equal(b1):
    """Tapes, leading digits, curves, window tables and the initial
    accumulator of the port's curve/edwards.py equal tpu_ecm's."""
    tctx, jctx = _ctxs(N71)
    sig = range(10, 14)
    t_tape, t_lead, t_curves, t_pts, t_tab, t_acc = _state(edwards, tctx,
                                                           sig, b1)
    j_tape, j_lead, j_curves, j_pts, j_tab, j_acc = _state(j_ed, jctx, sig,
                                                           b1)
    np.testing.assert_array_equal(t_tape, j_tape)
    assert t_lead == j_lead
    assert [vars(c) for c in t_curves] == [vars(c) for c in j_curves]
    assert t_pts == j_pts
    np.testing.assert_array_equal(t_tab, j_tab)
    np.testing.assert_array_equal(t_acc, j_acc)
    s = j_ed.stage1_scalar(primes_range(0, b1 + 100), b1)
    assert edwards.stage1_scalar(primes_range(0, b1 + 100), b1) == s
    np.testing.assert_array_equal(edwards.wnaf_digits(s), j_ed.wnaf_digits(s))
    # a later chunk's tape (no 2^k part)
    rest = primes_range(b1 // 2, b1 + 100)
    t_rest = edwards.stage1_tape(rest, b1, include_two=False)
    j_rest = j_ed.cached_stage1_tape(rest, b1, None, include_two=False)
    np.testing.assert_array_equal(t_rest[0], j_rest[0])
    assert t_rest[1] == j_rest[1]


@pytest.mark.parametrize("n,mersenne,b1", [(N71, None, 3000),
                                           (M127, (127, 1), 500)])
def test_run_tape_bit_equal_to_jnp(n, mersenne, b1):
    """The plain K9 against tpu_ecm's jnp edops.run_tape on the same arrays
    (handed across by convert.ed_state), 4 curves, the whole stage-1 tape:
    N71 in REDC mode at B1=3000 and M127 in fold mode at B1=500.  The
    result is also the oracle's point [s]P, projectively."""
    tctx, jctx = _ctxs(n, mersenne)
    jd = jnp_ops.device_ctx(jctx)
    td = torch_ops.device_ctx(tctx, "cpu")
    tape, lead, curves, _pts, table, acc0 = _state(edwards, tctx,
                                                   range(10, 14), b1)
    want = np.asarray(jax.jit(j_edops.run_tape)(
        jnp.asarray(acc0), jnp.asarray(tape), jnp.asarray(table), jd))
    acc, tab = convert.ed_state(acc0, table, tctx.p, "cpu")
    kernels.reset_launches()
    got = kernels.ed_tape(acc, tape, tab, td)
    assert got is acc and kernels.launches["ed_tape"] == 0
    np.testing.assert_array_equal(got.numpy(), want)
    from tpu_ecm_torch.limbs import layout
    m = tctx.n_int
    s = edwards.stage1_scalar(primes_range(0, b1 + 100), b1)
    for i, c in enumerate(curves[:2]):
        X, Y, Z = (tctx.from_mont_int(layout.unpack_batch(
            want[k], tctx.p.w)[i] % m) for k in range(3))
        Q = edwards.oracle_scalar_mul(s, c.x0, c.y0, c.d, m)
        assert X * Q[2] % m == Q[0] * Z % m
        assert Y * Q[2] % m == Q[1] * Z % m


def test_run_tape_bit_equal_to_pallas_interpret():
    """The plain K9 against the Pallas Edwards kernel in interpret mode on
    N71 at B=128, on the first 40 ops of the B1=2000 tape (doublings, adds
    and subtractions)."""
    tctx, jctx = _ctxs(N71)
    td = torch_ops.device_ctx(tctx, "cpu")
    tape, _lead, _c, _p, table, acc0 = _state(edwards, tctx, range(10, 138),
                                              2000)
    tape = np.ascontiguousarray(tape[:40])
    assert {int(op) for op in tape[:, 0]} == {0, 1, 2, 3}
    run = pallas_ops.make_edwards_executor(jctx, 128, table.shape[0],
                                           chunk=tape.shape[0],
                                           interpret=True)
    want = np.asarray(run(acc0, tape, table))
    acc, tab = convert.ed_state(acc0, table, tctx.p, "cpu")
    np.testing.assert_array_equal(kernels.ed_tape(acc, tape, tab, td).numpy(),
                                  want)


def test_wrapper_checks():
    tctx = t_params.make_monty(N71)
    td = torch_ops.device_ctx(tctx, "cpu")
    nw = tctx.p.nw
    acc = torch.zeros((4, nw, 4), dtype=torch.int32)
    tab = torch.zeros((16, 3, nw, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="opcode"):
        kernels.ed_tape(acc, np.asarray([[5, 0]], np.int32), tab, td)
    with pytest.raises(ValueError, match="table row"):
        kernels.ed_tape(acc, np.asarray([[2, 16]], np.int32), tab, td)
    with pytest.raises(ValueError, match="shape"):
        kernels.ed_tape(acc[:3].contiguous(), np.zeros((0, 2), np.int32),
                        tab, td)
    with pytest.raises(ValueError):
        convert.ed_state(np.zeros((4, nw, 4), np.int32),
                         np.zeros((8, 3, nw, 4), np.int32), tctx.p, "cpu")


def _cfgs(tmp_path, **kw):
    """The port's and the JAX driver's configurations of one run, each
    writing its files in its own directory."""
    out = []
    for tag, mod in (("t", driver), ("j", j_driver)):
        d = tmp_path / tag
        d.mkdir()
        extra = dict(device="cpu") if tag == "t" else {}
        out.append(mod.RunConfig(
            save_b1_path=str(d / "save_b1.txt"),
            checkpoint_path=str(d / "checkpoint.txt"),
            results_path=str(d / "ecm_results.txt"), verbose=0,
            curve_mode="edwards", **extra, **kw))
    return out


def test_stage1_find_and_save_file_match_jax(tmp_path):
    """tests/test_edwards.py's stage-1 find (N71, 4 curves from sigma 44,
    B1=300): sigma 46 finds P35 in stage 1, and save_b1.txt (tagged
    AVX-ECM-ED) is byte-equal to the JAX driver's."""
    t_cfg, j_cfg = _cfgs(tmp_path, n=N71, curves=4, b1=300, b2=300,
                         sigma=44)
    res = driver.ECMDriver(t_cfg).run()
    hit = [h for h in res.factors if h.factor == P35]
    assert hit and hit[0].stage == 1 and hit[0].sigma == 46, res.factors
    want = j_driver.ECMDriver(j_cfg).run()
    assert res.stage1_residues == want.stage1_residues
    got = (tmp_path / "t" / "save_b1.txt").read_bytes()
    assert got == (tmp_path / "j" / "save_b1.txt").read_bytes()
    assert got.count(b"PROGRAM=AVX-ECM-ED;") == 4


def test_stage2_find(tmp_path):
    """tests/test_edwards.py's stage-2 find: sigma 29 finds P35 in stage 2
    at B2=10000 through the Montgomery handoff."""
    t_cfg, _ = _cfgs(tmp_path, n=N71, curves=4, b1=300, b2=10000, sigma=28)
    res = driver.ECMDriver(t_cfg).run()
    hit = [h for h in res.factors if h.factor == P35]
    assert hit and hit[0].stage == 2 and hit[0].sigma == 29, res.factors


def test_chunked_checkpoints_match_jax(tmp_path):
    """Stage 1 over prime chunks of 500 (tests/test_edwards.py:168-202):
    checkpoint.txt, save_b1.txt and the stage-1 residues equal the JAX
    driver's byte for byte."""
    t_cfg, j_cfg = _cfgs(tmp_path, n=N71, curves=4, b1=1500, b2=1500,
                         sigma=9, prime_chunk=500)
    got = driver.ECMDriver(t_cfg).run()
    want = j_driver.ECMDriver(j_cfg).run()
    assert got.stage1_residues == want.stage1_residues
    for name in ("checkpoint.txt", "save_b1.txt"):
        t = (tmp_path / "t" / name).read_bytes()
        assert t == (tmp_path / "j" / name).read_bytes(), name
    assert (tmp_path / "t" / "checkpoint.txt").read_bytes().count(
        b"AVX-ECM-ED") == 8
