"""The full nine-rule PRAC set of the port (curve/prac.py `full=True`,
RunConfig.full_prac) held against tpu_ecm's: the same chains and stage-1
tapes for several B1, legal differential adds computing [p]P (the twin of
tests/test_curve.py:56-85), and through the driver on both engines the
same stage-1 residues as tpu_ecm's full_prac run and, normalized, as the
reduced rule set's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm.curve import prac as j_prac  # noqa: E402
from tpu_ecm.primes import primes_range  # noqa: E402
from tpu_ecm_torch import driver, params  # noqa: E402
from tpu_ecm_torch.curve import oracle, prac, suyama  # noqa: E402
from tpu_ecm_torch.limbs import kernels  # noqa: E402

from test_e2e import N71  # noqa: E402

torch.set_num_threads(1)

P61 = (1 << 61) - 1


@pytest.mark.parametrize("b1", [300, 2000, 20000])
def test_full_stage1_tape_equals_tpu_ecm(b1):
    """stage1_tape(full=True) equals tpu_ecm's op for op, with and without
    the leading doublings; the default stays the reduced set (the native
    planner's tape where it loads) and differs from the full one."""
    primes = primes_range(0, b1)
    for two in (True, False):
        got = prac.stage1_tape(primes, b1, include_two=two, full=True)
        want = j_prac.stage1_tape(primes, b1, include_two=two, full=True)
        np.testing.assert_array_equal(got, want)
    reduced = prac.stage1_tape(primes, b1)
    np.testing.assert_array_equal(
        reduced, j_prac.stage1_tape(primes, b1, full=False))
    np.testing.assert_array_equal(
        reduced, prac.stage1_tape(primes, b1, allow_native=False))
    assert not np.array_equal(reduced, got)


def test_full_prac_chains_equal_tpu_ecm_and_validate():
    """Every prime below 5000: the full chain equals tpu_ecm's (and its
    cost and ratio), and every op is a legal differential add ending in
    [p]P (tests/test_curve.py:56)."""
    for p in primes_range(3, 5000).tolist():
        got, want = [], []
        prac.prac_tape(p, got, full=True)
        j_prac.prac_tape(p, want, full=True)
        assert got == want, p
        assert prac.best_ratio(p, full=True) == j_prac.best_ratio(p,
                                                                  full=True)
        prac.validate_tape(np.asarray(got, np.int32), p)


def test_full_prac_matches_ladder():
    """tests/test_curve.py:68 on the port's oracle: full-rule tapes compute
    [p]P, projectively equal to the ladder's."""
    ctx = params.make_monty(P61)
    dom = oracle.IntDomain(ctx)
    ci = suyama.build_one_curve(ctx, 1234577)
    for p in (127, 1009, 65537, 999983):
        tape = []
        prac.prac_tape(p, tape, full=True)
        xp, zp = oracle.run_tape_int(ctx, tape, ci.x_mont, ci.z_mont,
                                     ci.s_mont)[0]
        xl, zl = oracle.ladder_int(dom, ci.x_mont, ci.z_mont, ci.s_mont, p)
        assert (xp * zl - xl * zp) % P61 == 0, p


@pytest.mark.parametrize("engine", ["digit", "rns"])
def test_driver_full_prac_residues(tmp_path, engine):
    """N71, 4 curves from sigma 110, B1=300, multi-chunk stage 1
    (prime_chunk=100): full_prac=True gives tpu_ecm's full_prac residues
    (sigma, X, Z) exactly, and the reduced set's once normalized (X/Z
    mod n: another chain, the same point)."""
    kw = dict(n=N71, curves=4, b1=300, b2=300, sigma=110, prime_chunk=100,
              verbose=0, save_b1_path=None, checkpoint_path=None,
              results_path=None)

    def port(full):
        kernels.reset_launches()
        return driver.ECMDriver(driver.RunConfig(
            device="cpu", engine=engine, full_prac=full, **kw)).run()

    full, reduced = port(True), port(False)
    want = j_driver.ECMDriver(j_driver.RunConfig(
        full_prac=True, cache_dir=str(tmp_path / "cache"), **kw)).run()
    assert full.stage1_residues == want.stage1_residues
    assert full.counters == want.counters
    assert full.counters["ptadds"] != reduced.counters["ptadds"]
    for (s, x, z), (s2, x2, z2) in zip(full.stage1_residues,
                                       reduced.stage1_residues):
        assert s == s2 and x * pow(z, -1, N71) % N71 \
            == x2 * pow(z2, -1, N71) % N71
