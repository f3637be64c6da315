"""The port's own copies of the JAX package's host modules (params, primes,
native, io.calc, io.savefile, utils.rng) held equal to their originals on
the same inputs.  The port imports nothing of tpu_ecm; these tests import
both."""

import dataclasses
import random

import numpy as np
import pytest

pytest.importorskip("torch")

from tpu_ecm import params as j_params  # noqa: E402
from tpu_ecm.io import calc as j_calc  # noqa: E402
from tpu_ecm.io import savefile as j_savefile  # noqa: E402
from tpu_ecm.native import lib as j_native  # noqa: E402
from tpu_ecm.primes import sieve as j_sieve  # noqa: E402
from tpu_ecm.utils import rng as j_rng  # noqa: E402
from tpu_ecm_torch import params as t_params  # noqa: E402
from tpu_ecm_torch.io import calc as t_calc  # noqa: E402
from tpu_ecm_torch.io import savefile as t_savefile  # noqa: E402
from tpu_ecm_torch.native import lib as t_native  # noqa: E402
from tpu_ecm_torch.primes import sieve as t_sieve  # noqa: E402
from tpu_ecm_torch.utils import rng as t_rng  # noqa: E402

from test_acceptance import REFSWEEP_ROWS  # noqa: E402


def test_radix_selection_equal():
    """select_radix and _radix_or_host_only for every bit size 32..2500."""
    for nbits in range(32, 2501):
        assert t_params._radix_or_host_only(nbits) \
            == j_params._radix_or_host_only(nbits), nbits
        if j_params._radix_or_host_only(nbits)[3]:
            assert t_params.select_radix(nbits) \
                == j_params.select_radix(nbits), nbits


def _forms():
    """Seeded random odd moduli and the special forms: Mersenne, 2^e + 1
    and pseudo-Mersenne, each with the (e, c) make_monty takes."""
    rng = random.Random(0x5EED)
    out = [(rng.getrandbits(bits) | 1 | (1 << (bits - 1)), None)
           for bits in (40, 64, 127, 256, 416, 777, 1277, 2048, 2400)]
    out += [((1 << e) - 1, (e, 1)) for e in (61, 89, 127, 521, 1277)]
    out += [((1 << 128) + 1, (128, -1)), ((1 << 256) + 1, (256, -1))]
    out += [((1 << 255) - 19, (255, 19)),
            ((1 << 521) - 1099511627791, (521, 1099511627791))]
    return out


@pytest.mark.parametrize("force_w", [None, 10])
def test_make_monty_fields_equal(force_w):
    for n, mers in _forms():
        if force_w and n.bit_length() > 600:
            continue
        t = t_params.make_monty(n, mersenne=mers, force_w=force_w)
        j = j_params.make_monty(n, mersenne=mers, force_w=force_w)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), (n, mers)
        for x in (0, 1, 12345, n - 2):
            assert t.to_mont_int(x) == j.to_mont_int(x)
            assert t.from_mont_int(x) == j.from_mont_int(x)


def test_special_form_helpers_equal():
    """detect_mersenne, strip_algebraic_factors, mersenne_density_ok,
    perfect_power and iroot on the cases of tests/test_limbs.py:160-180 and
    a few more."""
    cases = [(1 << 127) - 1, 5704689200685129054721, (1 << 255) - 19,
             ((1 << 101) + 5) * 3 + 2, (1 << 128) + 1, (1 << 202) - 225,
             2361183246142106764907, (1 << 15) - 1, (1 << 33) - 1]
    for n in cases:
        assert t_params.detect_mersenne(n) == j_params.detect_mersenne(n), n
        assert t_params.perfect_power(n) == j_params.perfect_power(n)
    for n, e, c in (((1 << 15) - 1, 15, 1), ((1 << 33) - 1, 33, 1),
                    ((1 << 105) + 1, 105, -1), ((1 << 127) - 1, 127, 1)):
        assert t_params.strip_algebraic_factors(n, e, c) \
            == j_params.strip_algebraic_factors(n, e, c)
        assert t_params.mersenne_density_ok(n, e) \
            == j_params.mersenne_density_ok(n, e)
    assert t_params.strip_algebraic_factors((1 << 15) - 1, 15, 1) == 151
    for x, k in ((10**40 + 7, 2), (3**99, 3), (2**64 - 1, 5)):
        assert t_params.iroot(x, k) == j_params.iroot(x, k)


def test_stage2_cost_model_equal():
    for b1, b2 in ((300, 10000), (2000, 200000), (10**5, 10**7),
                   (10**6, 10**8)):
        d = j_params.choose_stage2_D(b1)
        assert t_params.choose_stage2_D(b1) == d
        assert t_params.choose_stage2_U(b1, b2, d) \
            == j_params.choose_stage2_U(b1, b2, d)
        assert t_params.choose_stage2_U_tpu(b1, b2, d) \
            == j_params.choose_stage2_U_tpu(b1, b2, d)


def test_primes_native_and_python_equal(monkeypatch):
    """primes_range (native and pure Python) and PrimeStream chunks."""
    for lo, hi in ((0, 100), (0, 100_000), (999_000, 1_001_000),
                   (10**8, 10**8 + 5000)):
        want = j_sieve.primes_range(lo, hi)
        np.testing.assert_array_equal(t_sieve.primes_range(lo, hi), want)
        np.testing.assert_array_equal(t_native.primes_range(lo, hi), want)
    want = [(lo, hi, p.tolist()) for lo, hi, p
            in j_sieve.PrimeStream(3000).chunks(0, 20_000)]
    got = [(lo, hi, p.tolist()) for lo, hi, p
           in t_sieve.PrimeStream(3000).chunks(0, 20_000)]
    assert got == want
    monkeypatch.setattr(t_sieve, "_get_native", lambda: None)
    np.testing.assert_array_equal(t_sieve.primes_range(0, 100_000),
                                  j_sieve.primes_range(0, 100_000))


def test_native_planners_equal():
    """The native stage-1 tape and pair() plan at B1=1e4, B2=1e6."""
    assert t_native.available() and j_native.available()
    b1, b2 = 10_000, 1_000_000
    primes = j_sieve.primes_range(0, b1)
    np.testing.assert_array_equal(t_native.stage1_tape(primes, b1, True),
                                  j_native.stage1_tape(primes, b1, True))
    p2 = j_sieve.primes_range(b1, b2 + 1000)
    d = j_params.choose_stage2_D(b1)
    u = j_params.choose_stage2_U_tpu(b1, b2, d)
    got, want = t_native.pair(p2, b1, b2, d, u), j_native.pair(p2, b1, b2,
                                                               d, u)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_native_builds_outside_the_sources():
    path = t_native.library_path()
    assert "/build/tpu_ecm_torch/" in path.replace("\\", "/")
    assert path.endswith(".so")


@pytest.mark.parametrize("row", REFSWEEP_ROWS, ids=lambda r: f"row{r[0]}")
def test_calc_equal(row):
    """calc.calc on the expressions of tests/test_acceptance.py."""
    assert t_calc.calc(row[1]) == j_calc.calc(row[1])


def test_calc_more_expressions():
    for expr in ("2^127-1", "fib(791)/13/677/216416017", "(2+109!)/446",
                 "10^20+39", "3*5*7", "luc(200)", "modexp(3,200,1009)"):
        assert t_calc.calc(expr) == j_calc.calc(expr), expr


def test_savefile_bytes_and_parse_equal(tmp_path):
    rng = random.Random(3)
    recs = []
    for i in range(6):
        n = rng.getrandbits(400) | 1
        recs.append(dict(sigma=rng.getrandbits(63), b1=10_000 + i, n=n,
                         x=rng.randrange(n), z=rng.randrange(n),
                         program=("AVX-ECM", "AVX-ECM-ED")[i % 2]))
    tp, jp = tmp_path / "t.txt", tmp_path / "j.txt"
    t_savefile.append_records(str(tp), [t_savefile.SaveRecord(**r)
                                        for r in recs])
    j_savefile.append_records(str(jp), [j_savefile.SaveRecord(**r)
                                        for r in recs])
    assert tp.read_bytes() == jp.read_bytes()
    with open(tp) as f:
        got = [dataclasses.asdict(r) for r in t_savefile.parse_records(f)]
    with open(jp) as f:
        want = [dataclasses.asdict(r) for r in j_savefile.parse_records(f)]
    assert got == want and len(got) == 6
    for f in (2, 34359738421, 2361183246142106764907, (1 << 127) - 1):
        assert t_savefile.classify_factor(f) == j_savefile.classify_factor(f)


def test_sigma_gen_and_hash_equal():
    for base in (0, 7000):
        t, j = t_rng.SigmaGen(base, 0xC0FFEE), j_rng.SigmaGen(base, 0xC0FFEE)
        assert [t.next() for _ in range(1000)] \
            == [j.next() for _ in range(1000)]
    for x in (0, 1, 12345, (1 << 64) - 1):
        assert t_rng.hash64(x) == j_rng.hash64(x)
