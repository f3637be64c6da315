"""Two parity checks of the port on special-form inputs (the fold, M = 2^e
- c) against tpu_ecm on the CPU:

  noinv    the cross="noinv" stage-2 runner on fold contexts, 2^89 - 1 and
           the pseudo-Mersenne prime 2^64 - 59: the same accumulator
           digits, Pb table, finds and counters as tpu_ecm's noinv runner
           on the same stage-1 points (tests/test_torch_noinv.py holds the
           REDC modulus P61)
  resume   M101 = 2^101 - 1's stage-1 save_b1.txt (4 curves from sigma
           500, B1=2000) resumed to B2=150,000 by both packages'
           resume_stage2: the same finds (the P13 at sigma 502 in stage
           2), counters and results lines, on one device and sharded over
           2 devices"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm import params  # noqa: E402
from tpu_ecm.limbs import jnp_ops  # noqa: E402
from tpu_ecm.parallel import Sharder as JSharder  # noqa: E402
from tpu_ecm.primes import primes_range  # noqa: E402
from tpu_ecm.stage2 import exec as j_exec  # noqa: E402
from tpu_ecm.stage2 import plan as j_plan  # noqa: E402
from tpu_ecm_torch import convert, driver  # noqa: E402
from tpu_ecm_torch.parallel import Sharder  # noqa: E402
from tpu_ecm_torch.stage2 import exec as t_exec  # noqa: E402
from tpu_ecm_torch.stage2 import plan as t_plan  # noqa: E402

from test_torch_noinv import B1, _stage1_points  # noqa: E402
from test_torch_parallel import port_run  # noqa: E402

torch.set_num_threads(1)

M101 = (1 << 101) - 1
M101_P13 = 7432339208719
FOLDS = {"2^89-1": (89, 1), "2^64-59": (64, 59)}
B2 = 8000


@functools.lru_cache(maxsize=None)
def _jax_noinv(name):
    """A fold context, the stage-1 points of tests/test_torch_noinv.py's
    sigmas on it, the pairmap to B2 and tpu_ecm's noinv runner after its
    one chunk."""
    e, c = FOLDS[name]
    ctx = params.make_monty((1 << e) - c, mersenne=(e, c))
    assert ctx.is_mersenne
    jd = jnp_ops.device_ctx(ctx)
    pt, s_const = _stage1_points(ctx)
    sp = j_plan.make_stage2_params(B1, B2)
    pmap = j_plan.pair(sp, primes_range(B1, B2 + 1000), B1, B2)[:3]
    jr = j_exec.Stage2Runner(ctx, jd, sp, jnp.asarray(pt),
                             jnp.asarray(s_const), B1, cross="noinv")
    jr.init()
    jr.run_chunk(*pmap)
    tdc = convert.device_ctx(np.asarray(jd.n), np.asarray(jd.c), jd.p,
                             jd.nprime, jd.mersenne_e, jd.mersenne_c_sign,
                             "cpu")
    return ctx, tdc, pt, s_const, pmap, jr


@pytest.mark.parametrize("name", list(FOLDS))
def test_noinv_on_the_fold_equals_tpu_ecm(name):
    """The port's noinv runner on a fold context: acc and the (X, Z, X*Z)
    Pb table digit for digit tpu_ecm's, and the same harvest (acc mod n,
    factors) and counters, with no inversion."""
    ctx, tdc, pt, s_const, pmap, jr = _jax_noinv(name)
    sp = t_plan.make_stage2_params(B1, B2)
    tr = t_exec.Stage2Runner(ctx, tdc, sp, torch.from_numpy(pt.copy()),
                             torch.from_numpy(s_const.copy()),
                             cross="noinv")
    tr.init()
    tr.run_chunk(*pmap)
    np.testing.assert_array_equal(tr.pbx.numpy(), np.asarray(jr.pbx))
    np.testing.assert_array_equal(tr.acc.numpy(), np.asarray(jr.acc))
    got, want = tr.result(), jr.result()
    assert got.acc == want.acc and got.factors == want.factors
    assert (got.paired, got.ptadds, got.ptdups, got.numinv) == (
        want.paired, want.ptadds, want.ptdups, 0)


@pytest.fixture(scope="module")
def m101_save(tmp_path_factory):
    root = tmp_path_factory.mktemp("m101")
    port_run(root, "s1", None, n=M101, curves=4, b1=2000, b2=2000,
             sigma=500)
    return str(root / "port_s1" / "save_b1.txt")


@pytest.mark.parametrize("k", [None, 2])
def test_resume_of_a_fold_savefile_equals_tpu_ecm(tmp_path, m101_save, k):
    """Both resumes of M101's save file run the fold (the records' N is
    the input) and report the P13 at sigma 502 in stage 2, with the same
    factor list, counters and results lines."""
    got = driver.resume_stage2(
        m101_save, 150_000, verbose=0, device="cpu",
        results_path=str(tmp_path / "port.txt"),
        sharder=Sharder(["cpu"] * k) if k else None)
    want = j_driver.resume_stage2(
        m101_save, 150_000, verbose=0, results_path=str(tmp_path / "j.txt"),
        cache_dir=str(tmp_path / "cache"),
        sharder=JSharder(jax.devices()[:k]) if k else None)
    hits = [(h.factor, h.stage, h.curve, h.sigma) for h in got.factors]
    assert hits == [(h.factor, h.stage, h.curve, h.sigma)
                    for h in want.factors]
    assert (M101_P13, 2, 2, 502) in hits
    assert got.work_modulus == want.work_modulus == M101
    assert got.counters == want.counters
    assert (open(tmp_path / "port.txt").read()
            == open(tmp_path / "j.txt").read())
