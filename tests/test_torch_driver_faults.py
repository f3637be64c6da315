"""The port's repairs of two faults it copied from tpu_ecm's driver
(ROADMAP C.1, C.2), each held against the case that shows it, and the
divergence from tpu_ecm stated as such.

n = 7*q*r (q, r primes of 101 and 91 bits) with curves from sigma 6: the
Suyama curve of sigma 7 cannot be built mod n (7 | v = 4*sigma), so the
driver reports 7 at stage 0 and builds that curve from sigma 1,000,010.

* C.1: a construction hit is reported at the curve's own index in the
  run (base_idx + i), not at the batch's first curve; so is a hit of the
  Edwards window table (the curve whose sigma hit).
* C.2: every record of the curve (stage1_residues, save_b1.txt, finds)
  names the sigma it was built from, on both engines.

tpu_ecm reports curve 0 and records sigma 7 for that curve."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm_torch import driver  # noqa: E402
from tpu_ecm_torch.curve import suyama  # noqa: E402
from tpu_ecm_torch.io import savefile  # noqa: E402

torch.set_num_threads(1)


def _next_prime(x: int) -> int:
    while not all(pow(a, x - 1, x) == 1 for a in (2, 3, 5, 7, 11, 13)):
        x += 1
    return x


N7QR = 7 * _next_prime(2**100 + 12345) * _next_prime(2**90 + 6789)
# sigma 7's substitute: the driver retries with sigma + 1,000,003
SUBSTITUTE = 7 + 1_000_003


def _paths(tmp_path):
    return dict(save_b1_path=str(tmp_path / "save_b1.txt"),
                checkpoint_path=str(tmp_path / "checkpoint.txt"),
                results_path=str(tmp_path / "ecm_results.txt"), verbose=0)


def _run(tmp_path, **kw):
    return driver.ECMDriver(driver.RunConfig(
        n=N7QR, b1=200, b2=0, device="cpu", **_paths(tmp_path), **kw)).run()


def _saved_sigmas(tmp_path):
    with open(tmp_path / "save_b1.txt") as f:
        return [r.sigma for r in savefile.parse_records(f)]


@pytest.mark.parametrize("engine", ["digit", "rns"])
def test_substituted_curve_index_and_sigma(tmp_path, engine):
    """Two curves from sigma 6: the stage-0 hit of sigma 7 is reported at
    curve 1 (C.1); stage1_residues and save_b1.txt name 6 and 1,000,010,
    the sigmas the curves ran from, and so does every stage-1 find (C.2)."""
    res = _run(tmp_path, curves=2, sigma=6, engine=engine)
    assert [(h.factor, h.curve, h.sigma) for h in res.factors
            if h.stage == 0] == [(7, 1, 7)]
    assert [s for s, _x, _z in res.stage1_residues] == [6, SUBSTITUTE]
    assert _saved_sigmas(tmp_path) == [6, SUBSTITUTE]
    assert {(h.curve, h.sigma) for h in res.factors if h.stage == 1} \
        <= {(0, 6), (1, SUBSTITUTE)}


def test_tpu_ecm_records_requested_sigma(tmp_path):
    """The divergence, as tpu_ecm has it on the same case: the stage-0 hit
    at curve 0 and sigma 7 recorded for the curve built from 1,000,010."""
    res = j_driver.ECMDriver(j_driver.RunConfig(
        n=N7QR, curves=2, b1=200, b2=0, sigma=6, **_paths(tmp_path))).run()
    assert [(h.factor, h.curve, h.sigma) for h in res.factors
            if h.stage == 0] == [(7, 0, 7)]
    assert [s for s, _x, _z in res.stage1_residues] == [6, 7]
    assert _saved_sigmas(tmp_path) == [6, 7]


def test_edwards_build_hit_reports_curve(tmp_path):
    """Edwards curves from sigma 6: sigma 8 cannot be built mod n and is
    reported at its own index, curve 2; the records name the substitutes."""
    res = _run(tmp_path, curves=4, sigma=6, curve_mode="edwards")
    assert (7, 0, 2, 8) in {(h.factor, h.stage, h.curve, h.sigma)
                            for h in res.factors}
    sigmas = [s for s, _x, _z in res.stage1_residues]
    assert sigmas[:2] == [6, 7] and 8 not in sigmas
    assert _saved_sigmas(tmp_path) == sigmas


def test_edwards_window_table_hit_reports_curve(tmp_path, monkeypatch):
    """A hit while the Edwards window tables are built is reported at the
    index of the curve whose sigma hit (here the third of four), then the
    run stops as before."""

    hits = []

    def hit(ctx, curves, base_pts=None):
        hits.append(curves[2].sigma)
        raise suyama.FactorFoundDuringBuild(7, curves[2].sigma)

    monkeypatch.setattr(driver.edwards, "build_batch_tables", hit)
    d = driver.ECMDriver(driver.RunConfig(
        n=N7QR, curves=4, b1=200, b2=0, sigma=20, device="cpu",
        curve_mode="edwards", **_paths(tmp_path)))
    with pytest.raises(RuntimeError, match="window table"):
        d.run()
    h = d.factors[-1]
    assert (h.factor, h.stage, h.curve, h.sigma) == (7, 0, 2, hits[0])
