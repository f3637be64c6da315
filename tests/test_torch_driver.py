"""End-to-end runs of the PyTorch port's driver and CLI on the CPU (where
every kernel wrapper takes its plain version): the pinned-sigma N71 finds,
the golden sweep, the reference binary's save_b1.txt byte for byte, and
the same stage-1 residues as the JAX driver."""

import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm.io import savefile  # noqa: E402
from tpu_ecm_torch import driver  # noqa: E402
from tpu_ecm_torch.io import cli  # noqa: E402

from moduli import N256  # noqa: E402
from test_e2e import GOLDEN_SWEEP, N71, P35  # noqa: E402
from test_interop import FIXTURE  # noqa: E402

torch.set_num_threads(1)


def _cfg(tmp_path, **kw):
    kw.setdefault("save_b1_path", str(tmp_path / "save_b1.txt"))
    kw.setdefault("checkpoint_path", str(tmp_path / "checkpoint.txt"))
    kw.setdefault("results_path", str(tmp_path / "ecm_results.txt"))
    kw.setdefault("verbose", 0)
    kw.setdefault("device", "cpu")
    return driver.RunConfig(**kw)


def test_stage1_finds_factor(tmp_path):
    cfg = _cfg(tmp_path, n=N71, curves=4, b1=300, b2=300, sigma=172)
    res = driver.ECMDriver(cfg).run()
    assert {(h.factor, h.stage, h.sigma) for h in res.factors} \
        == {(P35, 1, 174)}
    with open(cfg.save_b1_path) as f:
        recs = list(savefile.parse_records(f))
    assert len(recs) == 4 and all(r.n == N71 and r.b1 == 300 for r in recs)
    assert str(P35) in open(cfg.results_path).read()


def test_stage2_finds_factor(tmp_path):
    cfg = _cfg(tmp_path, n=N71, curves=4, b1=300, b2=10000, sigma=110)
    res = driver.ECMDriver(cfg).run()
    assert (P35, 2, 112) in {(h.factor, h.stage, h.sigma)
                             for h in res.factors}


def test_golden_sigma_sweep(tmp_path):
    cfg = _cfg(tmp_path, n=N71, curves=128, b1=2000, b2=200000, sigma=110,
               stop_on_factor=False)
    res = driver.ECMDriver(cfg).run()
    assert {(h.factor, h.stage, h.sigma) for h in res.factors} \
        == GOLDEN_SWEEP


def test_savefile_bytes_match_reference_binary(tmp_path):
    """The config of tests/test_interop.py:37 through the port: save_b1.txt
    byte for byte equal to the reference binary's."""
    sv = tmp_path / "save_b1.txt"
    cfg = _cfg(tmp_path, n=N256, curves=8, b1=2000, b2=2000, sigma=110,
               save_b1_path=str(sv), checkpoint_path=None)
    driver.ECMDriver(cfg).run()
    with open(FIXTURE, "rb") as f:
        assert sv.read_bytes() == f.read()


def test_stage1_residues_and_checkpoints_match_jax_driver(tmp_path):
    """Multi-chunk stage 1 (prime_chunk=300, B1=900): the residues and the
    checkpoint.txt records equal the JAX driver's."""
    kw = dict(n=N71, curves=3, b1=900, b2=900, sigma=500, prime_chunk=300,
              verbose=0)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = driver.ECMDriver(_cfg(tmp_path / "t", **kw)).run()
    want = j_driver.ECMDriver(j_driver.RunConfig(
        save_b1_path=str(tmp_path / "j" / "save_b1.txt"),
        checkpoint_path=str(tmp_path / "j" / "checkpoint.txt"),
        results_path=str(tmp_path / "j" / "ecm_results.txt"),
        cache_dir=str(tmp_path / "cache"), **kw)).run()
    assert got.stage1_residues == want.stage1_residues
    for name in ("checkpoint.txt", "save_b1.txt"):
        assert (tmp_path / "t" / name).read_bytes() \
            == (tmp_path / "j" / name).read_bytes(), name
    assert got.counters == want.counters


def test_structure_checks(tmp_path):
    """Even inputs, perfect powers and probable primes are handled up front
    exactly as in the JAX driver."""
    res = driver.ECMDriver(_cfg(tmp_path, n=8 * N71, curves=4, b1=300,
                                b2=300, sigma=172)).run()
    assert {(h.factor, h.stage) for h in res.factors} \
        == {(2, 0), (P35, 1)}
    r = driver.ECMDriver(_cfg(tmp_path, n=9, curves=2, b1=100)).run()
    assert any(h.factor == 3 for h in r.factors) and r.curves_run == 0
    r = driver.ECMDriver(_cfg(tmp_path, n=101, curves=2, b1=100)).run()
    assert any(h.factor == 101 and h.is_prp for h in r.factors)
    with pytest.raises(ValueError):
        driver.ECMDriver(_cfg(tmp_path, n=64, curves=1, b1=100))


def test_unported_parts_raise(tmp_path):
    """Mersenne forms and Edwards name their ROADMAP item instead of
    running something else; beyond the digit engine's bound the driver
    takes the RNS engine, and an explicit digit request raises."""
    m101 = (1 << 101) - 1
    with pytest.raises(NotImplementedError, match="Mersenne"):
        driver.ECMDriver(_cfg(tmp_path, n=m101, curves=2, b1=100))
    res = driver.ECMDriver(_cfg(tmp_path, n=m101, curves=2, b1=100, b2=100,
                                sigma=900, force_no_mersenne=True)).run()
    assert res.curves_run == 2
    big = (1 << 2200) + 297                 # beyond the int32 digit bound
    assert driver.ECMDriver(_cfg(tmp_path, n=big * 3 * 5 * 7, curves=1,
                                 b1=100)).engine == "rns"
    with pytest.raises(ValueError, match="digit"):
        driver.ECMDriver(_cfg(tmp_path, n=big * 3 * 5 * 7, curves=1,
                              b1=100, engine="digit"))
    with pytest.raises(NotImplementedError, match="Edwards"):
        driver.ECMDriver(_cfg(tmp_path, n=N71, curves=1, b1=100,
                              curve_mode="edwards"))


def test_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["-device", "cpu", str(N71), "2", "300", "0", "300", "174"])
    assert rc == 0
    assert str(P35) in capsys.readouterr().out
    assert os.path.exists(tmp_path / "save_b1.txt")
    assert cli.main(["-edwards", str(N71), "2", "300"]) == 1
    rc = cli.main(["-device", "cpu", "-rns", str(N71), "2", "300", "0",
                   "300", "174"])
    assert rc == 0 and "engine: RNS" in capsys.readouterr().out
    assert cli.main(["-device", "tpu", str(N71), "2", "300"]) == 1
