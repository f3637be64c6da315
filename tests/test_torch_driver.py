"""End-to-end runs of the PyTorch port's driver and CLI on the CPU (where
every kernel wrapper takes its plain version): the pinned-sigma N71 finds,
the golden sweep, the reference binary's save_b1.txt byte for byte, and
the same stage-1 residues as the JAX driver."""

import dataclasses
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

# the 416-bit semiprime of bench.py's flagship job
N416 = (205688069665150755269371147819668813122841983204197482918578443
        * 411376139330301510538742295639337626245683966408394965837157771)
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
    """What is still not ported or not supported raises instead of running
    something else: engine="rns" with Edwards curves, Edwards curves beyond
    the digit engine's bound, an explicit digit request there, an unknown
    curve mode; beyond the bound "auto" takes the RNS engine."""
    big = (1 << 2200) + 297                 # beyond the int32 digit bound
    assert driver.ECMDriver(_cfg(tmp_path, n=big * 3 * 5 * 7, curves=1,
                                 b1=100)).engine == "rns"
    with pytest.raises(ValueError, match="digit"):
        driver.ECMDriver(_cfg(tmp_path, n=big * 3 * 5 * 7, curves=1,
                              b1=100, engine="digit"))
    with pytest.raises(ValueError, match="suyama"):
        driver.ECMDriver(_cfg(tmp_path, n=big * 3 * 5 * 7, curves=1,
                              b1=100, curve_mode="edwards"))
    with pytest.raises(ValueError, match="suyama"):
        driver.ECMDriver(_cfg(tmp_path, n=N71, curves=1, b1=100,
                              engine="rns", curve_mode="edwards"))
    with pytest.raises(ValueError, match="curve_mode"):
        driver.ECMDriver(_cfg(tmp_path, n=N71, curves=1, b1=100,
                              curve_mode="weierstrass"))
    res = driver.ECMDriver(_cfg(tmp_path, n=(1 << 101) - 1, curves=2,
                                b1=100, b2=100, sigma=900,
                                force_no_mersenne=True)).run()
    assert res.curves_run == 2


def _j_cfg(tmp_path, **kw):
    return j_driver.RunConfig(
        save_b1_path=str(tmp_path / "save_b1.txt"),
        checkpoint_path=str(tmp_path / "checkpoint.txt"),
        results_path=str(tmp_path / "ecm_results.txt"), verbose=0, **kw)


def test_mersenne_residues_match_jax_driver(tmp_path):
    """The twin of tests/test_e2e.py:257-269: M101 = 2^101 - 1, 2 curves,
    B1 = B2 = 100 run mod M by the fold; the stage-1 residues and
    save_b1.txt (N = the input) equal the JAX driver's."""
    m101 = (1 << 101) - 1
    kw = dict(n=m101, curves=2, b1=100, b2=100, sigma=900)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    d = driver.ECMDriver(_cfg(tmp_path / "t", **kw))
    assert d.ctx.is_mersenne and d.ctx.n_int == m101 and d.engine == "digit"
    got = d.run()
    want = j_driver.ECMDriver(_j_cfg(tmp_path / "j", **kw)).run()
    assert got.stage1_residues == want.stage1_residues
    assert all(0 < x < m101 and 0 < z < m101
               for _s, x, z in got.stage1_residues)
    assert (tmp_path / "t" / "save_b1.txt").read_bytes() \
        == (tmp_path / "j" / "save_b1.txt").read_bytes()


@pytest.mark.parametrize("n,form,b2", [((1 << 128) + 1, (128, -1), 3000),
                                       ((1 << 202) - 225, (202, 225), 200)])
def test_special_forms_match_jax_driver(tmp_path, n, form, b2):
    """F7 = 2^128 + 1 (c = -1, the sign of the fold) with a short stage 2,
    and the composite 2^202 - 225 (a pseudo-Mersenne c of one digit)
    through stage 1, in both drivers: the contexts, stage-1 residues,
    save_b1.txt and factor finds are equal."""
    kw = dict(n=n, curves=2, b1=200, b2=b2, sigma=31, stop_on_factor=False)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    d = driver.ECMDriver(_cfg(tmp_path / "t", **kw))
    jd = j_driver.ECMDriver(_j_cfg(tmp_path / "j", **kw))
    assert (d.ctx.mersenne_e, d.ctx.mersenne_c) == form
    assert dataclasses.asdict(d.ctx) == dataclasses.asdict(jd.ctx)
    got, want = d.run(), jd.run()
    assert got.stage1_residues == want.stage1_residues
    assert {(h.factor, h.stage, h.sigma) for h in got.factors} \
        == {(h.factor, h.stage, h.sigma) for h in want.factors}
    assert (tmp_path / "t" / "save_b1.txt").read_bytes() \
        == (tmp_path / "j" / "save_b1.txt").read_bytes()


@pytest.mark.parametrize("n,engine,curve_mode,want", [
    ((1 << 1277) - 1, "auto", "suyama", "digit"),
    (N416, "auto", "edwards", "digit"),
    (N71, "rns", "edwards", ValueError),
    (N71, "rns", "suyama", "rns"),
])
def test_engine_routing_matches_jax(tmp_path, n, engine, curve_mode, want):
    """The engine each driver picks for M1277, the 416-bit N with Edwards
    curves and an explicit RNS request, or the error both raise."""
    kw = dict(n=n, curves=1, b1=100, engine=engine, curve_mode=curve_mode)
    if want is ValueError:
        for make in (lambda: driver.ECMDriver(_cfg(tmp_path, **kw)),
                     lambda: j_driver.ECMDriver(_j_cfg(tmp_path, **kw))):
            with pytest.raises(ValueError, match="suyama"):
                make()
        return
    got = driver.ECMDriver(_cfg(tmp_path, **kw))
    assert got.engine == j_driver.ECMDriver(_j_cfg(tmp_path, **kw)).engine \
        == want
    assert got.ctx.is_mersenne == (n == (1 << 1277) - 1)


def test_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["-device", "cpu", str(N71), "2", "300", "0", "300", "174"])
    assert rc == 0
    assert str(P35) in capsys.readouterr().out
    assert os.path.exists(tmp_path / "save_b1.txt")
    assert cli.main(["-device", "cpu", "-resume", "save_b1.txt",
                     "1000"]) == 0
    assert "resumed 2 curves" in capsys.readouterr().out
    rc = cli.main(["-device", "cpu", "2^101-1", "2", "100", "0", "100",
                   "900"])
    assert rc == 0 and "2^101-1" in capsys.readouterr().out
    rc = cli.main(["-device", "cpu", "-rns", str(N71), "2", "300", "0",
                   "300", "174"])
    assert rc == 0 and "engine: RNS" in capsys.readouterr().out
    assert cli.main(["-device", "tpu", str(N71), "2", "300"]) == 1
