"""Stage 2 from a stage-1 savefile in the port (driver.resume_stage2 and
the CLI's -resume) held against tpu_ecm's: the sigma-112 find on N71 and
the B2 <= B1 guard rail (tests/test_e2e.py:76), grouped and single-group
resumes with equal finds (the non-sharded half of tests/test_e2e.py:95),
the RNS engine's resume (tests/test_rns_engine.py:282), mixed program
tags refused, and -resume on the CPU.  The reference binary's savefile:
tests/test_torch_resume_fixture.py; an Edwards savefile (ROADMAP C.4):
tests/test_torch_resume_edwards.py."""

import random

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tpu_ecm_torch import driver  # noqa: E402
from tpu_ecm_torch.io import cli, savefile  # noqa: E402

from test_e2e import N71, P35  # noqa: E402

torch.set_num_threads(1)


def _run(tmp_path, tag, **kw):
    """A port run on the CPU writing save_b1.txt under tmp_path/tag."""
    d = tmp_path / tag
    d.mkdir()
    kw.setdefault("stop_on_factor", False)
    res = driver.ECMDriver(driver.RunConfig(
        save_b1_path=str(d / "save_b1.txt"), checkpoint_path=None,
        results_path=None, verbose=0, device="cpu", **kw)).run()
    return res, str(d / "save_b1.txt")


def _resume(path, b2, **kw):
    kw.setdefault("results_path", None)
    return driver.resume_stage2(path, b2, verbose=0, device="cpu", **kw)


def _hits(res):
    return {(h.factor, h.stage, h.sigma) for h in res.factors}


def test_resume_finds_sigma_112(tmp_path):
    """tests/test_e2e.py:76: stage 1 of N71's curves from sigma 110 to
    B1=300, resumed to B2=10000, finds P35 at sigma 112 in stage 2, as the
    full run does, with the full run's stage-2 counters; a record whose
    saved Z already holds P35 (sigma 174) is reported in stage 1 at
    record index 4; B2 <= B1 raises."""
    # save_b1.txt is written at the end of stage 1, before stage 2
    full, sv = _run(tmp_path, "full", n=N71, curves=4, b1=300, b2=10000,
                    sigma=110)
    _res, sv174 = _run(tmp_path, "s174", n=N71, curves=1, b1=300, b2=300,
                       sigma=174)
    with open(sv, "a") as f, open(sv174) as g:
        f.write(g.read())
    res = _resume(sv, 10000)
    assert (P35, 2, 112) in _hits(res)
    assert _hits(res) == _hits(full) | {(P35, 1, 174)}
    assert [h.curve for h in res.factors if h.sigma == 174] == [4]
    assert res.curves_run == 5 and res.stage1_residues == []
    assert res.timings["build"] >= 0
    for k in ("paired", "numinv"):
        assert res.counters[k] == full.counters[k], k
    with pytest.raises(ValueError, match="B2"):
        _resume(sv, 300)


def test_resume_groups_equal_one_group(tmp_path):
    """The non-sharded half of tests/test_e2e.py:95 at 12 records: groups
    of 8 (8, 4) give the finds of one group, with the same record indices
    (sigma 112 is record 8, in the second group), the counters add up per
    group, and every record is run."""
    _res, sv = _run(tmp_path, "s1", n=N71, curves=12, b1=300, b2=300,
                    sigma=104)
    whole = _resume(sv, 1500)
    parts = _resume(sv, 1500, batch=8)
    assert (P35, 2, 112) in _hits(whole)

    def located(res):
        return {(h.factor, h.stage, h.sigma, h.curve) for h in res.factors}

    assert located(parts) == located(whole)
    assert (P35, 2, 112, 8) in located(whole)
    assert parts.curves_run == whole.curves_run == 12
    assert parts.counters["paired"] == 2 * whole.counters["paired"]


def test_rns_resume_finds_sigma_112(tmp_path):
    """tests/test_rns_engine.py:282 on the port's RNS engine (chosen by
    keyword: the port's "auto" keeps digits below ~2000 bits): P35 times
    a 1500-bit prp, resumed to B2=10000, finds P35 at sigma 112."""
    rng = random.Random(5)
    while True:
        c = rng.getrandbits(1500) | 1 | (1 << 1499)
        if all(pow(a, c - 1, c) == 1 for a in (2, 3, 5, 7, 11)):
            break
    n = P35 * c
    _res, sv = _run(tmp_path, "s1", n=n, curves=4, b1=300, b2=300,
                    sigma=110, engine="rns")
    res = _resume(sv, 10000, engine="rns")
    assert any(h.factor % P35 == 0 and h.stage == 2 and h.sigma == 112
               for h in res.factors), res.factors


def test_resume_refusals(tmp_path):
    """Mixed program tags, mixed inputs, a small SIGMA, a foreign
    parameterization and an empty file raise ValueError."""
    rec = savefile.format_record(savefile.SaveRecord(
        sigma=110, b1=300, n=N71, x=5, z=7))
    cases = (
        ("mixed", rec + rec.replace("110", "111").replace(
            "AVX-ECM", "AVX-ECM-ED"), "AVX-ECM-ED"),
        ("inputs", rec + rec.replace(f"N=0x{N71:x}", f"N=0x{3 * N71:x}"),
         "mixes inputs"),
        ("sigma", rec.replace("SIGMA=110", "SIGMA=5"), "SIGMA"),
        ("param", rec.replace("SIGMA=110", "SIGMA=1:110"), "param"),
    )
    for name, text, what in cases:
        (tmp_path / name).write_text(text)
        with pytest.raises(ValueError, match=what):
            _resume(str(tmp_path / name), 10000)
    (tmp_path / "empty").write_text("")
    with pytest.raises(ValueError, match="no savefile records"):
        _resume(str(tmp_path / "empty"), 10000)


def test_cli_resume_on_cpu(tmp_path, capsys, monkeypatch):
    """python -m tpu_ecm_torch -device cpu -resume save_b1.txt 10000:
    tpu_ecm's output lines; a missing B2 prints the usage, a bad file
    'resume failed'."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-device", "cpu", str(N71), "4", "300", "0", "300",
                     "110"]) == 0
    capsys.readouterr()
    assert cli.main(["-device", "cpu", "-resume", "save_b1.txt",
                     "1e4"]) == 0
    out = capsys.readouterr().out
    assert f"final: PRP11 factor {P35} (stage 2, sigma 112)" in out
    assert "resumed 4 curves; timings: " in out
    assert cli.main(["-device", "cpu", "-resume", "save_b1.txt"]) == 1
    assert "-resume $savefile $B2" in capsys.readouterr().out
    assert cli.main(["-device", "cpu", "-resume", "missing.txt",
                     "1e4"]) == 1
    assert "resume failed" in capsys.readouterr().out
