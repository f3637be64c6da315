"""ROADMAP C.4: an Edwards savefile (PROGRAM=AVX-ECM-ED, whose SIGMA is an
Edwards seed) resumed by the port's driver.resume_stage2 rebuilds the
Edwards curve and finds what the Edwards run found in stage 2; tpu_ecm's
resume of the same file rebuilds Suyama curves from those seeds and
finds nothing (pinned here as the reference's fault)."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm_torch import driver  # noqa: E402
from tpu_ecm_torch.io import savefile  # noqa: E402

from test_e2e import N71, P35  # noqa: E402

torch.set_num_threads(1)


def _hits(res):
    return {(h.factor, h.stage, h.sigma) for h in res.factors}


def test_edwards_savefile_resumes_the_edwards_curve(tmp_path):
    """ROADMAP C.4: Edwards curves on N71 from sigma 28 find P35 at sigma
    29 in stage 2 (B2=10000); their stage-1 file (B2=B1=300, PROGRAM=
    AVX-ECM-ED) resumed to B2=10000 by the port rebuilds each Edwards
    curve and finds the same, while tpu_ecm's resume of the file (the
    bytes its own Edwards run writes, tests/test_torch_edwards.py)
    rebuilds Suyama curves from the Edwards seeds and finds nothing (the
    pinned fault of the reference)."""
    sv = str(tmp_path / "save_b1.txt")
    full = driver.ECMDriver(driver.RunConfig(
        n=N71, curves=4, b1=300, b2=10000, sigma=28, curve_mode="edwards",
        stop_on_factor=False, save_b1_path=sv, checkpoint_path=None,
        results_path=None, verbose=0, device="cpu")).run()
    assert (P35, 2, 29) in _hits(full)
    with open(sv) as f:
        assert {r.program for r in savefile.parse_records(f)} \
            == {"AVX-ECM-ED"}
    res = driver.resume_stage2(sv, 10000, verbose=0, device="cpu",
                               results_path=None)
    assert _hits(res) == _hits(full)
    assert (P35, 2, 29) in _hits(res)

    pinned = j_driver.resume_stage2(sv, 10000, verbose=0,
                                    results_path=None,
                                    cache_dir=str(tmp_path / "cache"))
    assert pinned.factors == []
