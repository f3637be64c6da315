"""The reference binary's save_b1.txt (tests/fixtures/ref_n256_save_b1.txt)
resumed by the port's driver.resume_stage2 and by tpu_ecm's: the same
finds and stage-2 counters (ROADMAP A.13)."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm_torch import driver  # noqa: E402

from test_interop import FIXTURE  # noqa: E402

torch.set_num_threads(1)

COUNTERS = ("paired", "ptadds", "ptdups", "numinv")


def test_reference_fixture_resumes_like_tpu_ecm(tmp_path):
    """The reference binary's save_b1.txt (N256, 8 curves, B1=2000)
    resumed to B2=6000 by the port and by tpu_ecm: the same finds and
    stage-2 counters."""
    got = driver.resume_stage2(FIXTURE, 6000, verbose=0, device="cpu",
                               results_path=None)
    want = j_driver.resume_stage2(FIXTURE, 6000, verbose=0,
                                  results_path=None,
                                  cache_dir=str(tmp_path / "cache"))
    assert [(h.factor, h.stage, h.sigma) for h in got.factors] \
        == [(h.factor, h.stage, h.sigma) for h in want.factors]
    assert {k: got.counters[k] for k in COUNTERS} \
        == {k: want.counters[k] for k in COUNTERS}
    assert got.curves_run == want.curves_run == 8
