"""resume_stage2(sharder=) against tpu_ecm's resume_stage2(sharder=): the
N71 job's stage-1 save_b1.txt (8 curves from sigma 110, B1=300, written
by the port) resumed to B2=10000 over k = 2, 3 CPU devices and tpu_ecm's
as many virtual CPU devices.  Both group the records in multiples of the
device count (at k = 3: a group of 6 and a group of 2, padded to 3 by
repeating its last record) and give the same factor list (P35 at sigma
112 in stage 2), curves_run, counters and results lines."""

import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm.parallel import Sharder as JSharder  # noqa: E402
from tpu_ecm_torch import driver  # noqa: E402
from tpu_ecm_torch.parallel import Sharder  # noqa: E402

from test_torch_parallel import JOB, P35, port_run  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("saved")
    port_run(root, "s1", None, **dict(JOB, b2=300))
    return os.path.join(str(root), "port_s1", "save_b1.txt")


def _factors(res):
    return [(h.factor, h.stage, h.curve, h.sigma) for h in res.factors]


@pytest.mark.parametrize("k", [2, 3])
def test_resume_sharded_equals_tpu_ecm_sharded(tmp_path, saved, k):
    got_path, want_path = str(tmp_path / "port.txt"), str(tmp_path / "j.txt")
    got = driver.resume_stage2(saved, 10000, verbose=0, device="cpu",
                               results_path=got_path,
                               sharder=Sharder(["cpu"] * k))
    want = j_driver.resume_stage2(
        saved, 10000, verbose=0, results_path=want_path,
        cache_dir=str(tmp_path / "cache"),
        sharder=JSharder(jax.devices()[:k]))
    assert _factors(got) == _factors(want)
    assert (P35, 2, 2, 112) in _factors(got)
    assert got.curves_run == want.curves_run == 8
    assert got.counters == want.counters
    assert open(got_path).read() == open(want_path).read()
