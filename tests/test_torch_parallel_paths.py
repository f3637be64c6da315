"""Edwards curves with the curve axis split (RunConfig.sharder): N71, 8
Edwards curves from sigma 28 (P35 at sigma 29 in stage 2), to B2=10000 in
one prime chunk and stage 1 alone with prime_chunk=100 (each checkpoint
normalizes the whole batch on the host, in curve order), sharded over
k = 2, 3 CPU devices, against tpu_ecm's one-device run of the same job
(the 8 or 9 curves that k rounds the batch to): the same factor list,
stage-1 residues, save_b1.txt, checkpoint.txt and ecm_results.txt bytes
and counters.  A fixed sigma makes tpu_ecm's results independent of its
mesh (tests/test_sharding.py), and a sharded jax run of each job would
add its compilation to tier 1.  The other paths of the split:
tests/test_torch_parallel.py (digit), tests/test_torch_parallel_rns.py,
tests/test_torch_parallel_fold.py, tests/test_torch_parallel_stage2.py
(noinv, gather) and tests/test_torch_parallel_resume.py."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_parallel import (CHUNKED, FULL, JOB, P35,  # noqa: E402
                                 assert_same, jax_run, port_run)

torch.set_num_threads(1)

EDWARDS = dict(JOB, sigma=28, curve_mode="edwards")


def rounded(curves, k):
    return -(-curves // k) * k


@pytest.fixture(scope="module")
def jax_edwards(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_edwards")
    return {(name, curves): jax_run(root, f"{name}_{curves}", None,
                                    **dict(EDWARDS, curves=curves, **run))
            for name, run in (("full", FULL), ("chunked", CHUNKED))
            for curves in (8, 9)}


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", ["full", "chunked"])
def test_edwards_sharded_equals_tpu_ecm(tmp_path, jax_edwards, name, k):
    run = FULL if name == "full" else CHUNKED
    got = port_run(tmp_path, f"{name}{k}", k, **EDWARDS, **run)
    assert_same(got, jax_edwards[(name, rounded(8, k))])
    if name == "full":
        assert (P35, 2, 29) in {(f, st, s) for f, st, _c, s in
                                got["factors"]}
    else:
        assert got["files"]["checkpoint.txt"].count(b"AVX-ECM-ED") == \
            2 * rounded(8, k)
