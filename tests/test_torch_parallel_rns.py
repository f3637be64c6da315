"""The RNS engine's runs of tests/test_torch_parallel.py: N71, 8 curves
from sigma 110, B1=300, to B2=10000 in one prime chunk and stage 1 alone
with prime_chunk=100, sharded over k = 1, 2, 3 CPU devices, against
tpu_ecm's RNS engine sharded over as many virtual CPU devices: the same
factor list, residues, curves_run, file bytes and counters."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_parallel import (CHUNKED, FULL, JOB, P35,  # noqa: E402
                                 assert_same, jax_run, port_run)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_rns(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_rns")
    return {(k, name): jax_run(root, f"{k}_{name}", k, engine="rns",
                               **JOB, **run)
            for k in (2, 3)
            for name, run in (("full", FULL), ("chunked", CHUNKED))}


@pytest.mark.parametrize("k", [1, 2, 3])
def test_rns_sharded_equals_tpu_ecm_sharded(tmp_path, jax_rns, k):
    """Each shard keeps its own RnsCtx and RnsOps; the save files are the
    digit engine's bytes (tests/test_torch_rns.py) and the reference's."""
    for name, run in (("full", FULL), ("chunked", CHUNKED)):
        got = port_run(tmp_path, f"{k}_{name}", k, engine="rns", **JOB,
                       **run)
        want = jax_rns[(max(k, 2), name)]
        if k == 1:
            assert got["curves_run"] == 8
            got = dict(got, curves_run=want["curves_run"])
        assert_same(got, want)
        if name == "full":
            assert (P35, 2, 2, 112) in got["factors"]
