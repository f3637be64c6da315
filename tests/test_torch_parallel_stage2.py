"""Stage 2's other forms with the curve axis split: the N71 job of
tests/test_torch_parallel.py (8 curves from sigma 110, B1=300, B2=10000)
with cross="noinv" and with replay="gather" (a replay mode other than the
default), sharded over k = 2, 3 CPU devices, against tpu_ecm sharded over
as many virtual CPU devices: the same factor list, residues, curves_run,
file bytes and counters, with the reference's P35 at sigma 112.

tpu_ecm's RunConfig takes neither form: its runner reads the cross form
from TPU_ECM_CROSS, set here for the reference's noinv run alone, and on
the CPU it always replays by gather (tpu_ecm/stage2/exec.py:987-999), so
its default run is the gather reference."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_parallel import FULL, JOB, P35  # noqa: E402
from test_torch_parallel import assert_same, jax_run, port_run  # noqa: E402

torch.set_num_threads(1)

FORMS = {"noinv": dict(cross="noinv"), "gather": dict(replay="gather")}
# the reference's environment for each form
JAX_ENV = {"noinv": {"TPU_ECM_CROSS": "noinv"}, "gather": {}}


@pytest.fixture(scope="module")
def jax_forms(tmp_path_factory):
    """tpu_ecm's sharded runs of the job, once: each form at k = 2, 3."""
    root = tmp_path_factory.mktemp("jax_forms")
    out = {}
    for form, env in JAX_ENV.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("TPU_ECM_CROSS", raising=False)
            mp.delenv("TPU_ECM_REPLAY", raising=False)
            for key, val in env.items():
                mp.setenv(key, val)
            for k in (2, 3):
                out[(form, k)] = jax_run(root, f"{form}{k}", k,
                                         engine="digit", **JOB, **FULL)
    return out


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("form", list(FORMS))
def test_stage2_form_sharded_equals_tpu_ecm_sharded(tmp_path, jax_forms,
                                                    form, k):
    got = port_run(tmp_path, f"{form}{k}", k, engine="digit", **JOB,
                   **FULL, **FORMS[form])
    assert_same(got, jax_forms[(form, k)])
    assert (P35, 2, 2, 112) in got["factors"]
    if form == "noinv":
        assert got["counters"]["numinv"] == 0
