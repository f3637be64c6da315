"""Tests that need an NVIDIA GPU (marker `cuda`; they skip without one):
the five CUDA kernels against their plain PyTorch versions, the golden
sweep and the reference's t35 acceptance sweep through the port.

The card has no JAX, so run them from the repository root without the
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_gpu.py
"""

import ast
import os

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))


def _e2e(name):
    """A constant of tests/test_e2e.py, read without importing it (it
    imports the JAX package)."""
    with open(os.path.join(HERE, "test_e2e.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == name):
            return ast.literal_eval(node.value)
    raise LookupError(name)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _run_cfg(tmp_path, **kw):
    from tpu_ecm_torch import driver
    return driver.RunConfig(
        save_b1_path=str(tmp_path / "save_b1.txt"),
        checkpoint_path=str(tmp_path / "checkpoint.txt"),
        results_path=str(tmp_path / "ecm_results.txt"), verbose=0,
        device="cuda", **kw)


@pytest.mark.parametrize("modulus,b", [("N64", 128), ("N416", 2048)])
def test_kernels_match_plain(cuda, modulus, b):
    """K1-K4 digit for digit, K5 mod n, against the plain versions run on
    the same card tensors (chip_smoke.py's cases)."""
    import numpy as np

    import chip_smoke
    from tpu_ecm import params
    from tpu_ecm_torch.limbs import kernels

    ctx = params.make_monty(getattr(chip_smoke, modulus))
    rng = np.random.default_rng(7)
    cases = chip_smoke._kernel_cases(rng, ctx, b)
    kernels.reset_launches()
    for name, (kern, plain, mod_n) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if mod_n:
            assert chip_smoke._canon(got, ctx) == chip_smoke._canon(want, ctx)
        else:
            assert torch.equal(got, want), name
        assert kernels.launches[name] >= 1, name


def test_wrappers_reject_mixed_devices(cuda):
    from tpu_ecm import params
    from tpu_ecm_torch.limbs import kernels, torch_ops
    ctx = params.make_monty(34359738421 * 68719476767)
    cpu_ctx = torch_ops.device_ctx(ctx, "cpu")
    one = torch.zeros((ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="context"):
        kernels.prefix(one[None].contiguous(), one, cpu_ctx)


def test_golden_sweep_on_card(cuda, tmp_path):
    import chip_smoke
    from tpu_ecm_torch import driver
    res = driver.ECMDriver(_run_cfg(
        tmp_path, n=chip_smoke.N71, curves=128, b1=2000, b2=200000,
        sigma=110, stop_on_factor=False)).run()
    assert {(h.factor, h.stage, h.sigma) for h in res.factors} \
        == _e2e("GOLDEN_SWEEP")


def test_t35_sweep(cuda, tmp_path):
    """tests/test_e2e.py:485-495 through the port: 50 pinned sigmas on the
    90-digit composite at B1=1e6/B2=1e8 must each find the P31 factor."""
    from tpu_ecm_torch import driver
    factor = _e2e("T35_FACTOR")
    t35_sigmas = _e2e("T35_SIGMAS")
    d = driver.ECMDriver(_run_cfg(
        tmp_path, n=_e2e("N90_T35"), curves=128, b1=1_000_000,
        b2=100_000_000, sigma=1, batch=128, stop_on_factor=False))
    sigmas = t35_sigmas + [10**6 + i for i in range(128 - len(t35_sigmas))]
    d.run_batch(sigmas, 0)
    hit = {h.sigma for h in d.factors if h.factor % factor == 0
           or factor % h.factor == 0}
    missing = [s for s in t35_sigmas if s not in hit]
    assert not missing, missing
