"""The fold (a special form 2^e - c) with the curve axis split: M101 =
2^101 - 1, from sigma 500, B1=2000, B2=150,000 (the P13 at sigma 502 in
stage 2, tests/test_torch_replay_modes.py's bound for that find), 6
curves over 2 CPU devices and 4 curves over 3 (rounded up to 6, two a
device), against tpu_ecm's one-device run of the 6 curves (a fixed sigma
makes it mesh-independent; a sharded jax run of the fold would add its
compilation to tier 1): the same factor list, residues, file bytes and
counters.  The fold's resume, on one device and over two:
tests/test_torch_fold_parity.py."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_parallel import assert_same, jax_run, port_run  # noqa: E402

torch.set_num_threads(1)

M101 = (1 << 101) - 1
M101_P13 = 7432339208719
FOLD = dict(n=M101, b1=2000, b2=150_000, sigma=500)
# curves asked of a k-device run: both round to 6
CURVES = {2: 6, 3: 4}


@pytest.fixture(scope="module")
def jax_fold(tmp_path_factory):
    return jax_run(tmp_path_factory.mktemp("jax_fold"), "fold", None,
                   curves=6, **FOLD)


@pytest.mark.parametrize("k", [2, 3])
def test_fold_sharded_equals_tpu_ecm(tmp_path, jax_fold, k):
    got = port_run(tmp_path, f"fold{k}", k, curves=CURVES[k], **FOLD)
    assert got["curves_run"] == 6
    assert_same(got, jax_fold)
    assert (M101_P13, 2, 2, 502) in got["factors"]
