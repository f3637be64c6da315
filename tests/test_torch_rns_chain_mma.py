"""K11's CUDA source run on the CPU (no card needed).

csrc/rns_chain.cu runs K11, the RNS stage-2 differential-add chain, on the
tensor-core core csrc/rns_mma.cuh: K10's tile of T curves a block (8 with
the u8 weight planes in shared memory, else 4 with the fragments from the
global table), a row's six products as three independent pairs (mma_mul2,
H = 2 halves) where two halves fit, out[i-1] held in registers across rows
and out[i-2] read back from the output.  tools/lane_shim builds its kernel
body with g++ against CPU stand-ins of the CUDA runtime and of wmma
(tools/lane_shim/mma.h).  Each case holds the body residue for residue
against rns_kernels.chain_plain on CPU tensors: a small K at ragged
batches, the rns job's K=200 on a few rows, K=224 past the shared-memory
limit, the synthetic edges K=2, 208, 210, 222 and K_MAX=520, counts 1, 2,
3 and 5, every instantiation (T = 8 with two halves and with one, T = 4
with two); and the launch geometry that rns_kernels.chain_geometry reads
from the source's own entry point.
"""

import importlib.util
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from tpu_ecm_torch.limbs import rns, rns_kernels  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _shim():
    """(tools/lane_shim/check.py loaded by path, the RNS shim library)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K11's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.load_rns(mod.build_lib(False, mod.RNS_SOURCES, "rns"))


# (bits of a random N, B, count): K=24 at B = 1, 7 and 9 (the last block
# part empty, B % 4 != 0: the scalar loads) and B = 12 (B % 8 == 4: a
# block's second curve group empty), K=200 (the rns job's) and K=224
# (T = 4, global fragments) on three rows at a ragged B in one block;
# count 1 and 2 read only the seeds as differences, 3 and 5 read out[i-2]
# back from the output
@pytest.mark.parametrize("bits,b,count", [
    (256, 1, 3), (256, 7, 5), (256, 9, 2), (256, 12, 1), (256, 9, 5),
    (2397, 5, 3), (2700, 3, 3)])
def test_rns_chain_shim_equals_plain(bits, b, count):
    shim, lib = _shim()
    rc = shim.rns_ctx_at(bits)
    geometry = rns_kernels.chain_geometry(rc.K, b, lib)
    assert rc.K == {256: 24, 2397: 200, 2700: 224}[bits]
    assert geometry.resident == (rc.K <= 222) and geometry.halves == 2
    for what, ok in shim.compare_rns_chain(lib, rc, b, count, seed=b):
        assert ok, what


@pytest.mark.parametrize("K", [2, 208, 210, 222, 224, 520])
def test_rns_chain_shim_k_edges(K):
    """The smallest K, the last K where two halves fit beside the resident
    weights (208), the first where only one does (210), the last K whose
    weights fit in shared memory (222), the first past it (224: T = 4)
    and K_MAX, on synthetic tables (make_rns builds K <= 512 in steps of
    8), three rows at a ragged B in one block."""
    shim, lib = _shim()
    rc = chip_smoke.synthetic_rns(K, K, "cpu")
    g = rns_kernels.chain_geometry(K, 5, lib)
    assert (g.tile, g.halves) == ((8, 1) if K in (210, 222)
                                  else (8, 2) if K <= 208 else (4, 2))
    for what, ok in shim.compare_rns_chain(lib, rc, 5, 3, seed=K):
        assert ok, what


# (K, tile): every instantiation, (T, H) = (8, 2) at K = 24, (8, 1) at
# K = 210 (synthetic tables) and (4, 2) asked for at K = 24
@pytest.mark.parametrize("K,tile", [(24, 8), (210, 8), (24, 4)])
@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_rns_chain_shim_every_instantiation(K, tile, count):
    """Every instantiation at counts 1, 2, 3 and 5, B = 9."""
    shim, lib = _shim()
    rc = (shim.rns_ctx_at(256) if K == 24
          else chip_smoke.synthetic_rns(K, K, "cpu"))
    g = rns_kernels.chain_geometry(K, 9, lib, tile)
    assert (g.tile, g.halves) == {(24, 8): (8, 2), (210, 8): (8, 1),
                                  (24, 4): (4, 2)}[(K, tile)]
    for what, ok in shim.compare_rns_chain(lib, rc, 9, count, seed=count,
                                           tile=tile):
        assert ok, what


def _core_bytes(K: int, resident: bool, halves: int) -> int:
    """csrc/rns_mma.cuh:rns_mma_bytes, reckoned apart: halves sets of X
    (16 Kpad bytes), P and Q (32 Mpad each) and tr (32), the channel
    pairs' constants (40 Mpad) and the four weight planes when resident
    (4 Kpad Mpad)."""
    kp, mp = (K + 15) // 16 * 16, (K + 32) // 32 * 32
    return (halves * (16 * kp + 64 * mp + 32) + 40 * mp
            + (4 * kp * mp if resident else 0))


def test_chain_geometry_matches_the_kernels_config():
    """rns_kernels.chain_geometry, read from csrc/rns_chain.cu's
    tpuecm_rns_chain_geometry, at every K the wrapper lets through: K10's
    tile, threads and blocks; two halves up to K = 208 and past K = 222
    (T = 4), one between; shared memory the core's bytes for that tile and
    number of halves (no bytes of K11's own), within the card's 232,448
    bytes: 230,720 at the rns job's K = 200; T = 4 asked for takes two
    halves everywhere; T = 8 past K = 222, an odd K, K past K_MAX, B = 0
    and a tile other than 4 or 8 are refused."""
    _shim_mod, lib = _shim()
    for K in range(2, rns.K_MAX + 1, 2):
        for b in (1, 9, 1024):
            g = rns_kernels.chain_geometry(K, b, lib)
            t = rns_kernels.tape_geometry(K, b, lib)
            assert (g.tile, g.threads, g.blocks, g.resident) == (
                t.tile, t.threads, t.blocks, t.resident), K
            assert g.halves == (1 if 208 < K <= 222 else 2), K
            assert g.smem == _core_bytes(K, g.resident, g.halves) <= 232448
            four = rns_kernels.chain_geometry(K, b, lib, 4)
            assert (four.tile, four.halves, four.resident) == (4, 2, False)
    assert rns_kernels.chain_geometry(200, 1024, lib) == (
        8, 2, 448, 128, 230720, True)
    refused = [(224, 9, 8), (201, 9, 8), (rns.K_MAX + 2, 9, 4), (24, 0, 8),
               (24, 9, 16)]
    for K, b, tile in refused:
        with pytest.raises(ValueError, match="no launch"):
            rns_kernels.chain_geometry(K, b, lib, tile)


@pytest.mark.parametrize("count", [0, -1])
def test_rns_chain_shim_refuses_empty_chains(count):
    """A count below 1 is refused before the body runs."""
    shim, lib = _shim()
    rc = shim.rns_ctx_at(256)
    pts = torch.zeros((2, rc.rows, 8), dtype=torch.int32)
    code = lib.rns_chain_run(pts.data_ptr(), pts.data_ptr(), pts.data_ptr(),
                             pts.data_ptr(), count, rc.tab.data_ptr(),
                             rc.wmma.data_ptr(), rc.K, 8, 8)
    assert code != 0
