"""K12's and K13's CUDA source run on the CPU (no card needed).

csrc/rns_batch_inverse.cu runs K12 and K13, the two device halves of the
RNS stage-2 batch inversion, on the tensor-core core csrc/rns_mma.cuh:
K10's tile of T curves a block (8 with the u8 weight planes in shared
memory, else 4 with the fragments from the global table).  K12 keeps one
running product in registers, one product a pass; K13 forms a row's two
products of the old suffix (inv_i = suf * pres[i], the new suf =
suf * z[i]) as one paired pass (mma_mul2, H = 2 halves) where two halves
fit, then x[i] * inv_i.  tools/lane_shim builds their kernel bodies with
g++ against CPU stand-ins of the CUDA runtime and of wmma
(tools/lane_shim/mma.h).  Each case holds a body residue for residue
against rns_kernels.prefix_plain or apply_inverse_plain on CPU tensors
(tests/test_torch_rns.py holds those against the Pallas kernels): a small
K at ragged batches, the rns job's K=200 on a few rows, K=224 past the
shared-memory limit, the synthetic edges K=2, 208, 210, 222 and
K_MAX=520, counts 1, 2, 3 and 5, every instantiation (K12: T = 8 and 4;
K13: T = 8 with two halves and with one, T = 4 with two); and the launch
geometry that rns_kernels.prefix_geometry and apply_inverse_geometry read
from the source's own entry points.
"""

import importlib.util
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from tpu_ecm_torch.limbs import rns, rns_kernels  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("prefix", "apply_inverse")


def _shim():
    """(tools/lane_shim/check.py loaded by path, the RNS shim library)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K12's and K13's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.load_rns(mod.build_lib(False, mod.RNS_SOURCES, "rns"))


def _compare(shim, lib, which, rc, b, count, seed, tile=None):
    fn = {"prefix": shim.compare_rns_prefix,
          "apply_inverse": shim.compare_rns_apply_inverse}[which]
    for what, ok in fn(lib, rc, b, count, seed=seed, tile=tile):
        assert ok, what


def _geometry(which, K, b, lib, tile=0):
    return {"prefix": rns_kernels.prefix_geometry,
            "apply_inverse": rns_kernels.apply_inverse_geometry}[which](
                K, b, lib, tile)


# (bits of a random N, B, count): K=24 at B = 1, 7 and 9 (the last block
# part empty, B % 4 != 0: the scalar loads) and B = 12 (B % 8 == 4: a
# block's second curve group empty), K=200 (the rns job's) and K=224
# (T = 4, global fragments) on three rows at a ragged B in one block;
# counts 1 (the loop's first row is its last), 2, 3 and 5
@pytest.mark.parametrize("which", KERNELS)
@pytest.mark.parametrize("bits,b,count", [
    (256, 1, 3), (256, 7, 5), (256, 9, 2), (256, 12, 1), (256, 9, 5),
    (2397, 5, 3), (2700, 3, 3)])
def test_rns_batch_inverse_shim_equals_plain(which, bits, b, count):
    shim, lib = _shim()
    rc = shim.rns_ctx_at(bits)
    g = _geometry(which, rc.K, b, lib)
    assert rc.K == {256: 24, 2397: 200, 2700: 224}[bits]
    assert g.resident == (rc.K <= 222)
    assert g.halves == (1 if which == "prefix" else 2)
    _compare(shim, lib, which, rc, b, count, seed=b)


@pytest.mark.parametrize("which", KERNELS)
@pytest.mark.parametrize("K", [2, 208, 210, 222, 224, 520])
def test_rns_batch_inverse_shim_k_edges(which, K):
    """The smallest K, the last K where K13's two halves fit beside the
    resident weights (208), the first where only one does (210), the last
    K whose weights fit in shared memory (222), the first past it (224:
    T = 4) and K_MAX, on synthetic tables (make_rns builds K <= 512 in
    steps of 8), three rows at a ragged B in one block."""
    shim, lib = _shim()
    rc = chip_smoke.synthetic_rns(K, K, "cpu")
    g = _geometry(which, K, 5, lib)
    tile = 8 if K <= 222 else 4
    halves = 1 if which == "prefix" or K in (210, 222) else 2
    assert (g.tile, g.halves) == (tile, halves)
    _compare(shim, lib, which, rc, 5, 3, seed=K)


# (kernel, K, tile): every instantiation, K12's T = 8 and T = 4 (asked for
# at K = 24), K13's (T, H) = (8, 2) at K = 24, (8, 1) at K = 210
# (synthetic tables) and (4, 2) asked for at K = 24
@pytest.mark.parametrize("which,K,tile,want", [
    ("prefix", 24, 8, (8, 1)), ("prefix", 24, 4, (4, 1)),
    ("apply_inverse", 24, 8, (8, 2)), ("apply_inverse", 210, 8, (8, 1)),
    ("apply_inverse", 24, 4, (4, 2))])
@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_rns_batch_inverse_shim_every_instantiation(which, K, tile, want,
                                                    count):
    """Every instantiation at counts 1, 2, 3 and 5, B = 9."""
    shim, lib = _shim()
    rc = (shim.rns_ctx_at(256) if K == 24
          else chip_smoke.synthetic_rns(K, K, "cpu"))
    g = _geometry(which, K, 9, lib, tile)
    assert (g.tile, g.halves) == want
    _compare(shim, lib, which, rc, 9, count, seed=count, tile=tile)


def _core_bytes(K: int, resident: bool, halves: int) -> int:
    """csrc/rns_mma.cuh:rns_mma_bytes, reckoned apart: halves sets of X
    (16 Kpad bytes), P and Q (32 Mpad each) and tr (32), the channel
    pairs' constants (40 Mpad) and the four weight planes when resident
    (4 Kpad Mpad)."""
    kp, mp = (K + 15) // 16 * 16, (K + 32) // 32 * 32
    return (halves * (16 * kp + 64 * mp + 32) + 40 * mp
            + (4 * kp * mp if resident else 0))


def test_batch_inverse_geometry_matches_the_kernels_config():
    """rns_kernels.prefix_geometry and apply_inverse_geometry, read from
    csrc/rns_batch_inverse.cu's entry points, at every K the wrappers let
    through: K10's tile, threads and blocks; K12 one half everywhere (its
    launch is K10's), K13 two halves up to K = 208 and past K = 222 (T =
    4), one between (K11's); shared memory the core's bytes for that tile
    and number of halves (no bytes of their own), within the card's
    232,448 bytes: 213,024 (K12) and 230,720 (K13) at the rns job's
    K = 200; T = 4 asked for takes K12's one half and K13's two
    everywhere; T = 8 past K = 222, an odd K, K past K_MAX, B = 0 and a
    tile other than 4 or 8 are refused."""
    _shim_mod, lib = _shim()
    for K in range(2, rns.K_MAX + 1, 2):
        for b in (1, 9, 1024):
            t = rns_kernels.tape_geometry(K, b, lib)
            c = rns_kernels.chain_geometry(K, b, lib)
            p = rns_kernels.prefix_geometry(K, b, lib)
            a = rns_kernels.apply_inverse_geometry(K, b, lib)
            assert tuple(p[:1] + p[2:]) == tuple(t), K
            assert p.halves == 1, K
            assert a == c, K
            assert p.smem == _core_bytes(K, p.resident, 1) <= 232448
            assert a.smem == _core_bytes(K, a.resident, a.halves) <= 232448
            for fn, halves in ((rns_kernels.prefix_geometry, 1),
                               (rns_kernels.apply_inverse_geometry, 2)):
                four = fn(K, b, lib, 4)
                assert (four.tile, four.halves, four.resident) == (
                    4, halves, False)
    assert rns_kernels.prefix_geometry(200, 1024, lib) == (
        8, 1, 448, 128, 213024, True)
    assert rns_kernels.apply_inverse_geometry(200, 1024, lib) == (
        8, 2, 448, 128, 230720, True)
    refused = [(224, 9, 8), (201, 9, 8), (rns.K_MAX + 2, 9, 4), (24, 0, 8),
               (24, 9, 16)]
    for fn in (rns_kernels.prefix_geometry,
               rns_kernels.apply_inverse_geometry):
        for K, b, tile in refused:
            with pytest.raises(ValueError, match="no launch"):
                fn(K, b, lib, tile)


@pytest.mark.parametrize("which", KERNELS)
@pytest.mark.parametrize("count", [0, -1])
def test_rns_batch_inverse_shim_refuses_empty_stacks(which, count):
    """A count below 1 is refused before the body runs."""
    shim, lib = _shim()
    rc = shim.rns_ctx_at(256)
    pl = torch.zeros((1, rc.rows, 8), dtype=torch.int32)
    ptr = pl.data_ptr()
    if which == "prefix":
        code = lib.rns_prefix_run(ptr, ptr, ptr, count, rc.tab.data_ptr(),
                                  rc.wmma.data_ptr(), rc.K, 8, 8)
    else:
        code = lib.rns_apply_inverse_run(ptr, ptr, ptr, ptr, ptr, count,
                                         rc.tab.data_ptr(),
                                         rc.wmma.data_ptr(), rc.K, 8, 8)
    assert code != 0
