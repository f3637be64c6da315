"""K14's CUDA source run on the CPU (no card needed).

csrc/rns_replay_gather.cu runs K14, the RNS stage-2 gather replay, on the
tensor-core core csrc/rns_mma.cuh: K10's tile of T curves a block (8
with the u8 weight planes in shared memory, else 4 with the fragments
from the global table), and two independent products of the step's
pairwise tree a pass (mma_mul2, H = 2 halves) where they fit, the
previous step's acc *= root beside each root.  tools/lane_shim builds its
kernel body with g++ against CPU stand-ins of the CUDA runtime and of wmma
(tools/lane_shim/mma.h).  Each case holds the body residue for residue
against rns_kernels.replay_gather_plain on CPU tensors, on calls of
v-sorted entries over few rows (rows repeat) that end in pad entries (G,
0): a small K at ragged batches, the rns job's K=200, K=224 past the
shared-memory limit, the synthetic edges K=2, 222 and K_MAX=520, E = 1,
2 and 16, an odd count of steps and an empty call, every instantiation
(T = 8 with two halves and with one, T = 4 with two), the entry ring's
copies landing at once and at their wait; and the launch geometry that
rns_kernels.gather_geometry reads from the source's own entry point.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from tpu_ecm_torch.limbs import rns, rns_kernels  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _shim():
    """(tools/lane_shim/check.py loaded by path, the RNS shim library)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K14's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.load_rns(mod.build_lib(False, mod.RNS_SOURCES, "rns"))


def test_gather_call_has_pads_and_repeated_rows():
    """check.gather_call's entries are v-sorted, repeat Pa and Pb rows,
    and end in pad entries (G, 0)."""
    shim, _lib = _shim()
    rc = shim.rns_ctx_at(256)
    _acc, pa_ext, pbx, idx = shim.gather_call(np.random.default_rng(0), rc,
                                              9, 16, 3)
    g = pa_ext.shape[0] - 1
    live = idx[:-3]
    assert (idx[-3:] == [g, 0]).all() and (live[:, 1] > 0).all()
    assert (np.diff(live[:, 0]) >= 0).all()
    assert np.unique(live[:, 0]).size < live.shape[0]
    assert np.unique(live[:, 1]).size < live.shape[0]
    assert bool((pbx[0] == 0).all())


# (bits of a random N, B, E, steps): K=24 at B % 4 != 0 (scalar loads)
# and B % 8 == 4 (a block's second curve group empty), K=200 (the rns
# job's) at a ragged B, K=224 (T = 4, global fragments) at a ragged B in
# one block; E = 1 (a chain, no pairs), E = 2 over three steps (6 entries:
# not a whole number of paired passes), and an empty call; the entry
# copies land at once and at their wait at K=24, at once past it (the
# ring does not depend on K)
@pytest.mark.parametrize("bits,b,e,steps", [
    (256, 9, 16, 3), (256, 12, 16, 2), (2397, 5, 16, 2), (2700, 3, 16, 2),
    (256, 9, 1, 5), (256, 12, 2, 3), (256, 9, 16, 0)])
def test_rns_gather_shim_equals_plain(bits, b, e, steps):
    shim, lib = _shim()
    rc = shim.rns_ctx_at(bits)
    geometry = rns_kernels.gather_geometry(rc.K, b, lib)
    assert rc.K == {256: 24, 2397: 200, 2700: 224}[bits]
    assert geometry.resident == (rc.K <= 222) and b % geometry.tile
    assert geometry.halves == 2
    lates = (0, 1) if rc.K == 24 else (0,)
    for what, ok in shim.compare_rns_gather(lib, rc, b, e, steps, seed=b,
                                            lates=lates):
        assert ok, what


@pytest.mark.parametrize("K,b", [(2, 3), (222, 5), (520, 3)])
def test_rns_gather_shim_k_edges(K, b):
    """The smallest K, the last K whose weights fit in shared memory (one
    half there) and K_MAX, on synthetic tables (make_rns builds K <= 512),
    each at a ragged B in one block, two steps of E = 16."""
    shim, lib = _shim()
    rc = chip_smoke.synthetic_rns(K, K, "cpu")
    assert rns_kernels.gather_geometry(K, b, lib).halves == (1 if K == 222
                                                              else 2)
    for what, ok in shim.compare_rns_gather(lib, rc, b, 16, 2, seed=K,
                                            lates=(0,)):
        assert ok, what


# (K, tile): the two instantiations besides the main path's T = 8 with two
# halves: T = 8 with one at K = 210 (the smallest K where two do not fit;
# synthetic tables), and T = 4 (always two halves) asked for at K = 24
@pytest.mark.parametrize("K,tile", [(210, 8), (24, 4)])
@pytest.mark.parametrize("e", [1, 2, 4, 8, 16])
def test_rns_gather_shim_every_tile_and_halves(K, tile, e):
    """Every step size through the instantiations the main path does not
    run at K=200, three steps, B = 9."""
    shim, lib = _shim()
    rc = (shim.rns_ctx_at(256) if K == 24
          else chip_smoke.synthetic_rns(K, K, "cpu"))
    g = rns_kernels.gather_geometry(K, 9, lib, tile)
    assert (g.tile, g.halves) == ((8, 1) if K == 210 else (4, 2))
    for what, ok in shim.compare_rns_gather(lib, rc, 9, e, 3, seed=e,
                                            tile=tile, lates=(0,)):
        assert ok, what


def test_gather_geometry_matches_the_kernels_config():
    """rns_kernels.gather_geometry, read from
    csrc/rns_replay_gather.cu's tpuecm_rns_gather_geometry, at every K
    the wrapper lets through: K10's tile, threads and blocks, two halves
    up to K = 208 and past K = 222 (T = 4), one between; one scratch plane
    at T = 8, five at T = 4; shared memory within the card's 232,448
    bytes, 231,104 at the rns job's K = 200 (K10's 213,024, a second half
    of X, P/Q and tr of 17,696 and the entry ring of 384); T = 4 asked for
    takes two halves everywhere; T = 8 past K = 222, an odd K, K past
    K_MAX, B = 0 and a tile other than 4 or 8 are refused."""
    _shim_mod, lib = _shim()
    for K in range(2, rns.K_MAX + 1, 2):
        for b in (1, 9, 1024):
            g = rns_kernels.gather_geometry(K, b, lib)
            t = rns_kernels.tape_geometry(K, b, lib)
            assert (g.tile, g.threads, g.blocks, g.resident) == (
                t.tile, t.threads, t.blocks, t.resident), K
            assert g.halves == (1 if 208 < K <= 222 else 2), K
            assert g.scratch == (1 if g.tile == 8 else 5), K
            assert g.smem <= 232448, K
            assert rns_kernels.gather_geometry(K, b, lib, 4).halves == 2
    assert rns_kernels.gather_geometry(200, 1024, lib) == (
        8, 2, 448, 128, 231104, True, 1)
    refused = [(224, 9, 8), (201, 9, 8), (rns.K_MAX + 2, 9, 4), (24, 0, 8),
               (24, 9, 16)]
    for K, b, tile in refused:
        with pytest.raises(ValueError, match="no launch"):
            rns_kernels.gather_geometry(K, b, lib, tile)


@pytest.mark.parametrize("e,steps", [(3, 1), (32, 1), (16, -1)])
def test_rns_gather_shim_refuses_call_shapes(e, steps):
    """E not a power of two, E past 16 and a negative step count are
    refused before the body runs."""
    shim, lib = _shim()
    rc = shim.rns_ctx_at(256)
    acc = torch.zeros((5, rc.rows, 8), dtype=torch.int32)
    idx = np.zeros((64, 2), np.int32)
    code = lib.rns_gather_run(acc.data_ptr(), acc.data_ptr(),
                              acc.data_ptr(), acc.data_ptr(), acc.data_ptr(),
                              idx.ctypes.data, steps, e, rc.tab.data_ptr(),
                              rc.wmma.data_ptr(), rc.K, 8, 8, 0)
    assert code != 0
