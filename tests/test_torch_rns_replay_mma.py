"""K15's CUDA source run on the CPU (no card needed).

csrc/rns_replay.cu runs K15, the RNS stage-2 stream replay, on the
tensor-core core csrc/rns_mma.cuh: K12's launch of T curves a block (8
with the u8 weight planes in shared memory, else 4 with the fragments
from the global table), one product a pass, acc and the Pa row in
registers for the whole call (the Pa row reloaded only when pa changes),
the next entry's rows loaded a pass ahead, the entries through
the ring of csrc/rns_ring.cuh.  tools/lane_shim builds its kernel body
with g++ against CPU stand-ins of the CUDA runtime and of wmma
(tools/lane_shim/mma.h).  Each case holds the body residue for residue
against rns_kernels.replay_plain on CPU tensors (tests/test_torch_rns.py
holds that against the Pallas stream kernel), on calls whose live entries
take v-sorted Pa rows (rows repeat), a new Pa row at every entry or one
row throughout, end in pads G << 16 | 0 and leave entries past the count
that would change the product if read: counts 0 to 3 and counts past one
and several of the ring's 64-entry chunks, a small K at ragged batches, the
rns job's K=200, K=224 past the shared-memory limit, the synthetic edges
K=2, 222 and K_MAX=520, both tiles, the ring's copies landing at once and
at their wait; the launch geometry that rns_kernels.replay_geometry reads
from the source's own entry point; and the calls it refuses.
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
        pytest.skip("needs g++ to build K15's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.load_rns(mod.build_lib(False, mod.RNS_SOURCES, "rns"))


def _assert_equal(results):
    for what, ok in results:
        assert ok, what


@pytest.mark.parametrize("pa", ["sorted", "every", "one"])
def test_stream_call_has_pads_and_entries_past_the_count(pa):
    """check.stream_call's idx is the count, then live entries of the
    asked Pa pattern, two pads G << 16 | 0, then entries past the count
    that name live rows."""
    shim, _lib = _shim()
    rc = shim.rns_ctx_at(256)
    acc, pa_ext, pbx, idx = shim.stream_call(np.random.default_rng(0), rc,
                                             9, 40, pa)
    g = pa_ext.shape[0] - 1
    assert idx[0] == 40 and idx.size == 1 + 40 + 3
    e = idx[1:].view(np.uint32)
    rows, cols = e >> 16, e & 0xFFFF
    assert (rows[38:40] == g).all() and (cols[38:40] == 0).all()
    assert (rows[40:] < g).all() and (cols[40:] > 0).all()
    live = rows[:38]
    assert (cols[:38] > 0).all() and bool((pbx[0] == 0).all())
    changes = int((np.diff(live) != 0).sum())
    assert changes == {"sorted": changes, "every": 37, "one": 0}[pa]
    if pa == "sorted":
        assert (np.diff(live) >= 0).all() and 0 < changes < 37
    assert acc.shape == (rc.rows, 9)


# (bits of a random N, B, count, Pa pattern): K=24 at counts 0 (acc
# copied), 1, 2 and 3 (odd and even), at B % 4 != 0 (scalar loads), B = 1
# and B % 8 == 4 (a block's second curve group empty); counts past one
# and several 64-entry chunks of the ring with a new Pa row at every entry,
# with one Pa row throughout and v-sorted; the ring's copies land at once
# and at their wait
@pytest.mark.parametrize("bits,b,count,pa", [
    (256, 9, 0, "sorted"), (256, 9, 1, "sorted"), (256, 9, 2, "sorted"),
    (256, 9, 3, "sorted"), (256, 12, 3, "every"), (256, 1, 2, "every"),
    (256, 7, 5, "one"), (256, 9, 129, "every"), (256, 9, 257, "sorted"),
    (256, 12, 260, "one"), (256, 9, 31, "every")])
def test_rns_replay_shim_equals_plain(bits, b, count, pa):
    shim, lib = _shim()
    rc = shim.rns_ctx_at(bits)
    g = rns_kernels.replay_geometry(rc.K, b, lib)
    assert rc.K == 24 and g.tile == 8 and g.resident
    _assert_equal(shim.compare_rns_replay(lib, rc, b, count, seed=count + b,
                                          pa=pa))


# (bits, B, count): the rns job's K=200 (T = 8, weights in shared memory)
# and a 2700-bit N (K=224: T = 4, global fragments) at a ragged B in one
# block, counts 1, 2 and 3 with every Pa pattern
@pytest.mark.parametrize("bits,b", [(2397, 5), (2700, 3)])
@pytest.mark.parametrize("count,pa", [(3, "sorted"), (2, "every"),
                                      (1, "one")])
def test_rns_replay_shim_main_path_k(bits, b, count, pa):
    shim, lib = _shim()
    rc = shim.rns_ctx_at(bits)
    g = rns_kernels.replay_geometry(rc.K, b, lib)
    assert (rc.K, g.tile) == {2397: (200, 8), 2700: (224, 4)}[bits]
    _assert_equal(shim.compare_rns_replay(lib, rc, b, count, seed=bits,
                                          lates=(0,), pa=pa))


@pytest.mark.parametrize("K,b", [(2, 9), (222, 5), (224, 3), (520, 3)])
def test_rns_replay_shim_k_edges(K, b):
    """The smallest K, the last K whose weights fit in shared memory beside
    the entry ring (222), one step past it (224: 4 curves a block) and
    K_MAX, on synthetic tables (make_rns builds K <= 512), each at a ragged
    B in one block, five entries with a new Pa row at each."""
    shim, lib = _shim()
    rc = chip_smoke.synthetic_rns(K, K, "cpu")
    assert rns_kernels.replay_geometry(K, b, lib).resident == (K <= 222)
    _assert_equal(shim.compare_rns_replay(lib, rc, b, 5, seed=K, lates=(0,),
                                          pa="every"))


# T = 4 asked for at K = 24 (the tile the main path does not run there),
# through the same counts
@pytest.mark.parametrize("count,pa", [(0, "sorted"), (1, "one"),
                                      (2, "every"), (3, "sorted"),
                                      (130, "every")])
def test_rns_replay_shim_tile_4(count, pa):
    shim, lib = _shim()
    rc = shim.rns_ctx_at(256)
    g = rns_kernels.replay_geometry(rc.K, 9, lib, 4)
    assert (g.tile, g.resident) == (4, False)
    _assert_equal(shim.compare_rns_replay(lib, rc, 9, count, seed=count,
                                          tile=4, pa=pa))


def test_replay_geometry_matches_the_kernels_config():
    """rns_kernels.replay_geometry, read from csrc/rns_replay.cu's
    tpuecm_rns_replay_geometry, at every K the wrapper lets through: K12's
    tile, threads, blocks and residency (prefix_geometry), and its shared
    memory plus the 768-byte entry ring, within the card's 232,448
    bytes: 213,792 at the rns job's K = 200 and B = 1024 (128 blocks of
    448 threads); T = 4 asked for anywhere; T = 8 past K = 222, an odd K,
    K past K_MAX, B = 0 and a tile other than 4 or 8 are refused."""
    _shim_mod, lib = _shim()
    for K in range(2, rns.K_MAX + 1, 2):
        for b in (1, 9, 1024):
            g = rns_kernels.replay_geometry(K, b, lib)
            p = rns_kernels.prefix_geometry(K, b, lib)
            assert (g.tile, g.threads, g.blocks, g.resident) == (
                p.tile, p.threads, p.blocks, p.resident), K
            assert g.smem == p.smem + 768 and g.smem <= 232448, K
            assert g.resident == (K <= 222), K
            assert rns_kernels.replay_geometry(K, b, lib, 4).tile == 4
    assert rns_kernels.replay_geometry(200, 1024, lib) == (
        8, 448, 128, 213792, True)
    refused = [(224, 9, 8), (201, 9, 8), (rns.K_MAX + 2, 9, 4), (24, 0, 8),
               (24, 9, 16)]
    for K, b, tile in refused:
        with pytest.raises(ValueError, match="no launch"):
            rns_kernels.replay_geometry(K, b, lib, tile)


@pytest.mark.parametrize("count,K,b,tile", [(-1, 24, 8, 8), (3, 25, 8, 8),
                                            (3, 24, 0, 8), (3, 24, 8, 2),
                                            (3, 224, 8, 8)])
def test_rns_replay_shim_refuses_calls(count, K, b, tile):
    """A negative count, an odd K, B = 0, a tile other than 4 or 8 and
    T = 8 where the weights do not fit are refused before the body runs,
    and the output is left as it was."""
    shim, lib = _shim()
    rc = shim.rns_ctx_at(256)
    acc = torch.zeros((5, rc.rows, 8), dtype=torch.int32)
    out = torch.full((rc.rows, 8), -7, dtype=torch.int32)
    idx = np.zeros(4, np.int32)
    code = lib.rns_replay_run(acc.data_ptr(), out.data_ptr(), acc.data_ptr(),
                              acc.data_ptr(), idx.ctypes.data, count,
                              rc.tab.data_ptr(), rc.wmma.data_ptr(), K, b,
                              tile, 0)
    assert code != 0
    assert bool((out == -7).all())
