"""K10's CUDA source run on the CPU (no card needed).

csrc/rns_tape.cu runs K10, the RNS stage-1 tape kernel, on the
tensor-core core csrc/rns_mma.cuh: a tile of T curves a block (8 where
the u8 weight planes fit in shared memory, else 4 with the fragments read
from the global table), both extension dots as exact u8 products through
nvcuda::wmma, every channel reduction a multiply-high one.
tools/lane_shim builds its kernel body with g++ against CPU stand-ins of
the CUDA runtime and of wmma (tools/lane_shim/mma.h: warp-collective
loads, products and stores, memory to memory).  Each case holds the body
residue for residue against limbs/rns_exec.run_tape on CPU tensors, on a
tape with every opcode and dst aliasing each input: a small K at ragged
batches, the rns job's K=200, K=224 past the shared-memory limit, and the
synthetic edges K=2, 222 and K_MAX=520; the launch geometry that
rns_kernels.tape_geometry reads from the source's own entry point; and
the multiply-high reductions against `%` on edge inputs.
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
    """(tools/lane_shim/check.py loaded by path, K10's shim library)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K10's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.load_rns(mod.build_lib(False, mod.RNS_SOURCES, "rns"))


def test_edge_tape_covers_every_op_and_alias():
    """RNS_EDGE_TAPE holds DUP, ADD and NOP, and a dst equal to a (in
    place), to b and to c."""
    tape = np.asarray(chip_smoke.RNS_EDGE_TAPE)
    assert set(tape[:, 0]) == {0, 1, 2}
    dst, a, b, c = tape[:, 1], tape[:, 2], tape[:, 3], tape[:, 4]
    add = tape[:, 0] == 1
    assert (tape[:, 0] == 0)[dst == a].any() and (dst == b)[add].any()
    assert (dst == c)[add].any() and (tape[:, 0] == 2)[dst != a].any()


# (bits of a random N, B): K=24 at B % 4 != 0 (scalar loads) and B % 8 ==
# 4 (a block's second curve group empty), K=200 (the rns job's) at a
# ragged B, K=224 (past the shared-memory limit: T = 4, global fragments)
# at a ragged B in one block
@pytest.mark.parametrize("bits,b", [(256, 9), (256, 12), (2397, 9),
                                    (2700, 3)])
def test_rns_tape_shim_equals_run_tape(bits, b):
    shim, lib = _shim()
    rc = shim.rns_ctx_at(bits)
    geometry = rns_kernels.tape_geometry(rc.K, b, lib)
    assert rc.K == {256: 24, 2397: 200, 2700: 224}[bits]
    assert geometry.resident == (rc.K <= 222) and b % geometry.tile
    for what, ok in shim.compare_rns_tape(lib, rc, b):
        assert ok, what


@pytest.mark.parametrize("K,b", [(2, 3), (222, 5), (520, 3)])
def test_rns_tape_shim_k_edges(K, b):
    """The smallest K, the last K whose weights fit in shared memory and
    K_MAX, on synthetic tables (make_rns builds K <= 512), each at a
    ragged B in one block."""
    shim, lib = _shim()
    for what, ok in shim.compare_rns_tape(
            lib, chip_smoke.synthetic_rns(K, K, "cpu"), b, seed=K):
        assert ok, what


def test_geometry_matches_the_kernels_config():
    """rns_kernels.tape_geometry, read from csrc/rns_tape.cu's
    tpuecm_rns_tape_geometry, at every K the wrapper lets through: T = 8
    exactly up to K = 222, enough warps for every channel pair and two a
    32-row M tile (at most 14 at T = 8, 17 at T = 4), the block's shared
    memory within the card's 232,448 bytes, 213,024 of them at the rns
    job's K = 200 (PERF.md); a tile asked for is kept; T = 8 past K = 222,
    an odd K, K past K_MAX, B = 0 and a tile other than 4 or 8 are
    refused."""
    _shim_mod, lib = _shim()
    for K in range(2, rns.K_MAX + 1, 2):
        mpad = -(-(K + 1) // 32) * 32
        for b in (1, 9, 1024):
            g = rns_kernels.tape_geometry(K, b, lib)
            assert g.resident == (K <= 222) and g.tile == (8 if K <= 222
                                                           else 4), K
            warps = max(-(-(g.tile // 4) * (K + 1) // 32),
                        min(2 * mpad // 32, 17))
            assert g.threads == 32 * warps <= (448 if g.tile == 8 else 544)
            assert g.blocks == -(-b // g.tile) and g.smem <= 232448, K
            assert rns_kernels.tape_geometry(K, b, lib, 4).tile == 4
    assert rns_kernels.tape_geometry(200, 1024, lib) == (8, 448, 128,
                                                         213024, True)
    refused = [(224, 9, 8), (201, 9, 8), (rns.K_MAX + 2, 9, 4), (24, 0, 8),
               (24, 9, 16)]
    for K, b, tile in refused:
        with pytest.raises(ValueError, match="no launch"):
            rns_kernels.tape_geometry(K, b, lib, tile)


# P and Q at their largest at K_MAX (u8 splits: lo <= 255, a weight's hi
# <= 63, an input's hi <= 31), the dot sum S = P + 256 Q
P_MAX = 520 * 255 * 255 + 256 * 520 * 255 * 31
Q_MAX = 520 * 63 * 255 + 256 * 520 * 63 * 31


@pytest.mark.parametrize("p", [3, 8191, 7919, 4099, 1 << 14])
def test_reductions_equal_mod(p):
    """red, mulc and chan (csrc/rns_mma.cuh) against `%`: x at 0, p-1, p,
    2p-1, the largest channel product and 2^32-1; w at 0, 1 and p-1
    (below 2^14 on the r channel); (P, Q) at 0, p-1 and their largest at
    K_MAX."""
    _shim_mod, lib = _shim()
    assert P_MAX < 1 << 31 and Q_MAX < 1 << 29
    xs = [0, 1, p - 1, p, 2 * p - 1, (p - 1) ** 2, (1 << 26) - 1,
          (1 << 28) - 1, P_MAX, (1 << 32) - 1]
    qs = [0, p - 1, Q_MAX, 0, Q_MAX, p - 1, Q_MAX, 1, Q_MAX, Q_MAX]
    x = np.asarray(xs, dtype=np.uint32)
    q = np.asarray(qs, dtype=np.uint32)
    for w in (0, 1, p - 1):
        out = np.zeros(3 * len(xs), dtype=np.uint32)
        lib.rns_reduce(x.ctypes.data, q.ctypes.data, len(xs), p, w,
                       out.ctypes.data)
        got = out.reshape(-1, 3).tolist()
        for (r, m, c), xv, qv in zip(got, xs, qs):
            assert r == xv % p, ("red", p, xv)
            assert m == xv * w % p, ("mulc", p, xv, w)
            if xv < 1 << 31:        # chan's P
                assert c == (xv + 256 * qv) % p, ("chan", p, xv, qv)
