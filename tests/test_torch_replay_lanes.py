"""K5's CUDA source run on the CPU (no card needed).

csrc/replay.cu runs K5 on the lane core csrc/arith_lanes.cuh: L lanes per
curve, every product step a pair (quadruples software-pipelined: (d0 d1,
d2 d3), then m = m01 m23 beside acc * m of the previous quadruple), the
current Pa row kept in a slot and the next quadruple's Pb rows copied
ahead with cp.async.  tools/lane_shim builds its kernel body with g++
against a CPU stand-in of the CUDA runtime (a std::thread per CUDA thread,
shuffles through a per-warp buffer) and of the cp.async primitives, whose
copies land at once or at their wait.  Each case holds the kernel body
digit for digit against kernels.replay_plain on CPU tensors, in both
landings: REDC at nw = 36 (the flagship's, two blocks with the second part
empty) and with norm_inputs off (nw = 43), the fold at M127 and M1277
(nw = 118) and with c = -1; live counts 0, 3 and 8-11 (count % 4 = 0, 1,
2, 3), v-sorted Pa runs that change inside quadruples, live pads
G << 16 | 0 and entries past the count.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_ecm_torch import params  # noqa: E402
from tpu_ecm_torch.limbs import kernels  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _lane_shim():
    """tools/lane_shim/check.py, loaded by path (tools is no package)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K5's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_replay_cases_cover_the_edges():
    """The shim's K5 cases: the flagship's nw = 36 (REDC), an M127 and an
    M1277 fold, a batch that leaves its last block part empty, and live
    counts 0 and every count % 4."""
    shim = _lane_shim()
    nws = {params.make_monty(n, mersenne=m, force_w=w).p.nw
           for n, m, w, _b, _l in shim.REPLAY_CASES}
    assert {36, 12, 118} <= nws
    assert 0 in shim.REPLAY_COUNTS
    assert {c % 4 for c in shim.REPLAY_COUNTS if c} == {0, 1, 2, 3}
    for n, m, w, b, lanes in shim.REPLAY_CASES:
        nw = params.make_monty(n, mersenne=m, force_w=w).p.nw
        per_block = kernels.TAPE_BLOCK // (
            lanes or kernels.tape_geometry(nw, b)[0])
        assert b % per_block, "every case leaves its last block part empty"


def test_replay_call_entries():
    """replay_call's idx: v-sorted live Pa runs that change inside a
    quadruple, two live pads G << 16 | 0 last, three entries past the
    count."""
    shim = _lane_shim()
    ctx = params.make_monty(shim.N416)
    _d, acc, pa_ext, pbx, idx = shim.replay_call(ctx, 4, 11)
    assert idx[0] == 11 and idx.size == 1 + 11 + 3
    live = idx[1:12].view(np.uint32)
    pa = (live >> 16).astype(int)
    assert (np.diff(pa) >= 0).all()
    assert any(i % 4 for i in np.flatnonzero(np.diff(pa[:9])) + 1)
    g = pa_ext.shape[0] - 1
    assert list(live[-2:]) == [g << 16] * 2
    assert not pbx[0].any() and acc.shape == pbx.shape[1:]


@pytest.mark.parametrize("count", [0, 3, 8, 9, 10, 11])
@pytest.mark.parametrize("case", range(5))
def test_replay_source_on_cpu(case, count):
    """csrc/replay.cu's kernel body, built by g++ through tools/lane_shim,
    equals kernels.replay_plain digit for digit, its Pb copies landing at
    once and at their wait."""
    shim = _lane_shim()
    assert len(shim.REPLAY_CASES) == 5
    assert count in shim.REPLAY_COUNTS
    n, mers, force_w, b, lanes = shim.REPLAY_CASES[case]
    lib = shim.load(shim.build_lib())
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    results = shim.compare_replay(lib, ctx, b, count, lanes,
                                  seed=case * 100 + count)
    assert len(results) == 2 and all(ok for _what, ok in results), results
