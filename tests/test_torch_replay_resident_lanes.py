"""K8's CUDA source run on the CPU (no card needed).

csrc/replay_resident.cu runs K8 (the digit resident-slab replay) as the
RG_RESIDENT form of K6's kernel body (csrc/replay_passes.cuh) on the lane
core csrc/arith_lanes.cuh: L lanes per curve, every product step a pair of
the step's pairwise tree, the Pa row in a slot reloaded when pa changes,
each leaf group's differences formed from a slab of Pb rows that the
block fills with cp.async at each slab segment, between two barriers.
tools/lane_shim builds the body with g++ against a CPU stand-in of the
CUDA runtime (a std::thread per CUDA thread, shuffles through a per-warp
buffer) and of the cp.async primitives, whose copies land at once or at
their wait.  Each case holds it digit for digit against
kernels.replay_resident_plain on CPU tensors, in both landings: REDC at
nw = 36 (the flagship's, two blocks with the second part empty) and with
norm_inputs off (nw = 43), the fold at M127 and M1277 (nw = 118) and with
c = -1; E = 1, 2, 4, 8 and 16; three slab segments, the last slab short
and its segment ending in three pad entries (G, 0) and a whole pad step;
v-sorted Pa runs that change inside a step, and unsorted entries; wide
digits and a moved `one` (values past R, where the association and each
lazy pass show); slabs of 1, 4 and 7 rows; and the edge nw of every
instantiation D = 2..8 at a batch that leaves a block part empty.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_ecm_torch import params  # noqa: E402
from tpu_ecm_torch.limbs import kernels, torch_ops  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# each instantiation's smallest and largest nw at its lanes (D = ceil(nw /
# lanes)) and the nw on each side of a change of lanes
EDGE_NW = (2, 8, 9, 12, 13, 16, 17, 20, 21, 24, 25, 28, 29, 32, 33, 64, 65,
           128, 129)


def _lane_shim():
    """tools/lane_shim/check.py, loaded by path (tools is no package)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K8's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _compare(shim, ctx, b, e, steps, lanes=None, **kw):
    lib = shim.load(shim.build_lib())
    results = shim.compare_replay_resident(lib, ctx, b, e, steps, lanes,
                                           **kw)
    assert len(results) == 2 and all(ok for _what, ok in results), results


def test_resident_cases_cover_the_edges():
    """The shim's K8 cases: every E a step may take, the flagship's
    nw = 36, REDC with norm_inputs off, an M127 and an M1277 fold and
    c = -1, batches that leave the last block part empty, and every
    instantiation D = 2..8 among the edge nw."""
    shim = _lane_shim()
    assert set(shim.RESIDENT_LANES_STEPS) == {1, 2, 4, 8, 16}
    ctxs = [params.make_monty(n, mersenne=m, force_w=w)
            for n, m, w, _b, _l in shim.REPLAY_CASES]
    assert {36, 12, 118} <= {c.p.nw for c in ctxs}
    assert any(not c.p.norm_inputs for c in ctxs)
    assert any(c.is_mersenne and c.mersenne_c < 0 for c in ctxs)
    for (n, m, w, b, lanes), ctx in zip(shim.REPLAY_CASES, ctxs):
        per_block = kernels.TAPE_BLOCK // (
            lanes or kernels.tape_geometry(ctx.p.nw, b)[0])
        assert b % per_block, "every case leaves its last block part empty"
    assert {kernels.tape_geometry(nw, 1)[1] for nw in EDGE_NW} \
        == set(kernels.TAPE_DIGITS)


@pytest.mark.parametrize("e", [1, 2, 4, 8, 16])
def test_resident_lanes_call_entries(e):
    """resident_lanes_call's inputs form a call the wrapper accepts: three
    segments over slabs of 4 rows of a 10-row table (the last slab two
    rows; at 1 row, three slabs of a 3-row table), each segment's rows inside its slab, v-sorted Pa runs that
    change inside a step, three pad entries (G, 0) and a whole pad step
    at the end; `one` is a form that a lazy pass changes."""
    shim = _lane_shim()
    ctx = params.make_monty(shim.N416)
    steps, cap = shim.RESIDENT_LANES_STEPS[e], 4
    d, acc, pa_ext, pbx, ent, segs = shim.resident_lanes_call(
        ctx, 4, e, steps, cap)
    g = pa_ext.shape[0] - 1
    assert pbx.shape[0] == 10 and not pbx[0].any()
    assert segs.tolist() == [[0, 0, steps], [4, steps, steps],
                             [8, 2 * steps, steps + 1]]
    kernels.check_pairs("resident", ent, e, g + 1, cap + 1)
    kernels.check_slabs("resident", segs, ent, e, cap, pbx.shape[0])
    _d, _a, pa1, pb1, ent1, segs1 = shim.resident_lanes_call(ctx, 4, e,
                                                             steps, 1)
    assert pb1.shape[0] == 3 and segs1[:, 0].tolist() == [0, 1, 2]
    kernels.check_slabs("resident", segs1, ent1, e, 1, 3)
    assert (ent[-e - 3:] == [g, 0]).all() and (ent[:-e - 3, 1] > 0).all()
    assert (ent[2 * steps * e:-e - 3, 1] <= 2).all()
    live = ent[:-e - 3]
    assert (np.diff(live[:, 0]) >= 0).all()
    change = np.flatnonzero(np.diff(live[:, 0])) + 1
    if e > 1:
        assert any(i % e for i in change), "a Pa run changes inside a step"
    assert not torch.equal(pa_ext[g], torch_ops._norm_out(pa_ext[g], d))


@pytest.mark.parametrize("e", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", range(5))
def test_resident_source_on_cpu(case, e):
    """csrc/replay_resident.cu's kernel body, built by g++ through
    tools/lane_shim, equals kernels.replay_resident_plain digit for digit,
    its slab fills landing at once and at their wait."""
    shim = _lane_shim()
    assert len(shim.REPLAY_CASES) == 5
    n, mers, force_w, b, lanes = shim.REPLAY_CASES[case]
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    _compare(shim, ctx, b, e, shim.RESIDENT_LANES_STEPS[e], lanes,
             seed=case * 100 + e)


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("kind", ["wide", "unsorted"])
def test_resident_source_wide_or_unsorted(case, kind):
    """The same at E = 16 over two steps a slab on wide digits (every
    digit below 2^(w+6): values past R, so the tree's association and each
    difference's lazy pass show in the digits) or on entries whose Pa rows
    are not sorted (the Pa row reloaded at almost every entry)."""
    shim = _lane_shim()
    n, mers, force_w, b, lanes = shim.REPLAY_CASES[case]
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    _compare(shim, ctx, b, 16, 2, lanes, seed=case + 11,
             wide=kind == "wide", sort=kind != "wide")


@pytest.mark.parametrize("cap", [1, 7])
@pytest.mark.parametrize("case", [0, 3])
def test_resident_source_slab_heights(case, cap):
    """The same at E = 4 with slabs of 1 and 7 rows at the flagship's
    nw = 36 and at M1277 (each segment fills a whole slab but the last)."""
    shim = _lane_shim()
    n, mers, force_w, b, lanes = shim.REPLAY_CASES[case]
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    _compare(shim, ctx, b, 4, 2, lanes, seed=cap + case, cap=cap,
             wide=True)


@pytest.mark.parametrize("nw", EDGE_NW)
def test_resident_source_nw_edges(nw):
    """The same at E = 16 on wide digits at every instantiation's edge nw
    (tape_geometry's lanes and digits), at a batch that leaves the second
    block part empty."""
    shim = _lane_shim()
    ctx = shim.ctx_at_nw(nw)
    per_block = kernels.tape_geometry(nw, 1)[2]
    _compare(shim, ctx, per_block + 3, 16, 1, seed=nw, wide=True)
