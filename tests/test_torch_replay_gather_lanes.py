"""K6's and K7's CUDA source run on the CPU (no card needed).

csrc/replay_gather.cu runs K6 (the digit gather replay) and K7 (the
shared-Pa-row replay) from one kernel body on the lane core
csrc/arith_lanes.cuh: L lanes per curve, every product step a pair (a
step's pairwise tree walked depth first in pairs of subtrees of equal
height, the root's pass carrying the previous step's acc *= root), each
leaf group's differences formed over its Pb rows while the next group's
are copied ahead with cp.async; K6 keeps the current Pa row in a slot,
K7 copies a step's Pa row and a pad's `one` plane with the step's rows.
tools/lane_shim builds the body with g++ against a CPU stand-in of the
CUDA runtime (a std::thread per CUDA thread, shuffles through a per-warp
buffer) and of the cp.async primitives, whose copies land at once or at
their wait.  Each case holds it digit for digit against
kernels.replay_gather_plain and replay_parow_plain on CPU tensors, in both
landings: REDC at nw = 36 (the flagship's, two blocks with the second part
empty) and with norm_inputs off (nw = 43), the fold at M127 and M1277
(nw = 118) and with c = -1; E = 1, 2, 4, 8 and 16; v-sorted Pa runs that
change inside a step and unsorted entries; K6's pads (G, 0), K7's pads
pb = 0 inside steps and a whole pad step, with a `one` plane whose digits
a lazy pass would change; wide digits (values past R, where the
association shows); and nsteps = 0.
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
# (E, steps) of each source case: every E a step may take, and no step
STEPS = [(1, 7), (2, 5), (4, 5), (8, 3), (16, 3), (16, 0)]


def _lane_shim():
    """tools/lane_shim/check.py, loaded by path (tools is no package)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K6's and K7's source for the CPU")
    path = os.path.join(os.path.dirname(HERE), "tools", "lane_shim",
                        "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gather_cases_cover_the_edges():
    """The shim's K6 and K7 cases: the flagship's nw = 36 (REDC), REDC
    with norm_inputs off, an M127 and an M1277 fold and c = -1, every E a
    step may take, nsteps = 0, and batches that leave the last block part
    empty."""
    shim = _lane_shim()
    ctxs = [params.make_monty(n, mersenne=m, force_w=w)
            for n, m, w, _b, _l in shim.REPLAY_CASES]
    assert {36, 12, 118} <= {c.p.nw for c in ctxs}
    assert any(not c.p.norm_inputs for c in ctxs)
    assert any(c.is_mersenne and c.mersenne_c < 0 for c in ctxs)
    assert set(shim.GATHER_LANES_STEPS) == {1, 2, 4, 8, 16}
    assert {e for e, _s in STEPS} == {1, 2, 4, 8, 16}
    assert (16, 0) in STEPS
    assert all(shim.GATHER_LANES_STEPS[e] == s for e, s in STEPS if s)
    for (n, m, w, b, lanes), ctx in zip(shim.REPLAY_CASES, ctxs):
        per_block = kernels.TAPE_BLOCK // (
            lanes or kernels.tape_geometry(ctx.p.nw, b)[0])
        assert b % per_block, "every case leaves its last block part empty"


def test_gather_lanes_call_entries():
    """gather_lanes_call's inputs: K6's v-sorted Pa runs change inside a
    step and end in three pads (G, 0); K7's steps hold pads pb = 0 inside
    steps and end in a whole pad step (pa = G); `one` is a non-canonical
    form that a lazy pass changes."""
    shim = _lane_shim()
    ctx = params.make_monty(shim.N416)
    e, steps = 16, 3
    d, acc, pa_ext, pbx, one, pairs, st = shim.gather_lanes_call(
        ctx, 4, e, steps)
    g = pa_ext.shape[0] - 1
    assert pairs.shape == (steps * e, 2) and st.shape == (steps, 1 + e)
    live = pairs[:-3]
    assert (np.diff(live[:, 0]) >= 0).all() and (live[:, 1] > 0).all()
    change = np.flatnonzero(np.diff(live[:, 0])) + 1
    assert any(i % e for i in change), "a Pa run changes inside a step"
    assert (pairs[-3:] == [g, 0]).all()
    assert (st[:-1, 0] < g).all() and (st[:-1, 1:] == 0).any()
    assert (st[:-1, 1:] > 0).any() and len(set(st[:-1, 0])) > 1
    assert list(st[-1]) == [g] + [0] * e
    assert torch.equal(pa_ext[g], one) and not pbx[0].any()
    assert not torch.equal(torch_ops._norm_out(one, d), one)
    assert acc.shape == one.shape == pbx.shape[1:]
    _d, _a, _pa, _pb, _one, unsorted, _st = shim.gather_lanes_call(
        ctx, 4, e, steps, sort=False)
    assert (np.diff(unsorted[:-3, 0]) < 0).any()


@pytest.mark.parametrize("e,steps", STEPS)
@pytest.mark.parametrize("case", range(5))
def test_gather_source_on_cpu(case, e, steps):
    """csrc/replay_gather.cu's kernel body, built by g++ through
    tools/lane_shim, equals kernels.replay_gather_plain (K6) and
    replay_parow_plain (K7) digit for digit, their copies landing at once
    and at their wait."""
    shim = _lane_shim()
    assert len(shim.REPLAY_CASES) == 5
    n, mers, force_w, b, lanes = shim.REPLAY_CASES[case]
    lib = shim.load(shim.build_lib())
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    results = shim.compare_replay_gather(lib, ctx, b, e, steps, lanes,
                                         seed=case * 100 + e + steps)
    assert len(results) == 4 and all(ok for _what, ok in results), results


@pytest.mark.parametrize("case", range(5))
def test_gather_source_wide_digits(case):
    """The same at E = 16 on wide digits (every digit below 2^(w+6)):
    values past R, where REDC's outputs are no longer near-canonical, so
    the tree's association and each difference's lazy pass show in the
    digits (on reduced values a REDC or fold output is nearly always the
    canonical residue, whatever the association)."""
    shim = _lane_shim()
    n, mers, force_w, b, lanes = shim.REPLAY_CASES[case]
    lib = shim.load(shim.build_lib())
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    results = shim.compare_replay_gather(lib, ctx, b, 16, 3, lanes,
                                         seed=case + 11, wide=True)
    assert len(results) == 4 and all(ok for _what, ok in results), results


@pytest.mark.parametrize("case", range(5))
def test_gather_source_unsorted_entries(case):
    """The same at E = 16 on entries whose Pa rows are not sorted (K6
    reloads its Pa row at almost every entry, K7's steps jump between
    rows)."""
    shim = _lane_shim()
    n, mers, force_w, b, lanes = shim.REPLAY_CASES[case]
    lib = shim.load(shim.build_lib())
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    results = shim.compare_replay_gather(lib, ctx, b, 16, 3, lanes,
                                         seed=case + 7, sort=False)
    assert len(results) == 4 and all(ok for _what, ok in results), results
