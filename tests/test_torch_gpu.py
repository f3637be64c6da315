"""Tests that need an NVIDIA GPU (marker `cuda`; they skip without one):
the fifteen CUDA kernels against their plain PyTorch versions (the digit
kernels in REDC and fold modes; K1-K9 also at ragged batches
and at every instantiation's edge nw, and a refused launch, K6-K8
their ptxas reports; K10-K15 at
ragged batches, at their K edges, a refused launch and their ptxas
reports, K11 also at counts 1, 2 and G - 1, K12 and K13 at counts 1, 2
and G, K15 at counts 0-3 at both tiles), the golden sweep
and the reference's t35 acceptance sweep through the port, and the RNS engine's, the Mersenne
fold's, the Edwards curves', the stage-2 replay modes', the noinv form's
and resume_stage2's finds through the driver on the card (and noinv's
row-sliced products).

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


@pytest.mark.parametrize("modulus,b", [("N64", 128), ("N416", 2048),
                                       ("M127", 128), ("M1277", 2048)])
def test_kernels_match_plain(cuda, modulus, b):
    """K1-K9 digit for digit against the plain versions run on the same
    card tensors (chip_smoke.py's cases, short stacks; K8 with slabs of 8
    rows): REDC at N64 and N416, the fold at M127 and M1277."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels

    n = getattr(chip_smoke, modulus)
    mers = (n.bit_length(), 1) if modulus.startswith("M") else None
    ctx = params.make_monty(n, mersenne=mers)
    rng = np.random.default_rng(7)
    cases, _slots = chip_smoke._kernel_cases(rng, ctx, b, chip_smoke.SHORT)
    assert "ed_tape" in cases
    kernels.reset_launches()
    for name, (kern, plain, _bound) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        assert kernels.launches[name] >= 1, name


def _ctx_at_nw(nw: int, fold: bool):
    """A modulus context with exactly nw digits: the largest radix whose
    column bound (with the entry pass) holds at nw, and a bits-bit odd N
    (REDC) or 2^bits - 1 (the fold), bits = w*(nw-1) - 4.  Past the int32
    column bound (nw > 210) no radix holds, and w = 9 is taken: columns may
    then wrap, in the kernel and in the plain version alike."""
    import random

    from tpu_ecm_torch import params
    limit = int(0.95 * 2**31)
    w = next((w for w in range(13, 5, -1)
              if params._digit_bound_fixed_point(w, nw, True) < limit), 9)
    bits = w * (nw - 1) - 4
    if fold:
        ctx = params.make_monty((1 << bits) - 1, mersenne=(bits, 1),
                                force_w=w)
    else:
        n = random.Random(nw).getrandbits(bits) | 1 | (1 << (bits - 1))
        ctx = params.make_monty(n, force_w=w)
    assert ctx.p.nw == nw
    return ctx


def _k1_against_plain(ctx, b: int, ops: int, seed: int):
    """K1 over the first `ops` entries of the flagship's stage-1 tape, with
    a NOP and an ADD whose dst is its own input appended, against
    curve.ops.run_tape on the same card tensors, digit for digit."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.curve import ops as curve_ops
    from tpu_ecm_torch.curve import prac
    from tpu_ecm_torch.limbs import kernels, torch_ops
    from tpu_ecm_torch.primes import primes_range
    tape = prac.stage1_tape(primes_range(0, 1000), 1000)[:ops]
    tape = np.concatenate([tape, [[2, 3, 1, 0, 0], [1, 2, 2, 1, 0]]]
                          ).astype(np.int32)
    d = torch_ops.device_ctx(ctx, "cuda")
    rng = np.random.default_rng(seed)
    nw = ctx.p.nw
    pts = chip_smoke._rand_planes(rng, ctx, (6, 2, nw, b))
    sc = chip_smoke._rand_planes(rng, ctx, (nw, b))
    want = curve_ops.run_tape(pts.clone(), tape, sc, d)
    kernels.reset_launches()
    got = kernels.tape(pts.clone(), tape, sc, d)
    torch.cuda.synchronize()
    assert kernels.launches["tape"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("fold", [False, True], ids=["redc", "fold"])
@pytest.mark.parametrize("b", [1, 33, 100])
def test_tape_ragged_batches(cuda, fold, b):
    """K1 at batches that leave the last block part empty (B = 1, 33, 100),
    at the flagship's N416 (REDC, 8 lanes a curve) and at M1277 (the fold,
    16 lanes), against its plain version digit for digit."""
    import chip_smoke
    from tpu_ecm_torch import params
    ctx = (params.make_monty(chip_smoke.M1277, mersenne=(1277, 1)) if fold
           else params.make_monty(chip_smoke.N416))
    _k1_against_plain(ctx, b, 24, b)


# every instantiation's smallest and largest nw (D = ceil(nw / lanes)),
# and the nw on each side of a change of lanes (32/33, 64/65, 128/129);
# the fold needs e >= w, so its smallest nw is 3
TAPE_EDGE_NW = (2, 3, 8, 9, 12, 13, 16, 17, 21, 25, 29, 32, 33, 64, 65, 128,
                129, 160, 192, 224)


@pytest.mark.parametrize("nw,fold", [
    (nw, fold) for nw in TAPE_EDGE_NW for fold in (False, True)
    if nw > 2 or not fold])
def test_tape_nw_edges(cuda, nw, fold):
    """K1 at the edges of its instantiations (limbs/kernels.py:
    tape_geometry) in both modes, at B = 5, against its plain version."""
    _k1_against_plain(_ctx_at_nw(nw, fold), 5, 12, nw)


def test_tape_refused_launch_raises(cuda, monkeypatch):
    """A geometry that no instantiation takes (9 digits a lane) is refused
    by the C entry point, the wrapper raises, and no launch is counted."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels, torch_ops
    ctx = params.make_monty(chip_smoke.N416)
    d = torch_ops.device_ctx(ctx, "cuda")
    pts = torch.zeros((6, 2, ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    sc = torch.zeros((ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(kernels, "tape_geometry",
                        lambda nw, b: (4, 9, 32, 1))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.tape(pts, np.asarray([[0, 0, 0, 0, 0]], np.int32), sc, d)
    assert kernels.launches["tape"] == 0


def _k5_against_plain(ctx, b: int, entries: int, seed: int):
    """K5 on a random replay block (chip_smoke._replay_idx: v-sorted live
    entries over a 9-row Pa group and 13 Pb rows, 5 live pads, 3 entries
    past the count) against kernels.replay_plain on the same card
    tensors, digit for digit."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, layout, torch_ops
    d = torch_ops.device_ctx(ctx, "cuda")
    rng = np.random.default_rng(seed)
    nw, rows, pb_rows = ctx.p.nw, 9, 13
    r = lambda *shape: chip_smoke._rand_planes(rng, ctx, shape + (nw, b))
    one = torch.from_numpy(layout.broadcast_int(ctx.r_mod_n, ctx.p.w, nw,
                                                b)).cuda()
    acc, pa_ext, pbx = r(), torch.cat([r(rows), one[None]]), r(pb_rows)
    pbx[0] = 0
    idx = chip_smoke._replay_idx(rng, rows, pb_rows, entries)
    want = kernels.replay_plain(acc, pa_ext, pbx, idx, d)
    kernels.reset_launches()
    got = kernels.replay(acc, pa_ext, pbx, idx, d)
    torch.cuda.synchronize()
    assert kernels.launches["replay"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("fold", [False, True], ids=["redc", "fold"])
@pytest.mark.parametrize("b", [1, 33, 100])
def test_replay_ragged_batches(cuda, fold, b):
    """K5 at batches that leave the last block part empty (B = 1, 33, 100),
    at the flagship's N416 (REDC, 8 lanes a curve) and at M1277 (the fold,
    16 lanes), live counts of every residue mod 4, against its plain
    version digit for digit."""
    import chip_smoke
    from tpu_ecm_torch import params
    ctx = (params.make_monty(chip_smoke.M1277, mersenne=(1277, 1)) if fold
           else params.make_monty(chip_smoke.N416))
    for entries in (40, 41, 42, 43):
        _k5_against_plain(ctx, b, entries, b + entries)


@pytest.mark.parametrize("nw,fold", [
    (nw, fold) for nw in TAPE_EDGE_NW for fold in (False, True)
    if nw > 2 or not fold])
def test_replay_nw_edges(cuda, nw, fold):
    """K5 at the edges of its instantiations (limbs/kernels.py:
    tape_geometry, shared with K1) in both modes, at B = 5, against its
    plain version."""
    _k5_against_plain(_ctx_at_nw(nw, fold), 5, 24 + nw % 4, nw)


def test_replay_refused_launch_raises(cuda, monkeypatch):
    """A geometry that no instantiation of K5 takes (9 digits a lane) is
    refused by the C entry point, the wrapper raises, and no launch is
    counted."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels, torch_ops
    ctx = params.make_monty(chip_smoke.N416)
    d = torch_ops.device_ctx(ctx, "cuda")
    acc = torch.zeros((ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    tab = torch.zeros((2, ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(kernels, "tape_geometry",
                        lambda nw, b: (4, 9, 32, 1))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.replay(acc, tab, tab, np.asarray([1, 1 << 16 | 1],
                                                 np.int32), d)
    assert kernels.launches["replay"] == 0


# the Pa group and Pb table rows of the gather-form replays' card tests
REPLAY_ROWS, REPLAY_PB_ROWS = 11, 13


def _replay_tables(ctx, b: int, seed: int):
    """(card ctx, rng, acc, pa_ext, pbx, one) of a gather-form replay on
    the card: random reduced planes over a REPLAY_ROWS-row Pa group with
    the one row after it and REPLAY_PB_ROWS Pb rows, row 0 zero."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.limbs import layout, torch_ops
    d = torch_ops.device_ctx(ctx, "cuda")
    rng = np.random.default_rng(seed)
    nw = ctx.p.nw
    r = lambda *shape: chip_smoke._rand_planes(rng, ctx, shape + (nw, b))
    one = torch.from_numpy(layout.broadcast_int(ctx.r_mod_n, ctx.p.w, nw,
                                                b)).cuda()
    acc = r()
    pa_ext = torch.cat([r(REPLAY_ROWS), one[None]])
    pbx = r(REPLAY_PB_ROWS)
    pbx[0] = 0
    return d, rng, acc, pa_ext, pbx, one


def _k6k7_against_plain(ctx, b: int, entries: int, seed: int):
    """K6 and K7 on the gather and parow calls of a random replay block
    (chip_smoke._random_calls: v-sorted live entries over an 11-row Pa
    group and 13 Pb rows in 16-entry steps; K6's ending in pads (G, 0),
    K7's short steps holding pads pb = 0) against
    kernels.replay_gather_plain and replay_parow_plain on the same card
    tensors, digit for digit, one launch each."""
    import chip_smoke
    from tpu_ecm_torch.limbs import kernels
    from tpu_ecm_torch.stage2 import exec as s2
    d, rng, acc, pa_ext, pbx, one = _replay_tables(ctx, b, seed)
    rows, e = REPLAY_ROWS, s2.REPLAY_E
    calls = chip_smoke._random_calls(rng, rows, REPLAY_PB_ROWS, entries)
    pairs, steps = calls["gather"], calls["parow"]
    assert (steps[:, 1:] == 0).any() and (pairs[-5:] == [rows, 0]).all()
    want6 = kernels.replay_gather_plain(acc, pa_ext, pbx, pairs, e, d)
    want7 = kernels.replay_parow_plain(acc, pa_ext, pbx, steps, one, d)
    kernels.reset_launches()
    got6 = kernels.replay_gather(acc, pa_ext, pbx, pairs, d, e=e)
    got7 = kernels.replay_parow(acc, pa_ext, pbx, steps, one, d)
    torch.cuda.synchronize()
    assert kernels.launches["replay_gather"] == 1
    assert kernels.launches["replay_parow"] == 1
    assert torch.equal(got6, want6)
    assert torch.equal(got7, want7)


@pytest.mark.parametrize("fold", [False, True], ids=["redc", "fold"])
@pytest.mark.parametrize("b", [1, 33, 100])
def test_gather_ragged_batches(cuda, fold, b):
    """K6 and K7 at batches that leave the last block part empty (B = 1,
    33, 100), at the flagship's N416 (REDC, 8 lanes a curve) and at M1277
    (the fold, 16 lanes), against their plain versions digit for digit."""
    import chip_smoke
    from tpu_ecm_torch import params
    ctx = (params.make_monty(chip_smoke.M1277, mersenne=(1277, 1)) if fold
           else params.make_monty(chip_smoke.N416))
    _k6k7_against_plain(ctx, b, 96, b)


@pytest.mark.parametrize("nw,fold", [
    (nw, fold) for nw in TAPE_EDGE_NW for fold in (False, True)
    if nw > 2 or not fold])
def test_gather_nw_edges(cuda, nw, fold):
    """K6 and K7 at the edges of their instantiations (limbs/kernels.py:
    tape_geometry, shared with K1) in both modes, at B = 5, against their
    plain versions."""
    _k6k7_against_plain(_ctx_at_nw(nw, fold), 5, 48 + 16 * (nw % 2), nw)


@pytest.mark.parametrize("name", ["replay_gather", "replay_parow"])
def test_gather_refused_launch_raises(cuda, monkeypatch, name):
    """A geometry that no instantiation of K6 or K7 takes (9 digits a
    lane) is refused by the C entry point, the wrapper raises, and no
    launch is counted."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels, torch_ops
    ctx = params.make_monty(chip_smoke.N416)
    d = torch_ops.device_ctx(ctx, "cuda")
    acc = torch.zeros((ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    tab = torch.zeros((2, ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(kernels, "tape_geometry",
                        lambda nw, b: (4, 9, 32, 1))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        if name == "replay_gather":
            kernels.replay_gather(acc, tab, tab,
                                  np.ones((16, 2), np.int32), d, e=16)
        else:
            kernels.replay_parow(acc, tab, tab, np.ones((1, 17), np.int32),
                                 acc, d)
    assert kernels.launches[name] == 0


def test_gather_ptxas_no_stack_or_spills(cuda):
    """nvcc -Xptxas -v reports no stack frame and no spills for K6 and K7
    at every digit count D = 2..8."""
    import chip_smoke
    from tpu_ecm_torch.limbs import build, kernels
    build.library()
    for kernel in ("replay_gather_lanes_kernel",
                   "replay_parow_lanes_kernel"):
        report = chip_smoke._lanes_ptxas(kernel)
        assert set(report) == set(kernels.TAPE_DIGITS), (kernel, report)
        for digits, x in report.items():
            assert (x["stack_bytes"], x["spill_store_bytes"],
                    x["spill_load_bytes"]) == (0, 0, 0), (kernel, digits, x)


def _k9_against_plain(ctx, b: int, ops: int, seed: int):
    """K9 over the first `ops` entries of the B1=1000 Edwards stage-1 tape
    with an add of table row 0, a subtraction of row Tp - 1 (each after a
    DBLT) and a NOP appended, against curve.edops.run_tape on the same
    card tensors, digit for digit."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.curve import edops, edwards
    from tpu_ecm_torch.limbs import kernels, torch_ops
    from tpu_ecm_torch.primes import primes_range
    tp = 1 << (edwards.DEFAULT_W - 2)
    tape = edwards.stage1_tape(primes_range(0, 1000), 1000)[0][:ops]
    tape = np.concatenate([tape, [[edwards.ED_DBLT, 0], [edwards.ED_ADD, 0],
                                  [edwards.ED_DBLT, 0],
                                  [edwards.ED_SUB, tp - 1],
                                  [edwards.ED_NOP, 1]]]).astype(np.int32)
    d = torch_ops.device_ctx(ctx, "cuda")
    rng = np.random.default_rng(seed)
    nw = ctx.p.nw
    acc = chip_smoke._rand_planes(rng, ctx, (4, nw, b))
    table = chip_smoke._rand_planes(rng, ctx, (tp, 3, nw, b))
    want = edops.run_tape(acc.clone(), tape, table, d)
    kernels.reset_launches()
    got = kernels.ed_tape(acc.clone(), tape, table, d)
    torch.cuda.synchronize()
    assert kernels.launches["ed_tape"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("fold", [False, True], ids=["redc", "fold"])
@pytest.mark.parametrize("b", [1, 33, 100])
def test_ed_tape_ragged_batches(cuda, fold, b):
    """K9 at batches that leave the last block part empty (B = 1, 33, 100),
    at the flagship's N416 (REDC, 8 lanes a curve) and at M1277 (the fold,
    16 lanes), against its plain version digit for digit."""
    import chip_smoke
    from tpu_ecm_torch import params
    ctx = (params.make_monty(chip_smoke.M1277, mersenne=(1277, 1)) if fold
           else params.make_monty(chip_smoke.N416))
    _k9_against_plain(ctx, b, 24, b)


@pytest.mark.parametrize("nw,fold", [
    (nw, fold) for nw in TAPE_EDGE_NW for fold in (False, True)
    if nw > 2 or not fold])
def test_ed_tape_nw_edges(cuda, nw, fold):
    """K9 at the edges of its instantiations (limbs/kernels.py:
    tape_geometry, shared with K1 and K5) in both modes, at B = 5, against
    its plain version."""
    _k9_against_plain(_ctx_at_nw(nw, fold), 5, 12, nw)


def test_ed_tape_refused_launch_raises(cuda, monkeypatch):
    """A geometry that no instantiation of K9 takes (9 digits a lane) is
    refused by the C entry point, the wrapper raises, and no launch is
    counted."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels, torch_ops
    ctx = params.make_monty(chip_smoke.N416)
    d = torch_ops.device_ctx(ctx, "cuda")
    acc = torch.zeros((4, ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    tab = torch.zeros((16, 3, ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(kernels, "tape_geometry",
                        lambda nw, b: (4, 9, 32, 1))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.ed_tape(acc, np.asarray([[0, 0]], np.int32), tab, d)
    assert kernels.launches["ed_tape"] == 0


def _k2_against_plain(ctx, b: int, count: int, seed: int):
    """K2 chaining `count` rows from random points p1, p2 with difference
    pd against kernels.chain_plain on the same card tensors, digit for
    digit."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, torch_ops
    d = torch_ops.device_ctx(ctx, "cuda")
    rng = np.random.default_rng(seed)
    p1, p2, pd = (chip_smoke._rand_planes(rng, ctx, (2, ctx.p.nw, b))
                  for _ in range(3))
    want = kernels.chain_plain(p1, p2, pd, count, d)
    kernels.reset_launches()
    got = kernels.chain(p1, p2, pd, count, d)
    torch.cuda.synchronize()
    assert kernels.launches["chain"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("fold", [False, True], ids=["redc", "fold"])
@pytest.mark.parametrize("b", [1, 33, 100])
def test_chain_ragged_batches(cuda, fold, b):
    """K2 at batches that leave the last block part empty (B = 1, 33, 100),
    at the flagship's N416 (REDC, 8 lanes a curve) and at M1277 (the fold,
    16 lanes), with 1, 2 and 3 rows, against its plain version digit for
    digit."""
    import chip_smoke
    from tpu_ecm_torch import params
    ctx = (params.make_monty(chip_smoke.M1277, mersenne=(1277, 1)) if fold
           else params.make_monty(chip_smoke.N416))
    for count in (1, 2, 3):
        _k2_against_plain(ctx, b, count, b + count)


@pytest.mark.parametrize("nw,fold", [
    (nw, fold) for nw in TAPE_EDGE_NW for fold in (False, True)
    if nw > 2 or not fold])
def test_chain_nw_edges(cuda, nw, fold):
    """K2 at the edges of its instantiations (limbs/kernels.py:
    tape_geometry, shared with K1, K5 and K9) in both modes, at B = 5, 6
    or 7 rows (the last on either program), against its plain version."""
    _k2_against_plain(_ctx_at_nw(nw, fold), 5, 6 + nw % 2, nw)


def test_chain_refused_launch_raises(cuda, monkeypatch):
    """A geometry that no instantiation of K2 takes (9 digits a lane) is
    refused by the C entry point, the wrapper raises, and no launch is
    counted."""
    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels, torch_ops
    ctx = params.make_monty(chip_smoke.N416)
    d = torch_ops.device_ctx(ctx, "cuda")
    pt = torch.zeros((2, ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(kernels, "tape_geometry",
                        lambda nw, b: (4, 9, 32, 1))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.chain(pt, pt, pt, 2, d)
    assert kernels.launches["chain"] == 0


def _k3k4_against_plain(ctx, b: int, count: int, seed: int):
    """K3 on a random stack zs of `count` rows from the one, and K4 on
    random xs and zs with pres its prefixes and a random total_inv, each
    against kernels.prefix_plain and apply_inverse_plain on the same card
    tensors, digit for digit."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, layout, torch_ops
    d = torch_ops.device_ctx(ctx, "cuda")
    rng = np.random.default_rng(seed)
    nw = ctx.p.nw
    xs, zs = (chip_smoke._rand_planes(rng, ctx, (count, nw, b))
              for _ in range(2))
    tinv = chip_smoke._rand_planes(rng, ctx, (nw, b))
    one = torch.from_numpy(layout.broadcast_int(ctx.r_mod_n, ctx.p.w, nw,
                                                b)).cuda()
    want3 = kernels.prefix_plain(zs, one, d)
    pres = torch.cat([one[None], want3[:-1]]).contiguous()
    want4 = kernels.apply_inverse_plain(xs, zs, pres, tinv, d)
    kernels.reset_launches()
    got3 = kernels.prefix(zs, one, d)
    got4 = kernels.apply_inverse(xs, zs, pres, tinv, d)
    torch.cuda.synchronize()
    assert kernels.launches["prefix"] == 1
    assert kernels.launches["apply_inverse"] == 1
    assert torch.equal(got3, want3)
    assert torch.equal(got4, want4)


@pytest.mark.parametrize("fold", [False, True], ids=["redc", "fold"])
@pytest.mark.parametrize("b", [1, 33, 100])
def test_batch_inverse_ragged_batches(cuda, fold, b):
    """K3 and K4 at batches that leave the last block part empty (B = 1,
    33, 100), at the flagship's N416 (REDC, 8 lanes a curve) and at M1277
    (the fold, 16 lanes), with 1 to 5 rows (K4's last row on either parity
    of its step pairs), against their plain versions digit for digit."""
    import chip_smoke
    from tpu_ecm_torch import params
    ctx = (params.make_monty(chip_smoke.M1277, mersenne=(1277, 1)) if fold
           else params.make_monty(chip_smoke.N416))
    for count in range(1, 6):
        _k3k4_against_plain(ctx, b, count, b + count)


@pytest.mark.parametrize("nw,fold", [
    (nw, fold) for nw in TAPE_EDGE_NW for fold in (False, True)
    if nw > 2 or not fold])
def test_batch_inverse_nw_edges(cuda, nw, fold):
    """K3 and K4 at the edges of their instantiations (limbs/kernels.py:
    tape_geometry, shared with K1, K2, K5 and K9) in both modes, at B = 5,
    6 or 7 rows, against their plain versions."""
    _k3k4_against_plain(_ctx_at_nw(nw, fold), 5, 6 + nw % 2, nw)


@pytest.mark.parametrize("name", ["prefix", "apply_inverse"])
def test_batch_inverse_refused_launch_raises(cuda, monkeypatch, name):
    """A geometry that no instantiation of K3 or K4 takes (9 digits a
    lane) is refused by the C entry point, the wrapper raises, and no
    launch is counted."""
    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels, torch_ops
    ctx = params.make_monty(chip_smoke.N416)
    d = torch_ops.device_ctx(ctx, "cuda")
    pl = torch.zeros((2, ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(kernels, "tape_geometry",
                        lambda nw, b: (4, 9, 32, 1))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        if name == "prefix":
            kernels.prefix(pl, pl[0], d)
        else:
            kernels.apply_inverse(pl, pl, pl, pl[0], d)
    assert kernels.launches[name] == 0


@pytest.mark.parametrize("modulus,b", [("N256", 128), ("row21", 1024)])
def test_rns_kernels_match_plain(cuda, modulus, b):
    """K10-K15 residue for residue against the plain versions run on the
    same card tensors (chip_smoke.py's cases, short stacks), at N256
    (K=24) and the row-21 geometry (K=200)."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels, rns

    n = chip_smoke.N256 if modulus == "N256" else chip_smoke.row21_n()
    ctx = params.make_monty(n)
    host = rns.make_rns(ctx, cw=rns.choose_cw(ctx.p.nbits))
    rc = rns.device_ctx(host, "cuda")
    rng = np.random.default_rng(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases, _slots = chip_smoke._rns_kernel_cases(rng, gen, host, rc, b)
    kernels.reset_launches()
    for name, (kern, plain, _bound) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        assert kernels.launches[name] >= 1, name


def _k10_against_plain(rc, b: int, seed: int):
    """K10 on chip_smoke.RNS_EDGE_TAPE (every opcode, dst aliasing each
    input) over random residues at B curves, one launch, against
    rns_exec.run_tape on the same card tensors, residue for residue."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, rns_exec, rns_kernels
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pts = chip_smoke._rand_residues(gen, rc, (6, 2, rc.rows, b))
    sc = chip_smoke._rand_residues(gen, rc, (rc.rows, b))
    tape = np.asarray(chip_smoke.RNS_EDGE_TAPE, np.int32)
    want = rns_exec.run_tape(pts.clone(), tape, sc, rc)
    kernels.reset_launches()
    got = rns_kernels.tape(pts.clone(), tape, sc, rc)
    torch.cuda.synchronize()
    assert kernels.launches["rns_tape"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 7, 9, 1024])
def test_rns_tape_batches(cuda, b):
    """K10 at row 21's K=200 (8 curves a block, weights in shared memory)
    at batches that leave the last block part empty (B = 1, 7, 9; B % 4
    != 0 takes the scalar loads) and at the rns job's B = 1024."""
    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import rns
    ctx = params.make_monty(chip_smoke.row21_n())
    rc = rns.device_ctx(rns.make_rns(ctx, cw=rns.choose_cw(ctx.p.nbits)),
                        "cuda")
    assert rc.K == 200
    _k10_against_plain(rc, b, b)


@pytest.mark.parametrize("K", [2, 222, 224, 520])
def test_rns_tape_k_edges(cuda, K):
    """K10 at the smallest K, at the last K whose weights fit in shared
    memory (222), one step past it (224: 4 curves a block, the fragments
    from the global table) and at K_MAX = 520, on synthetic tables
    (chip_smoke.synthetic_rns), B = 9."""
    import chip_smoke
    from tpu_ecm_torch.limbs import rns_kernels
    assert rns_kernels.tape_geometry(K, 9).resident == (K <= 222)
    _k10_against_plain(chip_smoke.synthetic_rns(K, K, "cuda"), 9, K)


def test_rns_tape_refused_launch_raises(cuda, monkeypatch):
    """T = 8 at K = 224, whose weights do not fit in shared memory, is
    refused by the C entry point, the wrapper raises, and no launch is
    counted."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, rns_kernels
    rc = chip_smoke.synthetic_rns(224, 1, "cuda")
    pts = torch.zeros((6, 2, rc.rows, 8), dtype=torch.int32, device=cuda)
    sc = torch.zeros((rc.rows, 8), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(rns_kernels, "tape_geometry",
                        lambda K, b: rns_kernels.TapeGeometry(8, 512, 1, 0,
                                                              True))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        rns_kernels.tape(pts, np.asarray([[0, 0, 0, 0, 0]], np.int32), sc,
                         rc)
    assert kernels.launches["rns_tape"] == 0


def test_rns_tape_ptxas_no_stack_or_spills(cuda):
    """nvcc -Xptxas -v reports no stack frame and no spills for either
    instantiation of K10 (T = 4, 8)."""
    import chip_smoke
    from tpu_ecm_torch.limbs import build
    build.library()
    report = chip_smoke._lanes_ptxas("rns_tape_kernel")
    assert set(report) == {4, 8}
    for tile, x in report.items():
        assert (x["stack_bytes"], x["spill_store_bytes"],
                x["spill_load_bytes"]) == (0, 0, 0), (tile, x)


def _k14_against_plain(rc, b: int, seed: int, steps: int = 4):
    """K14 on `steps` 16-entry steps of v-sorted random entries ending in
    pad entries (chip_smoke._random_calls' gather call) over random
    residues at B curves, one launch, against
    rns_kernels.replay_gather_plain on the same card tensors, residue for
    residue."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, rns_kernels
    from tpu_ecm_torch.stage2 import exec as s2
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g, pb_rows, e = 11, 13, s2.REPLAY_E
    pairs = chip_smoke._random_calls(rng, g, pb_rows, steps * e)["gather"]
    assert pairs.shape[0] == steps * e and (pairs[-5:] == [g, 0]).all()
    acc = chip_smoke._rand_residues(gen, rc, (rc.rows, b))
    pa_ext = chip_smoke._rand_residues(gen, rc, (g + 1, rc.rows, b))
    pbx = chip_smoke._rand_residues(gen, rc, (pb_rows, rc.rows, b))
    pbx[0] = 0
    want = rns_kernels.replay_gather_plain(acc, pa_ext, pbx, pairs, e, rc)
    kernels.reset_launches()
    got = rns_kernels.replay_gather(acc, pa_ext, pbx, pairs, rc, e=e)
    torch.cuda.synchronize()
    assert kernels.launches["rns_replay_gather"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 7, 9, 1024])
def test_rns_gather_batches(cuda, b):
    """K14 at row 21's K=200 (8 curves a block, the weights in shared
    memory, two products a pass) at batches that leave the last block
    part empty (B = 1, 7, 9; B % 4 != 0 takes the scalar loads) and at the
    rns job's B = 1024."""
    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import rns
    ctx = params.make_monty(chip_smoke.row21_n())
    rc = rns.device_ctx(rns.make_rns(ctx, cw=rns.choose_cw(ctx.p.nbits)),
                        "cuda")
    assert rc.K == 200
    _k14_against_plain(rc, b, b)


@pytest.mark.parametrize("K", [2, 222, 224, 520])
def test_rns_gather_k_edges(cuda, K):
    """K14 at the smallest K, at the last K whose weights fit in shared
    memory (222: one product a pass), one step past it (224: 4 curves a
    block, the fragments from the global table) and at K_MAX = 520, on
    synthetic tables (chip_smoke.synthetic_rns), B = 9."""
    import chip_smoke
    from tpu_ecm_torch.limbs import rns_kernels
    g = rns_kernels.gather_geometry(K, 9)
    assert g.resident == (K <= 222) and g.halves == (1 if K == 222 else 2)
    _k14_against_plain(chip_smoke.synthetic_rns(K, K, "cuda"), 9, K)


def test_rns_gather_refused_launch_raises(cuda, monkeypatch):
    """T = 8 with two halves at K = 224, which does not fit in shared
    memory, is refused by the C entry point, the wrapper raises, and no
    launch is counted."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, rns_kernels
    rc = chip_smoke.synthetic_rns(224, 1, "cuda")
    acc = torch.zeros((rc.rows, 8), dtype=torch.int32, device=cuda)
    rows = torch.zeros((2, rc.rows, 8), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(rns_kernels, "gather_geometry",
                        lambda K, b: rns_kernels.GatherGeometry(
                            8, 2, 512, 1, 0, True, 1))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        rns_kernels.replay_gather(acc, rows, rows,
                                  np.zeros((16, 2), np.int32), rc, e=16)
    assert kernels.launches["rns_replay_gather"] == 0


def test_rns_gather_ptxas_no_stack_or_spills(cuda):
    """nvcc -Xptxas -v reports no stack frame and no spills for any
    instantiation of K14 (T = 8 with two halves and with one, T = 4 with
    two)."""
    import chip_smoke
    from tpu_ecm_torch.limbs import build
    build.library()
    report = chip_smoke._lanes_ptxas("rns_replay_gather_kernel")
    assert set(report) == {(4, 2), (8, 1), (8, 2)}
    for key, x in report.items():
        assert (x["stack_bytes"], x["spill_store_bytes"],
                x["spill_load_bytes"]) == (0, 0, 0), (key, x)


def _k15_against_plain(rc, b: int, seed: int, count=None, tile=None):
    """K15 on a stream call (chip_smoke._replay_idx: 292 v-sorted live
    entries, 5 pads and 3 entries past the count, so past four of the
    ring's 64-entry chunks; or, with `count` given, 11 slots of which the
    first `count` are live, the rest read as entries past the count) over
    random residues at B curves, one launch (at `tile` if given), against
    rns_kernels.replay_plain on the same card tensors (its products from
    CUDA graphs, chip_smoke._graphed_products), residue for residue."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, rns_kernels
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g, pb_rows = 11, 13
    idx = chip_smoke._replay_idx(rng, g, pb_rows,
                                 300 if count is None else 11)
    if count is not None:
        idx[0] = count
    acc = chip_smoke._rand_residues(gen, rc, (rc.rows, b))
    pa_ext = chip_smoke._rand_residues(gen, rc, (g + 1, rc.rows, b))
    pbx = chip_smoke._rand_residues(gen, rc, (pb_rows, rc.rows, b))
    pbx[0] = 0
    with chip_smoke._graphed_products():
        want = rns_kernels.replay_plain(acc, pa_ext, pbx, idx, rc)
    kernels.reset_launches()
    geometry = rns_kernels.replay_geometry
    if tile:
        rns_kernels.replay_geometry = lambda K, b: geometry(K, b, tile=tile)
    try:
        got = rns_kernels.replay(acc, pa_ext, pbx, idx, rc)
    finally:
        rns_kernels.replay_geometry = geometry
    torch.cuda.synchronize()
    assert kernels.launches["rns_replay"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 7, 9, 1024])
def test_rns_replay_batches(cuda, b):
    """K15 at row 21's K=200 (8 curves a block, the weights in shared
    memory, the next entry's rows loaded a pass ahead) at batches that
    leave the last block part empty (B = 1, 7, 9; B % 4 != 0 takes the
    scalar loads) and at the rns job's B = 1024, 297 entries."""
    _ctx, rc = _row21_rc()
    _k15_against_plain(rc, b, b)


@pytest.mark.parametrize("count", [0, 1, 2, 3])
@pytest.mark.parametrize("tile", [8, 4])
def test_rns_replay_counts(cuda, count, tile):
    """K15 at row 21's K=200, B = 9, at both tiles (T = 4 asked for),
    on no entry (acc copied), one, two and three, with live entries in the
    slots past the count."""
    _ctx, rc = _row21_rc()
    _k15_against_plain(rc, 9, 15 + count, count, tile)


@pytest.mark.parametrize("K", [2, 222, 224, 520])
def test_rns_replay_k_edges(cuda, K):
    """K15 at the smallest K, at the last K whose weights fit in shared
    memory beside the entry ring (222), one step past it (224: 4 curves a
    block, the fragments from the global table) and at K_MAX = 520, on
    synthetic tables (chip_smoke.synthetic_rns), B = 9."""
    import chip_smoke
    from tpu_ecm_torch.limbs import rns_kernels
    g = rns_kernels.replay_geometry(K, 9)
    assert g.resident == (K <= 222) and g.tile == (8 if K <= 222 else 4)
    _k15_against_plain(chip_smoke.synthetic_rns(K, K, "cuda"), 9, K)


def test_rns_replay_refused_launch_raises(cuda, monkeypatch):
    """T = 8 at K = 224, whose weights do not fit in shared memory, is
    refused by the C entry point, the wrapper raises, no launch is
    counted, and the next launch runs (no sticky error)."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, rns_kernels
    rc = chip_smoke.synthetic_rns(224, 1, "cuda")
    acc = torch.zeros((rc.rows, 8), dtype=torch.int32, device=cuda)
    rows = torch.zeros((2, rc.rows, 8), dtype=torch.int32, device=cuda)
    idx = np.asarray([1, 1 << 16 | 1], np.int32)
    geometry = rns_kernels.replay_geometry
    monkeypatch.setattr(rns_kernels, "replay_geometry",
                        lambda K, b: rns_kernels.TapeGeometry(8, 512, 1, 0,
                                                              True))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        rns_kernels.replay(acc, rows, rows, idx, rc)
    assert kernels.launches["rns_replay"] == 0
    monkeypatch.setattr(rns_kernels, "replay_geometry", geometry)
    rns_kernels.replay(acc, rows, rows, idx, rc)
    torch.cuda.synchronize()
    assert kernels.launches["rns_replay"] == 1


def test_rns_replay_ptxas_no_stack_or_spills(cuda):
    """nvcc -Xptxas -v reports no stack frame and no spills for either
    instantiation of K15 (T = 4, 8)."""
    import chip_smoke
    from tpu_ecm_torch.limbs import build
    build.library()
    report = chip_smoke._lanes_ptxas("rns_replay_kernel")
    assert set(report) == {4, 8}
    for tile, x in report.items():
        assert (x["stack_bytes"], x["spill_store_bytes"],
                x["spill_load_bytes"]) == (0, 0, 0), (tile, x)


def _row21_rc():
    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import rns
    ctx = params.make_monty(chip_smoke.row21_n())
    rc = rns.device_ctx(rns.make_rns(ctx, cw=rns.choose_cw(ctx.p.nbits)),
                        "cuda")
    assert rc.K == 200
    return ctx, rc


def _k11_against_plain(rc, b: int, seed: int, count: int = 3):
    """K11 on `count` rows from random seed points p1, p2 and Pd at B
    curves, one launch, against rns_kernels.chain_plain on the same card
    tensors (its products from CUDA graphs, chip_smoke._graphed_products),
    residue for residue."""
    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, rns_kernels
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p1, p2, pd = (chip_smoke._rand_residues(gen, rc, (2, rc.rows, b))
                  for _ in range(3))
    with chip_smoke._graphed_products():
        want = rns_kernels.chain_plain(p1, p2, pd, count, rc)
    kernels.reset_launches()
    got = rns_kernels.chain(p1, p2, pd, count, rc)
    torch.cuda.synchronize()
    assert kernels.launches["rns_chain"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 7, 9, 1024])
def test_rns_chain_batches(cuda, b):
    """K11 at row 21's K=200 (8 curves a block, the weights in shared
    memory, two products a pass) at batches that leave the last block
    part empty (B = 1, 7, 9; B % 4 != 0 takes the scalar loads) and at the
    rns job's B = 1024, three rows (out[i-2] read back from the output)."""
    _ctx, rc = _row21_rc()
    _k11_against_plain(rc, b, b)


@pytest.mark.parametrize("K", [2, 208, 210, 222, 224, 520])
def test_rns_chain_k_edges(cuda, K):
    """K11 at the smallest K, at the last K where two halves fit beside the
    resident weights (208), at the first and last where only one does
    (210, 222), one step past the shared-memory limit (224: 4 curves a
    block, the fragments from the global table) and at K_MAX = 520, on
    synthetic tables (chip_smoke.synthetic_rns), B = 9."""
    import chip_smoke
    from tpu_ecm_torch.limbs import rns_kernels
    g = rns_kernels.chain_geometry(K, 9)
    assert g.resident == (K <= 222)
    assert g.halves == (1 if K in (210, 222) else 2)
    _k11_against_plain(chip_smoke.synthetic_rns(K, K, "cuda"), 9, K)


@pytest.mark.parametrize("count", ["1", "2", "G-1"])
def test_rns_chain_counts(cuda, count):
    """K11 at row 21's K=200, B = 9, on one row and on two (the seeds as
    the only differences) and on G - 1 rows, the chain after a pending
    point of the rns job's Pa groups (stage2/exec.py), G the group the
    memory rule picks for the job's 1024 curves on this card."""
    import chip_smoke
    from tpu_ecm_torch.stage2 import exec as s2, plan
    ctx, rc = _row21_rc()
    n = int(count) if count != "G-1" else None
    if n is None:
        job = chip_smoke.RNS_JOB
        sp = plan.make_stage2_params(job["b1"], job["b2"], nw=ctx.p.nw,
                                     batch=1024)
        free = s2.device_free_bytes("cuda")
        n = s2.pa_group_for_memory(rc.rows * 1024 * 4, sp.num_pb, free) - 1
        assert n >= 255
    _k11_against_plain(rc, 9, 11, n)


def test_rns_chain_refused_launch_raises(cuda, monkeypatch):
    """T = 8 at K = 224, whose weights do not fit in shared memory, is
    refused by the C entry point, the wrapper raises, and no launch is
    counted."""
    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, rns_kernels
    rc = chip_smoke.synthetic_rns(224, 1, "cuda")
    pts = torch.zeros((2, rc.rows, 8), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(rns_kernels, "chain_geometry",
                        lambda K, b: rns_kernels.ChainGeometry(
                            8, 2, 512, 1, 0, True))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        rns_kernels.chain(pts, pts, pts, 3, rc)
    assert kernels.launches["rns_chain"] == 0


def test_rns_chain_ptxas_no_stack_or_spills(cuda):
    """nvcc -Xptxas -v reports no stack frame and no spills for any
    instantiation of K11 (T = 8 with two halves and with one, T = 4 with
    two)."""
    import chip_smoke
    from tpu_ecm_torch.limbs import build
    build.library()
    report = chip_smoke._lanes_ptxas("rns_chain_kernel")
    assert set(report) == {(4, 2), (8, 1), (8, 2)}
    for key, x in report.items():
        assert (x["stack_bytes"], x["spill_store_bytes"],
                x["spill_load_bytes"]) == (0, 0, 0), (key, x)


def _k12k13_against_plain(rc, b: int, seed: int, count: int = 3):
    """K12 on a random stack of `count` z rows from a random `one`, and K13
    on random xs, zs, pres of `count` rows and a random total_inv (both
    take any canonical residues), at B curves, one launch each, against
    rns_kernels.prefix_plain and apply_inverse_plain on the same card
    tensors (their products from CUDA graphs,
    chip_smoke._graphed_products), residue for residue."""
    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, rns_kernels
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs, zs, pres = (chip_smoke._rand_residues(gen, rc, (count, rc.rows, b))
                    for _ in range(3))
    one, tinv = (chip_smoke._rand_residues(gen, rc, (rc.rows, b))
                 for _ in range(2))
    with chip_smoke._graphed_products():
        want_pre = rns_kernels.prefix_plain(zs, one, rc)
        want = rns_kernels.apply_inverse_plain(xs, zs, pres, tinv, rc)
    kernels.reset_launches()
    got_pre = rns_kernels.prefix(zs, one, rc)
    got = rns_kernels.apply_inverse(xs, zs, pres, tinv, rc)
    torch.cuda.synchronize()
    assert kernels.launches["rns_prefix"] == 1
    assert kernels.launches["rns_apply_inverse"] == 1
    assert torch.equal(got_pre, want_pre)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 7, 9, 1024])
def test_rns_batch_inverse_batches(cuda, b):
    """K12 and K13 at row 21's K=200 (8 curves a block, the weights in
    shared memory; K13 two products a pass) at batches that leave the last
    block part empty (B = 1, 7, 9; B % 4 != 0 takes the scalar loads) and
    at the rns job's B = 1024, three rows."""
    _ctx, rc = _row21_rc()
    _k12k13_against_plain(rc, b, b)


@pytest.mark.parametrize("K", [2, 208, 210, 222, 224, 520])
def test_rns_batch_inverse_k_edges(cuda, K):
    """K12 and K13 at the smallest K, at the last K where K13's two halves
    fit beside the resident weights (208), at the first and last where
    only one does (210, 222), one step past the shared-memory limit (224:
    4 curves a block, the fragments from the global table) and at K_MAX =
    520, on synthetic tables (chip_smoke.synthetic_rns), B = 9."""
    import chip_smoke
    from tpu_ecm_torch.limbs import rns_kernels
    p = rns_kernels.prefix_geometry(K, 9)
    a = rns_kernels.apply_inverse_geometry(K, 9)
    assert p.resident == a.resident == (K <= 222) and p.halves == 1
    assert a.halves == (1 if K in (210, 222) else 2)
    _k12k13_against_plain(chip_smoke.synthetic_rns(K, K, "cuda"), 9, K)


@pytest.mark.parametrize("count", ["1", "2", "G"])
def test_rns_batch_inverse_counts(cuda, count):
    """K12 and K13 at row 21's K=200, B = 9, on one row, on two and on G
    rows, the Pa group the memory rule picks for the rns job's 1024 curves
    on this card (stage2/exec.py inverts a group's rows in one call)."""
    import chip_smoke
    from tpu_ecm_torch.stage2 import exec as s2, plan
    ctx, rc = _row21_rc()
    n = int(count) if count != "G" else None
    if n is None:
        job = chip_smoke.RNS_JOB
        sp = plan.make_stage2_params(job["b1"], job["b2"], nw=ctx.p.nw,
                                     batch=1024)
        free = s2.device_free_bytes("cuda")
        n = s2.pa_group_for_memory(rc.rows * 1024 * 4, sp.num_pb, free)
        assert n >= 256
    _k12k13_against_plain(rc, 9, 13, n)


@pytest.mark.parametrize("name", ["rns_prefix", "rns_apply_inverse"])
def test_rns_batch_inverse_refused_launch_raises(cuda, monkeypatch, name):
    """T = 8 at K = 224, whose weights do not fit in shared memory, is
    refused by the C entry point, the wrapper raises, and no launch is
    counted."""
    import chip_smoke
    from tpu_ecm_torch.limbs import kernels, rns_kernels
    rc = chip_smoke.synthetic_rns(224, 1, "cuda")
    pl = torch.zeros((3, rc.rows, 8), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(rns_kernels, "prefix_geometry",
                        lambda K, b: rns_kernels.ChainGeometry(
                            8, 1, 512, 1, 0, True))
    monkeypatch.setattr(rns_kernels, "apply_inverse_geometry",
                        lambda K, b: rns_kernels.ChainGeometry(
                            8, 2, 512, 1, 0, True))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        if name == "rns_prefix":
            rns_kernels.prefix(pl, pl[0], rc)
        else:
            rns_kernels.apply_inverse(pl, pl, pl, pl[0], rc)
    assert kernels.launches[name] == 0


def test_rns_batch_inverse_ptxas_no_stack_or_spills(cuda):
    """nvcc -Xptxas -v reports no stack frame and no spills for any
    instantiation of K12 (T = 4, 8) or K13 (T = 8 with two halves and
    with one, T = 4 with two)."""
    import chip_smoke
    from tpu_ecm_torch.limbs import build
    build.library()
    for kernel, keys in (("rns_prefix_kernel", {4, 8}),
                         ("rns_apply_inverse_kernel",
                          {(4, 2), (8, 1), (8, 2)})):
        report = chip_smoke._lanes_ptxas(kernel)
        assert set(report) == keys, kernel
        for key, x in report.items():
            assert (x["stack_bytes"], x["spill_store_bytes"],
                    x["spill_load_bytes"]) == (0, 0, 0), (kernel, key, x)


@pytest.mark.parametrize("which", ["N71", "N2355"])
def test_rns_finds_on_card(cuda, tmp_path, which):
    """The RNS engine through the driver on the card: N71 (engine="rns")
    and the 2355-bit P35*prp(2320) ("auto" routes it to RNS) find P35 in
    stage 2 at sigma 112."""
    import chip_smoke
    from tpu_ecm_torch import driver
    from tpu_ecm_torch.limbs import kernels
    n = chip_smoke.N71 if which == "N71" else chip_smoke.n2355()
    kernels.reset_launches()
    res = driver.ECMDriver(_run_cfg(
        tmp_path, n=n, curves=4, b1=300, b2=10000, sigma=110,
        stop_on_factor=False, engine="rns" if which == "N71" else "auto")
    ).run()
    assert any(h.factor % chip_smoke.P35 == 0 and h.stage == 2
               and h.sigma == 112 for h in res.factors), res.factors
    from tpu_ecm_torch.stage2.exec import RnsOps
    assert kernels.launches[RnsOps.replay_kernels[RnsOps.default_replay]]
    assert not kernels.launches["tape"]


def test_mersenne_finds_on_card(cuda, tmp_path):
    """tests/test_e2e.py:497-511 through the port on the card: on
    M101 = 2^101 - 1 (the fold), 12 curves from sigma 500, sigma 511 finds
    the P13 in stage 1 at B1=1e4 and sigma 502 in stage 2 at B2=1e6."""
    from tpu_ecm_torch import driver
    m101 = (1 << 101) - 1
    d = driver.ECMDriver(_run_cfg(
        tmp_path, n=m101, curves=12, b1=10_000, b2=1_000_000, sigma=500,
        stop_on_factor=False))
    assert d.ctx.is_mersenne and d.ctx.mersenne_e == 101
    hits = {(h.sigma, h.stage) for h in d.run().factors
            if h.factor == 7432339208719}
    assert {(511, 1), (502, 2)} <= hits, sorted(hits)


@pytest.mark.parametrize("sigma,b2,stage,want", [(44, 300, 1, 46),
                                                 (28, 10000, 2, 29)])
def test_edwards_finds_on_card(cuda, tmp_path, sigma, b2, stage, want):
    """tests/test_edwards.py:154-165 through the port on the card: N71, 4
    Edwards curves, B1=300; K9 runs stage 1."""
    import chip_smoke
    from tpu_ecm_torch import driver
    from tpu_ecm_torch.limbs import kernels
    kernels.reset_launches()
    res = driver.ECMDriver(_run_cfg(
        tmp_path, n=chip_smoke.N71, curves=4, b1=300, b2=b2, sigma=sigma,
        curve_mode="edwards")).run()
    hit = [h for h in res.factors if h.factor == chip_smoke.P35]
    assert hit and (hit[0].stage, hit[0].sigma) == (stage, want), res.factors
    assert kernels.launches["ed_tape"] >= 1


@pytest.mark.parametrize("engine,mode", [("digit", "gather"),
                                         ("digit", "parow"),
                                         ("digit", "resident"),
                                         ("rns", "gather")])
def test_replay_modes_on_card(cuda, tmp_path, engine, mode):
    """N71 finds P35 in stage 2 at sigma 112 through the gather, parow and
    resident replays (K6, K7, K8, K14) on the card, launching its mode's
    kernel and no other replay kernel."""
    import chip_smoke
    from tpu_ecm_torch import driver
    from tpu_ecm_torch.limbs import kernels
    kernels.reset_launches()
    res = driver.ECMDriver(_run_cfg(
        tmp_path, n=chip_smoke.N71, curves=4, b1=300, b2=10000, sigma=110,
        engine=engine, replay=mode)).run()
    assert (chip_smoke.P35, 2, 112) in {(h.factor, h.stage, h.sigma)
                                        for h in res.factors}
    from tpu_ecm_torch.stage2.exec import DigitOps, RnsOps
    own = (DigitOps if engine == "digit" else RnsOps).replay_kernels
    assert kernels.launches[own[mode]] >= 1
    assert not any(kernels.launches[k] for m, k in own.items() if m != mode)


def test_noinv_finds_on_card(cuda, tmp_path):
    """cross="noinv" through the driver on the card: N71 finds P35 in
    stage 2 at sigma 112, its finds are a subset of the inv run's, no
    inversion runs, and K1 and K2 launch but no K3-K8."""
    import chip_smoke
    from tpu_ecm_torch import driver
    from tpu_ecm_torch.limbs import kernels
    kw = dict(n=chip_smoke.N71, curves=4, b1=300, b2=10000, sigma=110,
              stop_on_factor=False)
    inv = driver.ECMDriver(_run_cfg(tmp_path, **kw)).run()
    kernels.reset_launches()
    (tmp_path / "noinv").mkdir()
    res = driver.ECMDriver(_run_cfg(tmp_path / "noinv", cross="noinv",
                                    **kw)).run()
    hits = {(h.factor, h.stage, h.sigma) for h in res.factors}
    assert (chip_smoke.P35, 2, 112) in hits
    assert hits <= {(h.factor, h.stage, h.sigma) for h in inv.factors}
    assert res.counters["numinv"] == 0
    assert kernels.launches["tape"] and kernels.launches["chain"]
    assert not any(kernels.launches[k] for k in (
        "prefix", "apply_inverse", "replay", "replay_gather",
        "replay_parow", "replay_resident"))


def test_noinv_row_slices_on_card(cuda):
    """The noinv products (DigitOps.mul_planes) on card tensors at N416,
    B=2048: cut into 7-row slices, in the slices the card's free memory
    gives, and on the CPU, the digits are equal."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import torch_ops
    from tpu_ecm_torch.stage2.exec import DigitOps
    ctx = params.make_monty(chip_smoke.N416)
    rng = np.random.default_rng(3)
    a, b = (chip_smoke._rand_planes(rng, ctx, (40, ctx.p.nw, 2048))
            for _ in range(2))
    ops = DigitOps(ctx, torch_ops.device_ctx(ctx, cuda))
    assert ops._rows_per_product(2048) >= 1
    whole = ops.mul_planes(a, b)
    ops.row_slice = 7
    sliced = ops.mul_planes(a, b)
    cpu = DigitOps(ctx, torch_ops.device_ctx(ctx, "cpu")).mul_planes(
        a.cpu(), b.cpu())
    assert torch.equal(whole, sliced) and torch.equal(whole.cpu(), cpu)


@pytest.mark.parametrize("engine", ["digit", "rns"])
def test_resume_on_card(cuda, tmp_path, engine):
    """resume_stage2 on the card: N71's stage-1 file (4 curves from sigma
    110, B1=300) resumed to B2=10000 finds P35 at sigma 112 in stage 2,
    through the engine's stage-2 kernels."""
    import chip_smoke
    from tpu_ecm_torch import driver
    from tpu_ecm_torch.limbs import kernels
    driver.ECMDriver(_run_cfg(tmp_path, n=chip_smoke.N71, curves=4, b1=300,
                              b2=300, sigma=110, engine=engine)).run()
    kernels.reset_launches()
    res = driver.resume_stage2(str(tmp_path / "save_b1.txt"), 10000,
                               verbose=0, device="cuda", engine=engine,
                               results_path=str(tmp_path / "r.txt"))
    assert (chip_smoke.P35, 2, 112) in {(h.factor, h.stage, h.sigma)
                                        for h in res.factors}
    assert all(kernels.launches[k] for k in chip_smoke._job_kernels(engine)
               if k not in ("tape", "rns_tape"))


def test_resident_refused_launch_raises(cuda):
    """K8's tallest slab is sized from the card (opt-in shared memory per
    block less the kernel's static shared memory and its slots, in rows of
    the block's curves at tape_geometry's lanes and digits), and one block
    of B = 64 takes it: a slab one row taller is refused by the wrapper,
    and by the C entry point, whose error does not leak into the next
    launch, which runs and equals the plain version."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import build, kernels, torch_ops
    ctx = params.make_monty(chip_smoke.N71)
    d = torch_ops.device_ctx(ctx, "cuda")
    nw, b = ctx.p.nw, 64
    lanes, digits, _per_block, _blocks = kernels.tape_geometry(nw, b)
    sm = kernels.resident_smem(nw, cuda)
    cap = sm.max_rows
    assert kernels.resident_slab_rows(nw, b, cuda) == cap
    assert sm.row == 4 * kernels.TAPE_BLOCK * digits
    assert sm.static + sm.block_bytes(cap) <= sm.optin \
        < sm.static + sm.block_bytes(cap + 1)
    rng = np.random.default_rng(5)
    r = lambda *shape: chip_smoke._rand_planes(rng, ctx, shape + (nw, b))
    acc, pa, pbx = r(), r(3), r(cap + 2)
    ent = np.asarray([[0, 1], [1, 2], [2, 0], [2, 0]], np.int32)
    slabs = np.asarray([[0, 0, 1]], np.int32)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.replay_resident(acc, pa, pbx, ent, slabs, cap + 1, d, e=4)
    dev = torch.from_numpy(ent).cuda()
    dsl = torch.from_numpy(slabs).cuda()
    out = torch.empty_like(acc)
    rc = build.library().tpuecm_replay_resident(
        acc.data_ptr(), out.data_ptr(), pa.data_ptr(), pbx.data_ptr(),
        cap + 2, dev.data_ptr(), dsl.data_ptr(), 1, cap + 1, 4,
        *kernels._mod(d), b, lanes, digits,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert rc != 0
    kernels.reset_launches()
    got = kernels.replay_resident(acc, pa, pbx, ent, slabs, cap, d, e=4)
    torch.cuda.synchronize()
    want = kernels.replay_resident_plain(acc, pa, pbx, ent, slabs, cap, 4,
                                         d)
    assert torch.equal(got, want) and kernels.launches["replay_resident"] == 1


@pytest.mark.parametrize("modulus,b,per_sm", [("N416", 2048, 1),
                                               ("M1277", 2048, 2),
                                               ("N416", 4224, 2),
                                               ("M1277", 4224, 2)])
def test_resident_slab_rows_rule(cuda, modulus, b, per_sm):
    """K8's default slab height is the tallest at which an SM holds the
    blocks that put the whole launch on the card at once: one block an SM
    at the flagship's 128 blocks (the tallest slab), two at M1277's 256
    and at B = 4224 (M1277's 528 blocks would need four, which no slab
    allows beside the slots)."""
    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels
    mers = (1277, 1) if modulus == "M1277" else None
    nw = params.make_monty(getattr(chip_smoke, modulus), mersenne=mers).p.nw
    cap = kernels.resident_slab_rows(nw, b, cuda)
    assert kernels.resident_blocks_per_sm(nw, cap, cuda) == per_sm
    if per_sm == 1:
        assert cap == kernels.resident_smem(nw, cuda).max_rows
    else:
        assert kernels.resident_blocks_per_sm(nw, cap + 1, cuda) < per_sm
    assert kernels.resident_blocks_per_sm(nw, 1, cuda) < 4


def test_resident_bad_geometry_refused(cuda, monkeypatch):
    """A geometry that no instantiation of K8 takes (9 digits a lane) is
    refused by the C entry points, the wrapper raises, and no launch is
    counted."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels, torch_ops
    ctx = params.make_monty(chip_smoke.N416)
    d = torch_ops.device_ctx(ctx, "cuda")
    acc = torch.zeros((ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    tab = torch.zeros((2, ctx.p.nw, 32), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(kernels, "tape_geometry",
                        lambda nw, b: (4, 9, 32, 1))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="failed"):
        kernels.replay_resident(acc, tab, tab, np.ones((16, 2), np.int32),
                                np.asarray([[0, 0, 1]], np.int32), 1, d,
                                e=16)
    assert kernels.launches["replay_resident"] == 0


def _k8_against_plain(ctx, b: int, entries: int, seed: int, cap: int = 4):
    """K8 on the resident call of a random replay block
    (chip_smoke._random_calls with slabs of cap rows: v-sorted live entries
    over an 11-row Pa group and 13 Pb rows in 16-entry steps, four slabs,
    the last one row, each slab's part padded with (G, 0)) against
    kernels.replay_resident_plain on the same card tensors, digit for
    digit, one launch."""
    import chip_smoke
    from tpu_ecm_torch.limbs import kernels
    from tpu_ecm_torch.stage2 import exec as s2
    d, rng, acc, pa_ext, pbx, _one = _replay_tables(ctx, b, seed)
    e = s2.REPLAY_E
    res = chip_smoke._random_calls(rng, REPLAY_ROWS, REPLAY_PB_ROWS, entries,
                                   cap)["resident"]
    assert res.slabs.shape[0] > 1 and (res.entries[:, 1] == 0).any()
    want = kernels.replay_resident_plain(acc, pa_ext, pbx, res.entries,
                                         res.slabs, cap, e, d)
    kernels.reset_launches()
    got = kernels.replay_resident(acc, pa_ext, pbx, res.entries, res.slabs,
                                  cap, d, e=e)
    torch.cuda.synchronize()
    assert kernels.launches["replay_resident"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("fold", [False, True], ids=["redc", "fold"])
@pytest.mark.parametrize("b", [1, 33, 100])
def test_resident_ragged_batches(cuda, fold, b):
    """K8 at batches that leave the last block part empty (B = 1, 33, 100),
    at the flagship's N416 (REDC, 8 lanes a curve) and at M1277 (the fold,
    16 lanes), against its plain version digit for digit."""
    import chip_smoke
    from tpu_ecm_torch import params
    ctx = (params.make_monty(chip_smoke.M1277, mersenne=(1277, 1)) if fold
           else params.make_monty(chip_smoke.N416))
    _k8_against_plain(ctx, b, 96, b)


@pytest.mark.parametrize("nw,fold", [
    (nw, fold) for nw in TAPE_EDGE_NW for fold in (False, True)
    if nw > 2 or not fold])
def test_resident_nw_edges(cuda, nw, fold):
    """K8 at the edges of its instantiations (limbs/kernels.py:
    tape_geometry, shared with K1) in both modes, at B = 5, against its
    plain version."""
    _k8_against_plain(_ctx_at_nw(nw, fold), 5, 48 + 16 * (nw % 2), nw)


def test_resident_ptxas_no_stack_or_spills(cuda):
    """nvcc -Xptxas -v reports no stack frame and no spills for K8 at
    every digit count D = 2..8."""
    import chip_smoke
    from tpu_ecm_torch.limbs import build, kernels
    build.library()
    report = chip_smoke._lanes_ptxas("replay_resident_lanes_kernel")
    assert set(report) == set(kernels.TAPE_DIGITS), report
    for digits, x in report.items():
        assert (x["stack_bytes"], x["spill_store_bytes"],
                x["spill_load_bytes"]) == (0, 0, 0), (digits, x)


def test_wrappers_reject_mixed_devices(cuda):
    from tpu_ecm_torch import params
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


def _sharded_summary(tmp_path, tag, sharder, **kw):
    """A driver run on the card (the sharder's devices, or cuda) with its
    factor list, residues, counters and the bytes of its three files."""
    from tpu_ecm_torch import driver
    d = tmp_path / tag
    d.mkdir()
    res = driver.ECMDriver(_run_cfg(d, sharder=sharder, **kw)).run()
    return dict(
        factors=[(h.factor, h.stage, h.curve, h.sigma) for h in res.factors],
        residues=res.stage1_residues, counters=res.counters,
        curves_run=res.curves_run,
        files=[(d / f).read_bytes() for f in ("save_b1.txt", "checkpoint.txt",
                                              "ecm_results.txt")])


@pytest.mark.parametrize("engine", ["digit", "rns"])
def test_sharder_repeated_device_equals_one_device(cuda, tmp_path, engine):
    """Sharder(["cuda:0", "cuda:0"]): two shards on one card, stage 2 in a
    thread each, give the one-device run of N71 (8 curves from sigma 110,
    B1=300, B2=10000, stage 1 in three prime chunks): the same factor
    list, residues, counters and file bytes, with P35 at sigma 112."""
    import chip_smoke
    from tpu_ecm_torch.parallel import Sharder
    kw = dict(n=chip_smoke.N71, curves=8, b1=300, b2=10000, sigma=110,
              prime_chunk=100, engine=engine, stop_on_factor=False)
    one = _sharded_summary(tmp_path, "one", None, **kw)
    two = _sharded_summary(tmp_path, "two", Sharder(["cuda:0", "cuda:0"]),
                           **kw)
    assert two == one
    assert (chip_smoke.P35, 2, 2, 112) in two["factors"]


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs (torch.cuda.device_count() < 2)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_wrapper_refuses_tensors_on_two_cards(two_cards):
    """A kernel wrapper given tensors on two cards raises before any
    launch."""
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels, torch_ops
    ctx = params.make_monty(34359738421 * 68719476767)
    d0 = torch_ops.device_ctx(ctx, two_cards[0])
    one = torch.zeros((ctx.p.nw, 32), dtype=torch.int32,
                      device=two_cards[0])
    other = one.to(two_cards[1])
    kernels.reset_launches()
    with pytest.raises(ValueError, match="context"):
        kernels.prefix(other[None].contiguous(), one, d0)
    assert kernels.launches["prefix"] == 0


def test_launch_follows_the_tensors_card(two_cards):
    """With card 0 current, K3 on the last card's tensors runs there, on
    that card's current stream, and equals its plain version."""
    import numpy as np

    import chip_smoke
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import kernels, torch_ops
    ctx = params.make_monty(chip_smoke.N416)
    rng = np.random.default_rng(5)
    zs = chip_smoke._rand_planes(rng, ctx, (5, ctx.p.nw, 256))
    one = chip_smoke._rand_planes(rng, ctx, (ctx.p.nw, 256))
    last = two_cards[-1]
    torch.cuda.set_device(two_cards[0])
    got = kernels.prefix(zs.to(last), one.to(last),
                         torch_ops.device_ctx(ctx, last))
    assert got.device == last and torch.cuda.current_device() == 0
    want = kernels.prefix_plain(zs.cpu(), one.cpu(),
                                torch_ops.device_ctx(ctx, "cpu"))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("engine", ["digit", "rns"])
def test_every_card_equals_one_card(two_cards, tmp_path, engine):
    """Sharder() over every visible card gives the one-card run of the
    N71 job, bytes and counters and all."""
    import chip_smoke
    from tpu_ecm_torch.parallel import Sharder
    kw = dict(n=chip_smoke.N71, curves=8, b1=300, b2=10000, sigma=110,
              prime_chunk=100, engine=engine, stop_on_factor=False)
    sh = Sharder()
    assert sh.devices == two_cards
    kw["curves"] = sh.round_batch(8)
    one = _sharded_summary(tmp_path, "one", None, **kw)
    every = _sharded_summary(tmp_path, "every", sh, **kw)
    assert every == one
