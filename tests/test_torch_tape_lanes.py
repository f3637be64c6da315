"""K1's lane geometry and a numpy model of its lane schedule (no card
needed).

csrc/tape.cu runs K1 with a group of L lanes per curve, each lane holding
D = ceil(nw / L) digits of every operand (csrc/arith_lanes.cuh).  The host
picks L and D in limbs/kernels.py:tape_geometry; the tests below check that
every nw the kernels take gets a geometry that an instantiation covers.

LaneModel is the lane schedule of arith_lanes.cuh written in numpy, lane by
lane: cyclic column ownership (lane l owns columns l + k*L), the a*b terms
read beside zero pads, the columns' move to rows, REDC's quotient chain in
blocks of D columns (the block's owner broadcasts its columns, every lane
forms the block's quotients and the carry from them and adds q*n into its
own rows from a window of n), the lazy passes' exchange with the lane
below, and the fold's reads of the high digits at offset k0 = e / w.  It
is held digit for digit against torch_ops (the plain version) for L in
{1, 4, 8, 16, 32}.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_ecm_torch import params  # noqa: E402
from tpu_ecm_torch.curve import ops as curve_ops  # noqa: E402
from tpu_ecm_torch.limbs import build, kernels, layout, torch_ops  # noqa: E402

N416 = (205688069665150755269371147819668813122841983204197482918578443
        * 411376139330301510538742295639337626245683966408394965837157771)
M127 = (1 << 127) - 1
M1277 = (1 << 1277) - 1
U32 = np.uint32


def _sar(x, w):
    """Arithmetic right shift of uint32 words read as int32."""
    return (x.view(np.int32) >> w).view(U32)


class LaneModel:
    """The lane schedule of csrc/arith_lanes.cuh for one modulus at L
    lanes a curve.  Values are [L, D, B] uint32: lane l's register j holds
    digit l*D + j of each of B curves."""

    def __init__(self, ctx, lanes: int):
        p = ctx.p
        self.L, self.nw, self.w = lanes, p.nw, p.w
        self.mask = (1 << p.w) - 1
        self.D = -(-p.nw // lanes)
        self.LD = lanes * self.D
        self.norm = p.norm_inputs
        self.nprime = U32(ctx.nprime)
        self.nP = np.zeros(lanes + 2 * self.LD, U32)
        self.nP[lanes:lanes + p.nw] = layout.int_to_digits(ctx.n_int, p.w,
                                                           p.nw)
        self.e = ctx.mersenne_e
        if self.e:
            self.k0, self.s = divmod(self.e, p.w)
            cabs = abs(ctx.mersenne_c)
            cl = max(1, (cabs.bit_length() + p.w - 1) // p.w)
            self.c = layout.int_to_digits(cabs, p.w, cl).astype(U32)
            self.neg = ctx.mersenne_c < 0
        lane = np.arange(lanes)
        # the row of lane l's register j, [L, D, 1]
        self.row = (lane[:, None] * self.D + np.arange(self.D))[..., None]

    # digits [nw, B] int32 <-> [L, D, B]
    def to_lanes(self, x: np.ndarray) -> np.ndarray:
        flat = np.zeros((self.LD, x.shape[-1]), U32)
        flat[:self.nw] = x.astype(U32)
        return flat.reshape(self.L, self.D, -1)

    def digits(self, x: np.ndarray) -> np.ndarray:
        flat = x.reshape(self.LD, -1)
        assert not flat[self.nw:].any(), "digits above nw must stay zero"
        return flat[:self.nw].view(np.int32)

    def _lazy_digit(self, x, below, row, rows):
        lo = np.where(row == rows - 1, x, x & U32(self.mask))
        return np.where(row < rows, lo + _sar(below, self.w), U32(0))

    def lazy(self, x, rows):
        """One lazy pass in the block layout: lane l's first digit reads
        the top digit of lane l-1 (one shuffle); lane 0's has none."""
        prev = np.roll(x[:, -1], 1, axis=0)
        prev[0] = 0
        below = np.concatenate([prev[:, None], x[:, :-1]], axis=1)
        return self._lazy_digit(x, below, self.row, rows)

    def lazy2(self, lo, hi, rows):
        """One lazy pass over the halves lo (rows l*D+j) and hi (rows
        L*D+l*D+j): lane 0's first hi row sits on lane L-1's last lo row."""
        plo = np.roll(lo[:, -1], 1, axis=0)
        phi = np.roll(hi[:, -1], 1, axis=0)
        phi[0] = plo[0]
        plo[0] = 0
        blo = np.concatenate([plo[:, None], lo[:, :-1]], axis=1)
        bhi = np.concatenate([phi[:, None], hi[:, :-1]], axis=1)
        return (self._lazy_digit(lo, blo, self.row, rows),
                self._lazy_digit(hi, bhi, self.LD + self.row, rows))

    def ab_cols(self, a, b):
        """Lane l's columns l + k*L (k < 2D): for each r < L, the broadcast
        digits a[p*L + r] times b[l - r + m*L], b beside L zeros each side,
        into column (p + m)*L + l."""
        L, D, LD = self.L, self.D, self.LD
        bsz = a.shape[-1]
        s_a = a.reshape(LD, bsz)
        s_b = np.zeros((LD + 2 * L, bsz), U32)
        s_b[L:L + LD] = b.reshape(LD, bsz)
        col = np.zeros((L, 2 * D, bsz), U32)
        lane = np.arange(L)
        for r in range(L):
            av = s_a[np.arange(D) * L + r]
            bv = s_b[L + lane[:, None] - r + np.arange(D + 1)[None] * L]
            for p in range(D):
                col[:, p:p + D + 1] += av[p] * bv
        return col

    def rows_of(self, col):
        """Cyclic columns (lane l's column l + k*L) through sT to the two
        halves lo (rows l*D+j) and hi (rows L*D+l*D+j)."""
        L, D, LD = self.L, self.D, self.LD
        cols = np.arange(L)[:, None] + np.arange(2 * D) * L
        s_t = np.zeros((2 * LD, col.shape[-1]), U32)
        s_t[cols.reshape(-1)] = col.reshape(2 * LD, -1)
        return s_t[:LD].reshape(L, D, -1), s_t[LD:].reshape(L, D, -1)

    def redc(self, col):
        """The quotient chain in blocks of D columns: lane o broadcasts its
        columns, every lane forms the block's quotients and the carry from
        them, and adds q*n into its own rows from a window of n."""
        L, D, LD, nw, w = self.L, self.D, self.LD, self.nw, self.w
        lo, hi = self.rows_of(col)
        lane = np.arange(L)
        nr = self.nP[L:L + D]
        jj = np.arange(D)[:, None] - np.arange(D)[None, :] + D - 1
        carry = np.zeros(col.shape[-1], U32)
        o = 0
        while o * D < nw:
            blk = lo[o].copy()                  # D shuffles from lane o
            i0 = (lane - o) * D - (D - 1)
            idx = i0[:, None] + np.arange(2 * D - 1)
            wl = np.where(idx >= 0, self.nP[L + np.maximum(idx, 0)], U32(0))
            wh = self.nP[L + LD + idx]
            qv = np.zeros_like(blk)
            for j in range(D):
                if o * D + j < nw:
                    t = blk[j] + carry
                    qv[j] = (t * self.nprime) & U32(self.mask)
                    carry = _sar(t + qv[j] * self.nP[L], w)
                for j2 in range(j + 1, D):
                    blk[j2] += qv[j] * nr[j2 - j]
            add_lo = (wl[:, jj][..., None] * qv[None, None]).sum(
                axis=2, dtype=U32)
            add_hi = (wh[:, jj][..., None] * qv[None, None]).sum(
                axis=2, dtype=U32)
            lo = np.where((lane == o)[:, None, None], blk[None], lo + add_lo)
            hi = hi + add_hi
            o += 1
        rows = np.concatenate([lo.reshape(LD, -1), hi.reshape(LD, -1)])
        rows[nw] += carry                       # column nw
        s_t = np.zeros((LD, col.shape[-1]), U32)
        s_t[:nw] = rows[nw:2 * nw]
        out = s_t.reshape(L, D, -1)
        return self.lazy(self.lazy(out, nw), nw)

    def fold_once(self, lo, hi, rows, out_rows):
        """One fold from the old rows through shared memory: row i reads
        the high digits at k0 + i - l' and k0 + i - l' + 1."""
        s_t = np.concatenate([lo.reshape(self.LD, -1),
                              hi.reshape(self.LD, -1)])
        k0, s, w = self.k0, self.s, self.w
        smask = U32((1 << s) - 1)

        def row_of(x, i):
            acc = np.where(i < k0, x, np.where(i == k0, x & smask, U32(0)))
            for l2, cd in enumerate(self.c):
                j = i[..., 0] - l2                      # [L, D]
                ok = ((j >= 0) & (j < rows - k0))[..., None]
                jc = np.clip(j, 0, rows - k0 - 1)
                nxt_i = k0 + jc + 1
                nxt = np.where((nxt_i < rows)[..., None],
                               (s_t[np.minimum(nxt_i, 2 * self.LD - 1)]
                                & smask) << U32(w - s), U32(0))
                prod = U32(cd) * (_sar(s_t[k0 + jc], s) + nxt)
                acc = np.where(ok, acc - prod if self.neg else acc + prod,
                               acc)
            return np.where(i < out_rows, acc, U32(0))

        return row_of(lo, self.row), row_of(hi, self.LD + self.row)

    def fold(self, col):
        lo, hi = self.rows_of(col)
        rows = 2 * self.nw
        for rnd in range(3):
            lo, hi = self.lazy2(*self.lazy2(lo, hi, rows), rows)
            lo, hi = self.fold_once(lo, hi, rows,
                                    rows if rnd < 2 else self.nw)
        assert not hi.any()
        return self.lazy(self.lazy(lo, self.nw), self.nw)

    def mulmod(self, a, b):
        col = self.ab_cols(a, b)
        return self.fold(col) if self.e else self.redc(col)

    def norm1(self, x):
        return self.lazy(x, self.nw) if self.norm else x

    def xdbl(self, x, z, s):
        sp, dm = self.norm1(x + z), self.norm1(x - z)
        v, u = self.mulmod(dm, dm), self.mulmod(sp, sp)
        xo = self.mulmod(u, v)
        dm = self.norm1(u - v)
        sp = self.norm1(self.mulmod(dm, s) + v)
        return xo, self.mulmod(sp, dm)

    def xadd(self, x1, z1, x2, z2, xd, zd):
        s1, d1 = self.norm1(x1 + z1), self.norm1(x1 - z1)
        s2, d2 = self.norm1(x2 + z2), self.norm1(x2 - z2)
        u, v = self.mulmod(d1, s2), self.mulmod(s1, d2)
        sp, dm = self.norm1(u + v), self.norm1(u - v)
        sp, dm = self.mulmod(sp, sp), self.mulmod(dm, dm)
        return self.mulmod(sp, zd), self.mulmod(dm, xd)


def _values(ctx, rng, count, b=6):
    """count unreduced-looking operands [nw, B]: reduced random values
    through one product and a difference (the plain version's digits)."""
    d = torch_ops.device_ctx(ctx, "cpu")
    p = ctx.p
    k = (p.nbits - 1) // p.w

    def reduced():
        a = np.zeros((p.nw, b), np.int32)
        a[:k] = rng.integers(0, 1 << p.w, (k, b))
        return torch.from_numpy(a)

    out = []
    for _ in range(count):
        x, y = reduced(), reduced()
        out.append(torch_ops.submod_n(torch_ops.mulmod(x, y, d, pre=True),
                                      y, d).numpy())
    return d, out


MODULI = {
    "N416": lambda: params.make_monty(N416),             # nw = 36
    "N416w10": lambda: params.make_monty(N416, force_w=10),  # nw = 43
    "M127": lambda: params.make_monty(M127, mersenne=(127, 1)),
    "M127w12": lambda: params.make_monty(M127, mersenne=(127, 1),
                                         force_w=12),     # norm off
    "M1277": lambda: params.make_monty(M1277, mersenne=(1277, 1)),
}


@pytest.mark.parametrize("b", [1, 31, 33, 100, 2048])
def test_tape_geometry(b):
    """Every nw the kernels take gets lanes * digits >= nw, digits an
    instantiated count, lanes an accepted count, and blocks enough for B."""
    for nw in range(2, build.NW_MAX + 1):
        lanes, digits, per_block, blocks = kernels.tape_geometry(nw, b)
        assert lanes in kernels.TAPE_LANES
        assert digits in kernels.TAPE_DIGITS
        assert lanes * digits >= nw
        assert lanes * per_block == kernels.TAPE_BLOCK
        assert blocks * per_block >= b > (blocks - 1) * per_block
        # the fewest lanes that hold nw: one lane fewer would not
        if lanes > kernels.TAPE_LANES[0]:
            assert -(-nw // (lanes // 2)) > kernels.TAPE_DIGITS[-1]
    for bad in (1, build.NW_MAX + 1):
        with pytest.raises(ValueError, match="instantiation"):
            kernels.tape_geometry(bad, b)


def test_tape_geometry_main_path():
    """The flagship (nw = 36: 8 lanes, 512 warps for 2048 curves), the
    mersenne job (nw = 118: 16 lanes) and NW_MAX (32 lanes)."""
    assert kernels.tape_geometry(36, 2048) == (8, 5, 16, 128)
    assert kernels.tape_geometry(118, 2048) == (16, 8, 8, 256)
    assert kernels.tape_geometry(224, 33) == (32, 7, 4, 9)
    with pytest.raises(ValueError, match="batch"):
        kernels.tape_geometry(36, 0)


@pytest.mark.parametrize("lanes", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("modulus", ["N416", "N416w10", "M127", "M1277"])
def test_lane_model_products(modulus, lanes):
    """The lane schedule's mulmod and sqrmod equal torch_ops' digit for
    digit: REDC at N416 (nw = 36) and at nw = 43 (which no L > 1
    divides), the fold at M127 and M1277."""
    ctx = MODULI[modulus]()
    rng = np.random.default_rng(lanes * 1000 + ctx.p.nw)
    d, (a, b) = _values(ctx, rng, 2)
    model = LaneModel(ctx, lanes)
    got = model.digits(model.mulmod(model.to_lanes(a), model.to_lanes(b)))
    want = torch_ops.mulmod(torch.from_numpy(a), torch.from_numpy(b), d,
                            pre=True).numpy()
    np.testing.assert_array_equal(got, want)
    got = model.digits(model.mulmod(model.to_lanes(a), model.to_lanes(a)))
    want = torch_ops.sqrmod(torch.from_numpy(a), d, pre=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes", [4, 8, 32])
@pytest.mark.parametrize("modulus,norm", [("N416", True), ("N416w10", False),
                                          ("M127", True), ("M127w12", False)])
def test_lane_model_point_ops(modulus, norm, lanes):
    """xdbl and xadd on the lane schedule, with norm_inputs on (N416 at
    w = 12, M127 at w = 13) and off (N416 at w = 10, nw = 43; M127 at
    w = 12), equal curve.ops'."""
    ctx = MODULI[modulus]()
    assert ctx.p.norm_inputs == norm
    rng = np.random.default_rng(lanes + ctx.p.nw)
    d, vals = _values(ctx, rng, 7)
    model = LaneModel(ctx, lanes)
    lv = [model.to_lanes(v) for v in vals]
    tv = [torch.from_numpy(v) for v in vals]
    got = [model.digits(v) for v in model.xdbl(lv[0], lv[1], lv[6])]
    want = [v.numpy() for v in curve_ops.xdbl(tv[0], tv[1], tv[6], d)]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    got = [model.digits(v) for v in model.xadd(*lv[:6])]
    want = [v.numpy() for v in curve_ops.xadd(*tv[:6], d)]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def _lane_shim():
    """tools/lane_shim/check.py, loaded by path (tools is no package)."""
    import importlib.util
    import os
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the lane core for the CPU")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "lane_shim", "check.py")
    spec = importlib.util.spec_from_file_location("lane_shim_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", range(9))
def test_lane_core_source_on_cpu(case):
    """csrc/arith_lanes.cuh itself, built by g++ through tools/lane_shim
    (a std::thread per CUDA thread, shuffles through a per-warp buffer):
    a*b, a*a, a*b over a's slot (each paired with b*b), and the DUP and ADD
    programs equal the plain version digit for digit, for REDC
    (norm_inputs on and off) and Mersenne and pseudo-Mersenne folds."""
    shim = _lane_shim()
    assert len(shim.CASES) == 9
    n, mers, force_w, b, lanes = shim.CASES[case]
    lib = shim.load(shim.build_lib())
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    results = shim.compare(lib, ctx, b, lanes, seed=case)
    assert results and all(ok for _what, ok in results), results
