"""The noinv cross-product form of the port's stage 2 (Stage2Runner(cross=
"noinv"), RunConfig.cross) held against tpu_ecm's: the same P61 stage-1
points as tests/test_stage2.py:173 give the same accumulator digits and Pb
table through both runners (at B2=4000, and at B2=8000, whose 565 entries
fill a 512-entry segment and part of the next), also with every product
cut into 3-row slices; acc_noinv = acc_inv * prod(z_a * z_b) over the captured operands;
the driver's noinv finds on N71 are a subset of inv's, with no
inversion; and the three refused configurations raise."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpu_ecm import params  # noqa: E402
from tpu_ecm.curve import oracle, prac, suyama  # noqa: E402
from tpu_ecm.limbs import jnp_ops, layout  # noqa: E402
from tpu_ecm.primes import primes_range  # noqa: E402
from tpu_ecm.stage2 import exec as j_exec  # noqa: E402
from tpu_ecm.stage2 import plan as j_plan  # noqa: E402
from tpu_ecm_torch import convert  # noqa: E402
from tpu_ecm_torch import driver  # noqa: E402
from tpu_ecm_torch.limbs import kernels  # noqa: E402
from tpu_ecm_torch.stage2 import exec as t_exec  # noqa: E402
from tpu_ecm_torch.stage2 import plan as t_plan  # noqa: E402

from test_e2e import N71, P35  # noqa: E402

torch.set_num_threads(1)

P61 = (1 << 61) - 1
B1 = 300
SIGMAS = [40, 41, 42, 43]


def _stage1_points(ctx):
    """tests/test_stage2.py:173's stage-1 (X, Z, s) of SIGMAS by the exact
    integer oracle, packed as digit planes."""
    dom = oracle.IntDomain(ctx)
    s1 = []
    for c in (suyama.build_one_curve(ctx, s) for s in SIGMAS):
        X, Z, s = c.x_mont, c.z_mont, c.s_mont
        for _ in range(prac.stage1_powers_of_two(B1)):
            X, Z = oracle.xdbl_int(dom, X, Z, s)
        for q in primes_range(3, B1).tolist():
            k = 1
            while True:
                tape = []
                prac.prac_tape(int(q), tape)
                X, Z = oracle.run_tape_int(ctx, tape, X, Z, s)[0]
                k *= int(q)
                if k * int(q) >= B1:
                    break
        s1.append((X, Z, s))
    p = ctx.p
    pt = np.stack([layout.pack_batch([t[0] for t in s1], p.w, p.nw),
                   layout.pack_batch([t[1] for t in s1], p.w, p.nw)])
    return pt, layout.pack_batch([t[2] for t in s1], p.w, p.nw)


@functools.lru_cache(maxsize=None)
def _p61(b2):
    """The P61 context, stage-1 points, pairmap to b2 and tpu_ecm's noinv
    runner after its one chunk."""
    ctx = params.make_monty(P61)
    jd = jnp_ops.device_ctx(ctx)
    pt, s_const = _stage1_points(ctx)
    sp = j_plan.make_stage2_params(B1, b2)
    pmap = j_plan.pair(sp, primes_range(B1, b2 + 1000), B1, b2)[:3]
    jr = j_exec.Stage2Runner(ctx, jd, sp, jnp.asarray(pt),
                             jnp.asarray(s_const), B1, cross="noinv")
    segments = []
    orig = jr.ops.replay_segment_noinv

    def grab(acc, pa_ext, pbx, idx):
        segments.append(np.asarray(idx))
        return orig(acc, pa_ext, pbx, idx)

    jr.ops.replay_segment_noinv = grab
    jr.init()
    jr.run_chunk(*pmap)
    tdc = convert.device_ctx(np.asarray(jd.n), np.asarray(jd.c), jd.p,
                             jd.nprime, jd.mersenne_e, jd.mersenne_c_sign,
                             "cpu")
    return dict(ctx=ctx, tdc=tdc, pt=pt, s_const=s_const, pmap=pmap,
                b2=b2, jr=jr, want=jr.result(), segments=segments)


def _port_runner(f, cross, row_slice=None, capture=None):
    ops = t_exec.DigitOps(f["ctx"], f["tdc"])
    ops.row_slice = row_slice
    if capture is not None:
        orig = ops.replay_segment_noinv

        def grab(acc, pa_ext, pbx, idx):
            capture.append((pa_ext.numpy().copy(), idx.copy()))
            return orig(acc, pa_ext, pbx, idx)

        ops.replay_segment_noinv = grab
    sp = t_plan.make_stage2_params(B1, f["b2"])
    tr = t_exec.Stage2Runner(f["ctx"], f["tdc"], sp,
                             torch.from_numpy(f["pt"].copy()),
                             torch.from_numpy(f["s_const"].copy()), ops=ops,
                             cross=cross)
    tr.init()
    tr.run_chunk(*f["pmap"])
    return tr


@pytest.mark.parametrize("b2,row_slice", [(4000, None), (8000, None),
                                          (8000, 3)],
                         ids=["4000", "8000", "8000-3rows"])
def test_noinv_runner_equals_jax_digit_for_digit(b2, row_slice):
    """The port's noinv runner against tpu_ecm's on the same points: the
    acc planes and the (X, Z, X*Z) Pb table equal digit for digit, with
    every product whole or cut into 3-row slices (slices change no
    association); the segments are tpu_ecm's, entry for entry with their
    (G, 0) pads (at B2=8000 two of them: 512 and 53 entries padded to
    64; at these moduli R is so far above n that a product's digits
    would not show another association); the counters equal and no
    inversion ran."""
    p61 = _p61(b2)
    kernels.reset_launches()
    caps = []
    tr = _port_runner(p61, "noinv", row_slice=row_slice, capture=caps)
    assert len(caps) == len(p61["segments"])
    for (_pa, got), want in zip(caps, p61["segments"]):
        np.testing.assert_array_equal(got, want)
    want = p61["want"]
    np.testing.assert_array_equal(tr.acc.numpy(), np.asarray(p61["jr"].acc))
    np.testing.assert_array_equal(tr.pbx.numpy(), np.asarray(p61["jr"].pbx))
    got = tr.result()
    assert got.acc == want.acc
    assert (got.paired, got.ptadds, got.ptdups, got.numinv) == (
        want.paired, want.ptadds, want.ptdups, 0)
    assert not got.factors and not want.factors
    # the slots are the segments' power-of-two sizes, pads included
    assert got.slots >= got.paired
    assert sum(kernels.launches.values()) == 0     # CPU: plain versions


def test_noinv_acc_is_inv_acc_times_z_products():
    """acc_noinv = acc_inv * prod(z_a * z_b) (mod n) with the z planes of
    the operands the port's noinv replay read (tests/test_stage2.py:173's
    relation): every cross product Xa*Zb - Xb*Za is the affine difference
    scaled by its rows' z, so a wrong row breaks it."""
    p61 = _p61(4000)
    ctx, n = p61["ctx"], P61
    caps = []
    tr = _port_runner(p61, "noinv", capture=caps)
    ti = _port_runner(p61, "inv")
    res, res_i = tr.result(), ti.result()
    assert res.paired == res_i.paired > 0 and res.numinv == 0
    p = ctx.p
    rinv = pow(p.R, -1, n)
    pbx = tr.pbx.numpy()
    zprod = [1] * len(SIGMAS)
    for pa_ext, idx in caps:
        for j, u in idx.tolist():
            if u == 0:                      # pad entry: contributes one
                continue
            za = layout.unpack_batch(pa_ext[j, 1], p.w)
            zb = layout.unpack_batch(pbx[u, 1], p.w)
            for i in range(len(SIGMAS)):
                zprod[i] = (zprod[i] * (za[i] * rinv % n) % n
                            * (zb[i] * rinv % n) % n)
    for i in range(len(SIGMAS)):
        assert res.acc[i] == res_i.acc[i] * zprod[i] % n, i


def test_noinv_finds_subset_of_inv(tmp_path):
    """tests/test_e2e.py:206 through the port's driver: with cross="noinv"
    the sigma-112 stage-2 find on N71 still surfaces, the finds are a
    subset of the inv finds, and no inversion ran."""
    kw = dict(n=N71, curves=4, b1=300, b2=10000, sigma=110,
              stop_on_factor=False, verbose=0)

    def port(tag, **extra):
        (tmp_path / tag).mkdir()
        return driver.ECMDriver(driver.RunConfig(
            save_b1_path=str(tmp_path / tag / "save_b1.txt"),
            checkpoint_path=None, results_path=None, device="cpu",
            **kw, **extra)).run()

    res_inv = port("inv")
    res = port("noinv", cross="noinv")
    hits = {(h.factor, h.stage, h.sigma) for h in res.factors}
    assert (P35, 2, 112) in hits
    assert hits <= {(h.factor, h.stage, h.sigma) for h in res_inv.factors}
    assert res.counters["numinv"] == 0 < res_inv.counters["numinv"]
    assert res.counters["paired"] == res_inv.counters["paired"]


def test_noinv_refusals(tmp_path):
    """An unknown form, noinv on the RNS engine (tpu_ecm raises too) and
    noinv with an explicit replay mode (tpu_ecm ignores it; ROADMAP C.3)
    raise ValueError, in the runner and in the driver."""
    ctx = params.make_monty(N71)
    from tpu_ecm_torch.limbs import torch_ops
    tdc = torch_ops.device_ctx(ctx, "cpu")
    sp = t_plan.make_stage2_params(300, 10000)
    pt = torch.zeros((2, ctx.p.nw, 2), dtype=torch.int32)
    s = torch.zeros((ctx.p.nw, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="cross-product form"):
        t_exec.Stage2Runner(ctx, tdc, sp, pt, s, cross="projective")
    with pytest.raises(ValueError, match="replay"):
        t_exec.Stage2Runner(ctx, tdc, sp, pt, s, cross="noinv",
                            replay="stream")
    t_exec.Stage2Runner(ctx, tdc, sp, pt, s, cross="noinv")
    base = dict(n=N71, curves=1, b1=100, device="cpu", verbose=0,
                save_b1_path=None, checkpoint_path=None, results_path=None)
    for extra, what in ((dict(cross="noinv", engine="rns"), "digit"),
                        (dict(cross="noinv", replay="gather"), "replay"),
                        (dict(cross="none"), "cross-product form")):
        with pytest.raises(ValueError, match=what):
            driver.ECMDriver(driver.RunConfig(**base, **extra))
