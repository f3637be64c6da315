"""Digit arithmetic of the PyTorch port (tpu_ecm_torch.limbs.torch_ops) held
bit-identical to the JAX package's jnp_ops on the same inputs, made from a
seeded numpy generator, across the radix range."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpu_ecm import params  # noqa: E402
from tpu_ecm.limbs import jnp_ops, layout  # noqa: E402
from tpu_ecm_torch.limbs import torch_ops  # noqa: E402

from moduli import N416  # noqa: E402

torch.set_num_threads(1)

_jmul = jax.jit(jnp_ops.mulmod, static_argnames="pre")
_jsqr = jax.jit(jnp_ops.sqrmod, static_argnames="pre")

N64 = 2545580083 * 2551628647
N71 = 34359738421 * 68719476767

# (modulus, force_w, batch): w=13/nw=7 twice, the 416-bit flagship
# (w=12, nw=36) and a forced tiny radix; norm_inputs is on for all four
RADIX = [
    pytest.param(N64, None, 8, id="N64"),
    pytest.param(N71, None, 8, id="N71"),
    pytest.param(N416, None, 16, id="N416"),
    pytest.param(N64, 6, 8, id="N64-w6"),
]


def _ctxs(n, force_w):
    ctx = params.make_monty(n, force_w=force_w)
    return ctx, jnp_ops.device_ctx(ctx), torch_ops.device_ctx(ctx, "cpu")


def _rand_planes(rng, ctx, b, k=1):
    """k stacked [NW, B] planes of random values mod n (numpy-seeded)."""
    p = ctx.p
    nbytes = p.nbits // 8 + 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % ctx.n_int
            for _ in range(k * b)]
    return np.stack([layout.pack_batch(vals[i * b:(i + 1) * b], p.w, p.nw)
                     for i in range(k)])


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,force_w,b", RADIX)
@pytest.mark.parametrize("pre", [False, True])
def test_mulmod_sqrmod_bitexact(n, force_w, b, pre):
    ctx, jd, td = _ctxs(n, force_w)
    rng = np.random.default_rng(1)
    a, c = _rand_planes(rng, ctx, b, 2)
    # lazy (mulmod output) and negative-digit (difference) operands too
    lazy = np.array(_jmul(jnp.asarray(a), jnp.asarray(c), jd))
    for x, y in ((a, c), (lazy, c), (a - c, lazy)):
        _eq(torch_ops.mulmod(torch.from_numpy(x), torch.from_numpy(y), td,
                             pre=pre),
            _jmul(jnp.asarray(x), jnp.asarray(y), jd, pre=pre))
        _eq(torch_ops.sqrmod(torch.from_numpy(x), td, pre=pre),
            _jsqr(jnp.asarray(x), jd, pre=pre))


@pytest.mark.parametrize("n,force_w,b", RADIX)
def test_columns_redc_and_lazy_passes_bitexact(n, force_w, b):
    ctx, jd, td = _ctxs(n, force_w)
    rng = np.random.default_rng(2)
    a, c = _rand_planes(rng, ctx, b, 2)
    ta, tc = torch.from_numpy(a), torch.from_numpy(c)
    cols = torch_ops._product_columns(ta, tc)
    _eq(cols, jax.jit(jnp_ops._product_columns)(jnp.asarray(a),
                                                jnp.asarray(c)))
    _eq(torch_ops._square_columns(ta),
        jax.jit(jnp_ops._square_columns)(jnp.asarray(a)))
    _eq(torch_ops._redc(cols, td),
        jax.jit(jnp_ops._redc)(jnp.asarray(cols.numpy()), jd))
    # signed column sums through one pass and the two-pass normalize
    _eq(torch_ops._lazy_pass(cols - 3 * cols.flip(0), ctx.p.w),
        jnp_ops._lazy_pass(jnp.asarray((cols - 3 * cols.flip(0)).numpy()),
                           ctx.p.w))
    _eq(torch_ops.lazy_normalize(cols, ctx.p.w),
        jnp_ops.lazy_normalize(jnp.asarray(cols.numpy()), ctx.p.w))
    # stacked planes [K, NW, B] broadcast like a vmap
    stack = torch.from_numpy(_rand_planes(rng, ctx, b, 3))
    got = torch_ops.mulmod(stack, tc, td, pre=True)
    for k in range(3):
        _eq(got[k], _jmul(jnp.asarray(stack[k].numpy()), jnp.asarray(c),
                          jd, pre=True))


@pytest.mark.parametrize("n,force_w,b", RADIX)
def test_add_sub_variants_bitexact(n, force_w, b):
    ctx, jd, td = _ctxs(n, force_w)
    rng = np.random.default_rng(3)
    a, c = _rand_planes(rng, ctx, b, 2)
    ta, tc, ja, jc = (torch.from_numpy(a), torch.from_numpy(c),
                      jnp.asarray(a), jnp.asarray(c))
    _eq(torch_ops.addmod_n(ta, tc, td), jnp_ops.addmod_n(ja, jc, jd))
    _eq(torch_ops.submod_n(ta, tc, td), jnp_ops.submod_n(ja, jc, jd))
    for got, want in zip(torch_ops.addsubmod_n(ta, tc, td),
                         jnp_ops.addsubmod_n(ja, jc, jd)):
        _eq(got, want)
    for got, want in zip(torch_ops.addsubmod(ta, tc, td),
                         jnp_ops.addsubmod(ja, jc, jd)):
        _eq(got, want)
    _eq(torch_ops.addmod(ta, tc, td), jnp_ops.addmod(ja, jc, jd))
    _eq(torch_ops.submod(ta, tc, td), jnp_ops.submod(ja, jc, jd))


def test_fuzz_random_moduli_chain():
    """Seeded fuzz in the pattern of tests/test_limbs.py: random odd moduli
    of 64..1100 bits (every selected radix and both norm_inputs regimes),
    each driven through a random mul/sqr/addsub chain; the port's digits
    must equal jnp's at the end and its value the exact integer result."""
    rng = random.Random(0xECF)
    nrng = np.random.default_rng(0xECF)
    b = 8
    for _ in range(10):
        bits = rng.randrange(64, 1100)
        n = (rng.getrandbits(bits) | (1 << (bits - 1))) | 1
        ctx, jd, td = _ctxs(n, None)
        p = ctx.p
        xv = [int.from_bytes(nrng.bytes(bits // 8 + 8), "little") % n
              for _ in range(b)]
        yv = [int.from_bytes(nrng.bytes(bits // 8 + 8), "little") % n
              for _ in range(b)]
        prog = [rng.randrange(4) for _ in range(8)]

        def chain(ops, x, y, dctx):
            for op in prog:
                if op == 0:
                    x = ops.mulmod(x, y, dctx)
                elif op == 1:
                    y = ops.sqrmod(y, dctx)
                elif op == 2:
                    x, y = ops.addsubmod(x, y, dctx)
                else:
                    x = ops.submod(y, x, dctx)
            return ops.mulmod(x, y, dctx)

        x = layout.pack_batch([ctx.to_mont_int(v) for v in xv], p.w, p.nw)
        y = layout.pack_batch([ctx.to_mont_int(v) for v in yv], p.w, p.nw)
        got = chain(torch_ops, torch.from_numpy(x), torch.from_numpy(y), td)
        want = jax.jit(lambda x, y: chain(jnp_ops, x, y, jd))(
            jnp.asarray(x), jnp.asarray(y))
        _eq(got, want)
        vals = layout.unpack_batch(got.numpy(), p.w)
        for i in range(b):
            a, c2 = xv[i], yv[i]
            for op in prog:
                if op == 0:
                    a = a * c2 % n
                elif op == 1:
                    c2 = c2 * c2 % n
                elif op == 2:
                    a, c2 = (a + c2) % n, (a - c2) % n
                else:
                    a = (c2 - a) % n
            assert ctx.from_mont_int(vals[i] % n) == a * c2 % n, (bits, prog)


# special forms M = 2^e - c (the fold): Mersenne, a factor of 2^128+1
# (c = -1), the pseudo-Mersenne 2^255-19, and M1277 (w=11, nw=118);
# norm_inputs is on for M127, F7 and M1277, off for M61, the forced-radix
# M127 (w=10) and 2^255-19
FOLD = [
    pytest.param((1 << 61) - 1, (61, 1), None, 8, id="M61"),
    pytest.param((1 << 127) - 1, (127, 1), None, 8, id="M127"),
    pytest.param((1 << 127) - 1, (127, 1), 10, 8, id="M127-w10"),
    pytest.param(5704689200685129054721, (128, -1), None, 8, id="F7"),
    pytest.param((1 << 255) - 19, (255, 19), None, 8, id="p25519"),
    pytest.param((1 << 1277) - 1, (1277, 1), None, 8, id="M1277"),
]


def _fold_ctxs(n, mers, force_w):
    ctx = params.make_monty(n, mersenne=mers, force_w=force_w)
    assert ctx.is_mersenne
    return ctx, jnp_ops.device_ctx(ctx), torch_ops.device_ctx(ctx, "cpu")


@pytest.mark.parametrize("n,mers,force_w,b", FOLD)
def test_fold_mulmod_sqrmod_addsub_bitexact(n, mers, force_w, b):
    """The fold reduction of mulmod/sqrmod, and addsubmod_n, digit for
    digit against jnp_ops on reduced, lazy (mulmod output) and
    negative-digit operands, with and without the entry passes."""
    ctx, jd, td = _fold_ctxs(n, mers, force_w)
    rng = np.random.default_rng(4)
    a, c = _rand_planes(rng, ctx, b, 2)
    lazy = np.array(_jmul(jnp.asarray(a), jnp.asarray(c), jd))
    for x, y in ((a, c), (lazy, c), (a - c, lazy)):
        tx, ty, jx, jy = (torch.from_numpy(x), torch.from_numpy(y),
                          jnp.asarray(x), jnp.asarray(y))
        for pre in (False, True):
            _eq(torch_ops.mulmod(tx, ty, td, pre=pre),
                _jmul(jx, jy, jd, pre=pre))
            _eq(torch_ops.sqrmod(tx, td, pre=pre), _jsqr(jx, jd, pre=pre))
        for got, want in zip(torch_ops.addsubmod_n(tx, ty, td),
                             jnp_ops.addsubmod_n(jx, jy, jd)):
            _eq(got, want)
    # the value: a*c mod M
    got = layout.unpack_batch(torch_ops.mulmod(
        torch.from_numpy(a), torch.from_numpy(c), td).numpy(), ctx.p.w)
    av, cv = (layout.unpack_batch(x, ctx.p.w) for x in (a, c))
    m = ctx.n_int
    assert [g % m for g in got] == [x * y % m for x, y in zip(av, cv)]


def test_fold_random_forms_chain():
    """A few of the random special forms of tests/test_limbs.py:253-275
    (2^e - c with c = 1, -1 or an odd c < 2^20), each driven through a
    random mul/sqr/addsub chain: digits equal jnp's, values the exact
    integer result mod M."""
    rng = random.Random(0xF01D)
    nrng = np.random.default_rng(0xF01D)
    b = 8
    for c in (1, -1, rng.randrange(3, 1 << 20) | 1):
        e = rng.randrange(61, 700)
        m = (1 << e) - c
        ctx, jd, td = _fold_ctxs(m, (e, c), None)
        xv = [int.from_bytes(nrng.bytes(e // 8 + 8), "little") % m
              for _ in range(b)]
        yv = [int.from_bytes(nrng.bytes(e // 8 + 8), "little") % m
              for _ in range(b)]
        prog = [rng.randrange(4) for _ in range(8)]

        def chain(ops, x, y, dctx):
            for op in prog:
                if op == 0:
                    x = ops.mulmod(x, y, dctx)
                elif op == 1:
                    y = ops.sqrmod(y, dctx)
                elif op == 2:
                    x, y = ops.addsubmod(x, y, dctx)
                else:
                    x = ops.submod(y, x, dctx)
            return ops.mulmod(x, y, dctx)

        x = layout.pack_batch(xv, ctx.p.w, ctx.p.nw)
        y = layout.pack_batch(yv, ctx.p.w, ctx.p.nw)
        got = chain(torch_ops, torch.from_numpy(x), torch.from_numpy(y), td)
        _eq(got, jax.jit(lambda x, y: chain(jnp_ops, x, y, jd))(
            jnp.asarray(x), jnp.asarray(y)))
        vals = layout.unpack_batch(got.numpy(), ctx.p.w)
        for i in range(b):
            a, c2 = xv[i], yv[i]
            for op in prog:
                if op == 0:
                    a = a * c2 % m
                elif op == 1:
                    c2 = c2 * c2 % m
                elif op == 2:
                    a, c2 = (a + c2) % m, (a - c2) % m
                else:
                    a = (c2 - a) % m
            assert vals[i] % m == a * c2 % m, (e, c, prog)


def test_mersenne_context_raises():
    """A special-form context whose |c| has more digits than the fold's
    low part (k0 = e // w) cannot fold: the port raises instead of
    folding into the wrong rows (jnp_ops asserts the same bound)."""
    n = (1 << 60) - 1                       # = 2^61 - c with c = 2^60 + 1
    ctx = params.make_monty(n, mersenne=(61, (1 << 60) + 1))
    td = torch_ops.device_ctx(ctx, "cpu")
    assert td.c.shape[0] > 61 // ctx.p.w
    x = torch.zeros((ctx.p.nw, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="pseudo-Mersenne"):
        torch_ops.mulmod(x, x, td)
    with pytest.raises(ValueError, match="pseudo-Mersenne"):
        torch_ops.sqrmod(x, td)


def test_kernel_library_calls_hold_one_lock(monkeypatch):
    """A launch holds the kernel library's lock from the device switch to
    the launch (a launch allows its instantiation's shared memory and then
    launches; another thread between the two could change the allowance):
    from a second thread the lock cannot be taken during the call, and it
    is free again after it."""
    import contextlib
    import threading
    import types

    from tpu_ecm_torch.limbs import build, kernels

    taken_elsewhere = []

    def try_lock():
        got = kernels._LIBRARY_LOCK.acquire(blocking=False)
        if got:
            kernels._LIBRARY_LOCK.release()
        taken_elsewhere.append(got)

    class Lib:
        def tpuecm_set_device(self, device):
            return 0

        def tpuecm_tape(self, *args):
            t = threading.Thread(target=try_lock)
            t.start()
            t.join()
            return 0

    monkeypatch.setattr(build, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    before = kernels.launches["tape"]
    kernels._launch("tape", types.SimpleNamespace(device="cuda:0"),
                    "tpuecm_tape", 1, 2)
    kernels.launches["tape"] = before
    assert taken_elsewhere == [False]
    try_lock()
    assert taken_elsewhere == [False, True]
