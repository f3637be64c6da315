"""The frozen work counts of kernels/ equal chip_smoke.py's, from which
they were copied: _product_macs, _tape_products and _rns_bound."""

import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ebhelp  # noqa: E402
from harness import spec  # noqa: E402

sys.path.insert(0, ebhelp.ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("nw,w,mersenne", [(36, 12, None), (118, 11,
                                                            (1277, 1))])
def test_digit_macs(nw, w, mersenne):
    K1 = spec.kernel_count("K1")
    ctx = types.SimpleNamespace(
        p=types.SimpleNamespace(nw=nw, w=w), is_mersenne=mersenne is not None,
        mersenne_e=mersenne and mersenne[0], mersenne_c=mersenne and
        mersenne[1])
    for sqr in (False, True):
        assert (K1.product_macs(nw, sqr, mersenne, w)
                == chip_smoke._product_macs(ctx, sqr))


def test_tape_products():
    import numpy as np
    K1 = spec.kernel_count("K1")
    tape = np.array([[0, 1, 0, 0, 0]] * 5 + [[1, 2, 1, 0, 0]] * 3
                    + [[2, 0, 0, 0, 0]] * 2, dtype=np.int32)
    assert K1.tape_products(5, 3) == chip_smoke._tape_products(tape)


@pytest.mark.parametrize("K", [96, 200])
def test_rns_products(K):
    K10 = spec.kernel_count("K10")
    rc = types.SimpleNamespace(K=K)
    products = 1_000_000
    ms, _by, _old = chip_smoke._rns_bound(rc, products, 0)
    assert K10.products_s(K, products) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_bounds_of_a_window():
    """A window's bound from its work: K1 and K5 at nw = 36, K10 and K15
    at K = 96, the operations bounding each."""
    view = types.SimpleNamespace(
        nw=36, w=12, mersenne=None, K=96, batch=6336, devices=1,
        curves_per_device=6336, stage1_dups=150_000, stage1_adds=68_717,
        paired=400_000, launches={"tape": 4, "replay": 8, "rns_tape": 7,
                                  "rns_replay": 8})
    K1 = spec.kernel_count("K1")
    macs = 6336 * (
        (3 * 150_000 + 4 * 68_717) * K1.product_macs(36, False)
        + 2 * 218_717 * K1.product_macs(36, True))
    assert K1.bound_s(view) == pytest.approx(macs / (132 * 64 * 1.98e9))
    K5 = spec.kernel_count("K5")
    assert K5.bound_s(view) == pytest.approx(
        6336 * 400_000 * K1.product_macs(36, False) / (132 * 64 * 1.98e9))
    for k in ("K10", "K15"):
        assert spec.kernel_count(k).bound_s(view) > 0
