"""The plain reference against the port on the CPU, on both engines, and
against corrupted answers."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ebhelp  # noqa: E402
from harness import window  # noqa: E402
from reference import ecm  # noqa: E402

N = ebhelp.N71
B1, B2 = 200, 4000


@pytest.fixture(scope="module", params=["digit", "rns"])
def batch(request, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp(request.param))
    drv = window.make_driver(N, B1, B2, "cpu", 1, request.param, tmp)
    sig = window.sigmas(ebhelp.SEED, 0, 3)
    res = drv.run_batch(sig, 0)
    return res, drv.stage2_values[0], drv.plans[0]


def test_reference_agrees(batch):
    res, accs, plan = batch
    assert ecm.plan_uncovered(plan, B1, B2) == 0
    for (sigma, x, z), acc in zip(res, accs):
        r = ecm.check_curve(N, sigma, B1, plan)
        assert r["x1"] == x * pow(z, -1, N) % N
        assert r["acc"] == acc


def test_reference_fails_corrupted(batch):
    res, accs, plan = batch
    sigma, x, z = res[0]
    r = ecm.check_curve(N, sigma, B1, plan)
    assert r["x1"] != (x + 1) * pow(z, -1, N) % N
    assert r["acc"] != (accs[0] + 1) % N
    for control in ("stage1", "stage2"):
        c = ecm.check_curve(N, sigma, B1, plan, control)
        assert c["acc"] != r["acc"]
    assert ecm.check_curve(N, sigma, B1, plan, "stage1")["x1"] != r["x1"]


def test_plan_that_drops_a_prime_is_uncovered(batch):
    _res, _accs, plan = batch
    v, u, amin0 = plan["chunks"][0]
    keep = ~((v == 0) & (u == 0))
    first = int(keep.argmax())
    cut = {**plan, "chunks": [(v[[i for i in range(v.size) if i != first]],
                               u[[i for i in range(u.size) if i != first]],
                               amin0)] + plan["chunks"][1:]}
    assert ecm.plan_uncovered(cut, B1, B2) > 0


def test_ladder_matches_repeated_adds():
    n = N
    x0, s = ecm.suyama(n, 1234567)
    X, Z = ecm.ladder(n, x0, s, 7)
    pts = ecm.chain(n, x0, (x0, 1), ecm._dbl(n, x0, 1, s), 7)
    assert X * pow(Z, -1, n) % n == ecm.affine(n, pts[-1:], "t")[0]
