"""The port's acceptance layer (tpu_ecm_torch/acceptance.py and
tools/refsweep_card.py), the twin of tests/test_acceptance.py and
tools/hw_refsweep.py: the 22 test.csh rows and the huge-bound rows equal
the JAX package's copies, every input parses to the same integer through
both calculators, match_row keeps tests/test_acceptance.py's rule, the
tool's row runner on the CPU finds what tpu_ecm finds on a row-shaped
N71 job whose stage 2 walks three prime chunks (the last of nine primes),
and its state file, --rows, --budget and --job select, skip and stop as
the tool says.  Row 9 on the card: marker cuda."""

import importlib.util
import json
import os

import pytest

torch = pytest.importorskip("torch")

from tpu_ecm_torch import acceptance  # noqa: E402
from tpu_ecm_torch.io import calc  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P35, P36 = 34359738421, 68719476767
N71 = P35 * P36
ROWS = {r[0]: r for r in acceptance.REFSWEEP_ROWS}
IDS = [f"row{r}" for r in ROWS]
# a row-shaped job small enough for the plain versions: N71, 8 curves from
# sigma 110 (111 finds P36 and 112 P35, both in stage 2)
N71_ROW = (71, str(N71), 300, 10_000, 110, None, None)
# stage 2 over (300, 10000] in chunks of 4800: (300, 5100], (5100, 9900]
# and (9900, 10000], whose nine primes are 9901 ... 9973
CHUNK = 4800


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


refsweep_card = _tool("refsweep_card")


def _hits(res):
    return {(h.factor, h.stage, h.sigma) for h in res.factors}


def _jax_run(tmp_path, row, **kw):
    """tpu_ecm's driver on the CPU on a row's tuple, 8 curves."""
    pytest.importorskip("jax")
    from tpu_ecm import driver as j_driver
    num, expr, b1, b2, sigma, _f, _s = row
    return j_driver.ECMDriver(j_driver.RunConfig(
        n=int(expr), curves=8, b1=b1, b2=b2, sigma=sigma,
        stop_on_factor=False, verbose=0,
        save_b1_path=str(tmp_path / "save_b1.txt"),
        checkpoint_path=str(tmp_path / "checkpoint.txt"),
        results_path=str(tmp_path / "ecm_results.txt"),
        cache_dir=str(tmp_path / "cache"), **kw)).run()


@pytest.mark.parametrize("index", range(len(acceptance.REFSWEEP_ROWS)),
                         ids=IDS)
def test_table_equals_tpu_ecm(index):
    """The port's copy of each row equals tests/test_acceptance.py's."""
    pytest.importorskip("jax")
    import test_acceptance
    assert len(acceptance.REFSWEEP_ROWS) == len(
        test_acceptance.REFSWEEP_ROWS) == 22
    assert (acceptance.REFSWEEP_ROWS[index]
            == test_acceptance.REFSWEEP_ROWS[index])


@pytest.mark.parametrize("row", list(ROWS), ids=IDS)
def test_fixture_integrity(row):
    """Each input parses through the port's calculator to the integer
    tpu_ecm's gives, and the pinned factor divides it."""
    pytest.importorskip("jax")
    from tpu_ecm.io import calc as j_calc
    _num, expr, _b1, _b2, _sigma, factor, _stage = ROWS[row]
    n = calc.calc(expr)
    assert n == j_calc.calc(expr)
    assert n % factor == 0 and 1 < factor < n


def test_huge_rows_equal_hw_huge_bounds():
    """--huge's rows are tools/hw_huge_bounds.py's test.csh:34 and
    test.csh:37-39 tuples, with no pinned factor or stage."""
    huge = _tool("hw_huge_bounds")
    got = {r[0]: r for r in acceptance.HUGE_ROWS}
    assert sorted(got) == [34, 37, 38, 39]
    assert all(r[5] is None and r[6] is None for r in got.values())
    _num, expr, b1, b2, sigma, _f, _s = got[34]
    assert (calc.calc(expr), b1, b2, sigma) == (
        huge.N_HUGE_B1, 110_000_000, 13_400_000_000, huge.SIGMA_HUGE_B1)
    for name, tup in huge.HUGE_B2_ROWS.items():
        _num, expr, b1, b2, sigma, _f, _s = got[int(name[3:])]
        assert (calc.calc(expr), b1, b2, sigma) == tup


@pytest.mark.parametrize("row", [13, 17])
def test_match_row_composite_rows(row):
    """The reference's C69 (row 13) and C64 (row 17): the composite
    itself, a divisor of it or a multiple of it at the pinned sigma and
    stage match; a hit at another sigma, at the wrong stage, or of a
    factor that neither divides nor is divided by the pinned one does
    not."""
    _num, expr, _b1, _b2, sigma, factor, stage = ROWS[row]
    n = calc.calc(expr)
    cof = n // factor
    match = acceptance.match_row
    assert match([(factor, stage, sigma)], factor, stage, sigma)
    # a curve that meets the two primes one by one reports each: a divisor
    # of the composite (its cofactor's factor taken off is one such)
    assert match([(factor * cof, stage, sigma)], factor, stage, sigma)
    assert match([(7, 1, sigma + 1), (factor, stage, sigma)], factor, stage,
                 sigma)
    assert not match([(factor, stage, sigma + 1)], factor, stage, sigma)
    assert not match([(factor, 1, sigma)], factor, stage, sigma)
    assert not match([(factor + 2, stage, sigma)], factor, stage, sigma)
    # the factor at the pinned sigma and the stage only on another hit
    # there: tests/test_acceptance.py takes the two apart too
    assert match([(factor, 1, sigma), (cof, stage, sigma)], factor, stage,
                 sigma)
    assert not match([], factor, stage, sigma)


def test_match_row_unpinned_rows():
    """A huge-bound row (no pinned factor) matches on any hit at its
    sigma."""
    assert acceptance.match_row([(P35, 2, 9)], None, None, 9)
    assert not acceptance.match_row([(P35, 2, 10)], None, None, 9)


def test_row_cost_orders_cheapest_first():
    """The tool's order: hw_refsweep's row_cost, rows 9, 25, 19 first and
    17 last."""
    hw = _tool("hw_refsweep")
    rows = refsweep_card.select_rows(acceptance.REFSWEEP_ROWS, None)
    assert [acceptance.row_cost(r) for r in rows] == sorted(
        hw.row_cost(r) for r in acceptance.REFSWEEP_ROWS)
    assert [r[0] for r in rows][:3] == [9, 25, 19]
    assert rows[-1][0] == 17


@pytest.fixture(scope="module")
def n71_three_chunks(tmp_path_factory):
    """N71_ROW with stage 2 over three prime chunks, through the tool's
    row runner on the CPU (the plain versions) and through tpu_ecm's
    driver: one run each for the two N71 tests.  tpu_ecm's compilation
    and the port's plain versions are most of this file's time, so the
    reference runs on a thread beside the port (XLA compiles without
    the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=1) as pool:
        want = pool.submit(_jax_run, tmp_path_factory.mktemp("jax3"),
                           N71_ROW, prime_chunk=CHUNK)
        rec = acceptance.run_row(N71_ROW, "cpu", prime_chunk=CHUNK)
        return rec, want.result()


def test_cpu_row_equals_tpu_ecm(n71_three_chunks):
    """The tool's row runner on the CPU finds on N71 the (factor, stage,
    sigma) set tpu_ecm's driver finds; its record carries the engine,
    geometry, native planner, stage-2 plan and phase seconds, and does
    not match (no hit at the base sigma 110)."""
    rec, want = n71_three_chunks
    assert {tuple(h) for h in rec["hits"]} == _hits(want)
    assert _hits(want) == {(P36, 2, 111), (P35, 2, 112)}
    assert rec["ok"] is False and rec["native"] is True
    assert (rec["engine"], rec["bits"], rec["radix"], rec["nw"], rec["K"],
            rec["curves_run"]) == ("digit", 72, 13, 7, None, 8)
    assert (rec["stage2"]["D"], rec["stage2"]["pa_group"]) == (210, 512)
    assert {"stage1", "stage2_init", "stage2", "stage2_plan_wait"} \
        <= set(rec["timings"])


def test_stage2_over_three_chunks_equals_tpu_ecm(n71_three_chunks):
    """B2 above one prime chunk on the CPU: stage 2 walks three chunks,
    the last of nine primes; the finds and counters equal tpu_ecm's run
    with the same prime_chunk."""
    rec, want = n71_three_chunks
    assert rec["stage2"]["chunks"] == 3
    assert {tuple(h) for h in rec["hits"]} == _hits(want)
    assert rec["counters"] == want.counters
    from tpu_ecm_torch.primes import sieve
    assert len(sieve.primes_range(9900 + 1, 10_000 + 1)) == 9


def test_state_rows_and_budget(tmp_path, capsys):
    """--rows picks rows and the budget stops before the next one; a
    matched row in the state file is skipped on a rerun (its record kept);
    an error is recorded with its traceback and the exit code is 1."""
    table = [(1, str(N71), 300, 300, 174, P35, 1),      # matches
             (2, str(N71), 300, 20_000, 110, P36, 2),   # dearer: after 1
             (3, str(N71), 300, 300, 110, P35, 1),      # never selected
             (4, "1+", 300, 300, 110, P35, 1)]          # does not parse
    state = str(tmp_path / "state.json")
    argv = ["--device", "cpu", "--state", state]
    assert refsweep_card.main(argv + ["--rows", "2,1", "--budget", "0.001"],
                              table=table) == 0
    out = capsys.readouterr().out
    rec = json.load(open(state))
    assert set(rec) == {"1"} and rec["1"]["ok"]
    assert [P35, 1, 174] in rec["1"]["hits"]
    assert "rows not run: [2]" in out and "1/2 rows matched" in out

    assert refsweep_card.main(argv + ["--rows", "1"], table=table) == 0
    assert "row1: matched in" in capsys.readouterr().out
    assert json.load(open(state))["1"] == rec["1"]

    assert refsweep_card.main(argv + ["--rows", "4,1"], table=table) == 1
    out = capsys.readouterr().out
    rec = json.load(open(state))
    assert set(rec) == {"1", "4"} and not rec["4"]["ok"]
    assert "CalcError" in rec["4"]["error"] and rec["4"]["traceback"]
    assert "row4: ERROR" in out and "1/2 rows matched, 1 did not" in out
    with pytest.raises(ValueError, match="no such row"):
        refsweep_card.main(argv + ["--rows", "5"], table=table)


def test_cuda_without_a_card_stops(tmp_path, capsys, monkeypatch):
    """--device cuda with no card stops with an error and runs nothing on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = tmp_path / "state.json"
    assert refsweep_card.main(["--rows", "9", "--state", str(state)]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not state.exists()


def test_job_row():
    """--job EXPR B1 B2 SIGMA [FACTOR STAGE] is row 0 of one's own."""
    assert refsweep_card.job_row(
        [str(N71), "300", "1e4", "111", str(P36), "2"]) == (
        0, str(N71), 300, 10_000, 111, P36, 2)
    assert refsweep_card.job_row([str(N71), "300", "10000", "111"])[5:] \
        == (None, None)
    with pytest.raises(ValueError, match="--job takes"):
        refsweep_card.job_row([str(N71), "300"])


def test_job_row_always_runs(tmp_path, capsys):
    """A --job row is no table row: a rerun runs it again even where the
    state file records it as matched."""
    state = tmp_path / "state.json"
    state.write_text(json.dumps({"0": {"ok": True, "wall": -1.0}}))
    assert refsweep_card.main(
        ["--device", "cpu", "--state", str(state),
         "--job", str(N71), "300", "300", "174", str(P35), "1"]) == 0
    out = capsys.readouterr().out
    assert "row0: OK" in out and "matched in" not in out
    rec = json.load(open(state))["0"]
    assert rec["ok"] and rec["wall"] > 0 and [P35, 1, 174] in rec["hits"]


@pytest.mark.cuda
def test_row9_on_card():
    """Row 9, the cheapest row (412 bits, B1 = B2 = 1e6: the stage-1
    find), through the tool's row runner on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    rec = refsweep_card.run_one(ROWS[9], "cuda")
    assert "error" not in rec, rec.get("traceback")
    assert rec["ok"], rec["hits"]
    assert (rec["engine"], rec["nw"], rec["stage2"]) == ("digit", 36, None)
