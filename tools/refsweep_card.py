#!/usr/bin/env python3
"""The acceptance sweep of the PyTorch/CUDA port: the 22 rows of the
reference's test.csh (tpu_ecm_torch/acceptance.py, the twin of
tests/test_acceptance.py) through tpu_ecm_torch at their full bounds, each
against its pinned (factor, stage, sigma).

    python3 tools/refsweep_card.py                   # every row, on the card
    python3 tools/refsweep_card.py --rows 4,3,7      # these rows
    python3 tools/refsweep_card.py --huge            # test.csh:34, 37-39
    python3 tools/refsweep_card.py --huge --rows 2,37  # from both sets
    # a row of one's own (row 0), small enough for the plain versions
    python3 tools/refsweep_card.py --device cpu \
        --job 2361183246142106764907 300 10000 111 68719476767 2

Each row runs 8 curves from its base sigma (the reference's own
`avx-ecm <expr> 8 <B1> 1 <B2> <sigma>`) with stop_on_factor off, on the
engine that engine="auto" picks, cheapest row first (acceptance.row_cost).
A row matches when a hit at the pinned sigma has the pinned factor, a
divisor or a multiple of it, and a hit there has the pinned stage
(acceptance.match_row).

--state PATH (default build/refsweep_card/state.json) keeps every row's
record (match, wall and phase seconds, counters, engine, radix and nw or
K, stage-2 chunks, D, U, Pb bytes, Pa group, free bytes, native planner,
hits, or the error and its traceback); a rerun skips the table rows that
matched (a --job row always runs).  --budget SECONDS stops before the next row once the seconds are
spent and names the rows not run.  Rows run one after another: at 8
curves a kernel fills one block of the card's 132 SMs, but rows run side
by side from threads on streams of their own ran slower a row and waited
on each other (PERF.md, the acceptance findings).

With --device cuda and no card it stops with an error; it never falls
back to the CPU.  If the native host library (tpu_ecm_torch/native, g++)
does not load, it says so and stops: the Python planners would take hours
at these bounds.  It prints a summary table and exits 1 on any mismatch
or error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from tpu_ecm_torch import acceptance  # noqa: E402

DEFAULT_STATE = os.path.join(HERE, "build", "refsweep_card", "state.json")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=None,
                    help="comma-separated test.csh rows (default: all)")
    ap.add_argument("--huge", action="store_true",
                    help="the huge-bound rows test.csh:34, 37-39: alone, "
                         "or beside the 22 for --rows to pick from")
    ap.add_argument("--job", nargs="+", default=None,
                    metavar="EXPR B1 B2 SIGMA [FACTOR STAGE]",
                    help="one row of one's own (row 0) instead")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--state", default=DEFAULT_STATE,
                    help="JSON file of row records; a rerun skips the "
                         "rows that matched")
    ap.add_argument("--budget", type=float, default=None,
                    help="seconds after which no further row starts")
    return ap.parse_args(argv)


def job_row(job) -> tuple:
    """--job's row: (0, EXPR, B1, B2, SIGMA, FACTOR or None, STAGE or
    None); the bounds and sigma may be written as 1e6."""
    if len(job) not in (4, 6):
        raise ValueError("--job takes EXPR B1 B2 SIGMA [FACTOR STAGE]")
    nums = [int(float(x)) if "e" in x.lower() else int(x) for x in job[1:4]]
    pinned = [int(x) for x in job[4:6]] or [None, None]
    return (0, job[0], *nums, *pinned)


def select_rows(table, spec):
    """The rows of `table` that `spec` ("4,3,7" or None: all) names,
    cheapest first; raises on a row the table does not hold."""
    by_num = {r[0]: r for r in table}
    if spec:
        nums = [int(x) for x in spec.split(",") if x.strip()]
        unknown = sorted(set(nums) - set(by_num))
        if unknown:
            raise ValueError(f"no such row(s): {unknown}; rows are "
                             f"{sorted(by_num)}")
        rows = [by_num[x] for x in dict.fromkeys(nums)]
    else:
        rows = list(table)
    return sorted(rows, key=acceptance.row_cost)


def load_state(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_state(path: str, state: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1)
    os.replace(tmp, path)


def run_one(row, device: str) -> dict:
    """The row's record, or on an exception its error and traceback."""
    t0 = time.time()
    try:
        return acceptance.run_row(row, device)
    except Exception as e:  # noqa: BLE001 -- recorded, the sweep goes on
        return dict(row=row[0], b1=row[2], b2=row[3], sigma=row[4],
                    expected=[row[5], row[6]], ok=False,
                    wall=time.time() - t0, error=repr(e),
                    traceback=traceback.format_exc())


def row_line(rec: dict) -> str:
    if "error" in rec:
        return (f"row{rec['row']}: ERROR after {rec['wall']:.2f} s: "
                f"{rec['error']}")
    t, s2 = rec["timings"], rec["stage2"] or {}
    geo = (f"K={rec['K']}" if rec["engine"] == "rns"
           else f"w={rec['radix']} nw={rec['nw']}")
    return (f"row{rec['row']}: {'OK' if rec['ok'] else 'MISMATCH'} "
            f"{rec['bits']} bits, engine {rec['engine']} ({geo}), "
            f"wall {rec['wall']:.2f} s: stage1 {t.get('stage1', 0):.2f}, "
            f"stage2_init {t.get('stage2_init', 0):.2f}, stage2 "
            f"{t.get('stage2', 0):.2f}, plan_wait "
            f"{t.get('stage2_plan_wait', 0):.2f} s; chunks "
            f"{s2.get('chunks', 0)}, D={s2.get('D')}, U={s2.get('U')}, "
            f"pa_group {s2.get('pa_group')}; hits {rec['hits']}")


def sweep(rows, *, device: str, state_path: str, budget=None,
          skip_matched: bool = True):
    """Run `rows` in order, skipping those the state file records as
    matched (unless not `skip_matched`), writing each record to the state
    file as it ends; no row starts once `budget` seconds have passed.
    Returns (state, the rows not run for the budget)."""
    state = load_state(state_path)
    t0 = time.time()
    not_run = []
    for row in rows:
        if skip_matched and state.get(str(row[0]), {}).get("ok"):
            print(f"row{row[0]}: matched in {state_path} (skip)", flush=True)
        elif budget is not None and time.time() - t0 >= budget:
            not_run.append(row[0])
        else:
            state[str(row[0])] = run_one(row, device)
            save_state(state_path, state)
            print(row_line(state[str(row[0])]), flush=True)
    if not_run:
        print(f"budget of {budget:g} s spent after {time.time() - t0:.2f} s; "
              f"rows not run: {not_run}")
    return state, not_run


def summary(rows, state) -> tuple:
    """The summary table's lines and the count of rows that ran and did
    not match (errors included)."""
    lines = [f"{'row':>4} {'result':>8} {'bits':>5} {'engine':>6} "
             f"{'nw/K':>5} {'B1':>10} {'B2':>12} {'chunks':>6} {'U':>3} "
             f"{'wall s':>9} {'stage1':>8} {'init':>7} {'stage2':>8} "
             f"{'wait':>6}"]
    fails = 0
    for row in rows:
        r = state.get(str(row[0]))
        if r is None:
            lines.append(f"{row[0]:>4} {'not run':>8} {'':>5} {'':>6} "
                         f"{'':>5} {row[2]:>10} {row[3]:>12}")
            continue
        if not r["ok"]:
            fails += 1
        if "error" in r:
            lines.append(f"{row[0]:>4} {'ERROR':>8} {'':>5} {'':>6} {'':>5} "
                         f"{row[2]:>10} {row[3]:>12} {'':>6} {'':>3} "
                         f"{r['wall']:>9.2f}")
            continue
        t, s2 = r["timings"], r["stage2"] or {}
        lines.append(
            f"{row[0]:>4} {'OK' if r['ok'] else 'MISMATCH':>8} "
            f"{r['bits']:>5} {r['engine']:>6} "
            f"{r['K'] if r['engine'] == 'rns' else r['nw']:>5} "
            f"{row[2]:>10} {row[3]:>12} {s2.get('chunks', 0):>6} "
            f"{s2.get('U', '-'):>3} {r['wall']:>9.2f} "
            f"{t.get('stage1', 0):>8.2f} {t.get('stage2_init', 0):>7.2f} "
            f"{t.get('stage2', 0):>8.2f} "
            f"{t.get('stage2_plan_wait', 0):>6.2f}")
    ran = sum(str(r[0]) in state for r in rows)
    lines.append(f"{ran - fails}/{len(rows)} rows matched, {fails} did not, "
                 f"{len(rows) - ran} not run")
    return lines, fails


def main(argv=None, table=None) -> int:
    args = parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("refsweep_card: --device cuda but torch.cuda.is_available() "
              "is False; no sweep on the CPU unless --device cpu is given",
              file=sys.stderr)
        return 2
    from tpu_ecm_torch.native import lib as native
    if not native.available():
        print(f"refsweep_card: the native host library did not load "
              f"({native.library_path()}: g++ build of "
              f"tpu_ecm_torch/native); the Python planners would take "
              f"hours at these bounds, stopping", flush=True)
        return 2
    if table is None:
        table = ([job_row(args.job)] if args.job
                 else acceptance.REFSWEEP_ROWS + acceptance.HUGE_ROWS
                 if args.huge and args.rows
                 else acceptance.HUGE_ROWS if args.huge
                 else acceptance.REFSWEEP_ROWS)
    rows = select_rows(table, args.rows)
    if args.device == "cuda":
        from tpu_ecm_torch.limbs import build
        build.library()      # nvcc before the first row's clock starts
        print(f"refsweep_card: {torch.cuda.get_device_name(0)}, "
              f"{len(rows)} rows", flush=True)
    # a --job row is no table row: its match is not one to remember
    state, _not_run = sweep(rows, device=args.device, state_path=args.state,
                            budget=args.budget, skip_matched=not args.job)
    lines, fails = summary(rows, state)
    print("\n".join(lines))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
