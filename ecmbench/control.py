"""The control of `correct`: the plain reference with one guarantee of the
configuration broken, put in the program's place, has to come out not
correct, where the program's own answers come out correct.

    python3 ecmbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds S]

For each seed it runs the cell's set-up and a short window at the cell's
own size on the card, then judges the sampled curves three times: the
program's answers ("sound"), the reference without the largest prime
below B1 in stage 1 ("stage1"), and the reference without one entry of
the stage-2 plan ("stage2").  One line of JSON a seed; the benchmark's
own runs never run it.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    from harness import judge, runner, spec
    cell = spec.find_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        state = runner.measure(cell, seed, args.seconds, False,
                               time.perf_counter(), device=args.device)
        line = {"workload": args.workload, "seed": seed,
                "batches": len(state["win"].batches)}
        got = runner.check(state, cell, ("", "stage1", "stage2"))
        for kind, (numbers, wrong, checked) in got.items():
            line[kind or "sound"] = {"numbers": numbers, "wrong": wrong,
                                     "checked": checked,
                                     "correct": judge.correct(numbers)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
