"""Run one cell of the benchmark of tpu_ecm_torch once.

    python3 ecmbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  The last line on standard output is the result's JSON object: the
cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1, `correct` from the plain reference, and the numbers compared
(under "checks", last), which also end standard error.  Exits 1 without a
result where CUDA or the cards are missing, and where the JAX package or
JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc and g++ builds go to build/tpu_ecm_torch)."""
    base = os.path.join(ROOT, "build", "ecmbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path[:0] = [BENCH_DIR, ROOT]
    from harness import runner, spec
    cell = spec.find_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("ecmbench: torch.cuda.is_available() is False; the benchmark "
              "measures the port on NVIDIA GPUs", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"ecmbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     T_START)
    jax = runner.jax_modules()
    if jax:
        print(f"ecmbench: modules of JAX or the JAX package were loaded: "
              f"{jax}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
