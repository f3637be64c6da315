"""Positional CLI of the port, argument-compatible with tpu_ecm/io/cli.py:

    python -m tpu_ecm_torch <input> <numcurves> <B1> [batch] [B2] [sigma]
    python -m tpu_ecm_torch -calc
    python -m tpu_ecm_torch -device cpu ...     (default: -device cuda)

<input> may be an integer expression (tpu_ecm.io.calc), e.g.
"fib(791)/13/677/216416017" or "2^127-1".
"""

from __future__ import annotations

import sys

from tpu_ecm.io import calc as _calc
from tpu_ecm.io.savefile import classify_factor

from .. import driver

USAGE = ("usage: python -m tpu_ecm_torch [-device cpu|cuda] "
         "$input $numcurves $B1 [$batch] [$B2] [$sigma]"
         "\n       python -m tpu_ecm_torch -calc   (interactive calculator)")

# flags of tpu_ecm's CLI that select parts not ported yet
NOT_PORTED = {"-edwards": "Edwards stage 1", "-rns": "RNS engine",
              "-resume": "the remaining surface (resume_stage2, -resume)"}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "-device" in argv:
        i = argv.index("-device")
        if i + 1 >= len(argv) or argv[i + 1] not in ("cpu", "cuda"):
            print(USAGE)
            return 1
        device = argv[i + 1]
        del argv[i:i + 2]
    if "-digit" in argv:            # the only engine of the port
        argv.remove("-digit")
    for flag, item in NOT_PORTED.items():
        if flag in argv:
            print(f"{flag} is not ported yet: ROADMAP.md, '{item}'")
            return 1
    if argv and argv[0] == "-calc":
        return _calc.repl()
    if len(argv) < 3:
        print(USAGE)
        return 1
    n = _calc.calc(argv[0])
    curves = int(argv[1])
    b1 = int(float(argv[2]))
    batch = int(argv[3]) if len(argv) >= 4 and int(argv[3]) > 0 else None
    b2 = int(float(argv[4])) if len(argv) >= 5 else None
    sigma = int(argv[5]) if len(argv) >= 6 else 0

    print(f"commencing parallel ecm on {n}")
    cfg = driver.RunConfig(n=n, curves=curves, b1=b1, b2=b2, sigma=sigma,
                           batch=batch, device=device)
    result = driver.ECMDriver(cfg).run()
    if result.factors:
        for h in result.factors:
            kind = "PRP" if h.is_prp else "C"
            print(f"final: {kind}{len(str(h.factor))} factor {h.factor} "
                  f"(stage {h.stage}, sigma {h.sigma})")
        # cofactor of the ORIGINAL input (result.n is the post-reduction
        # working modulus: powers of 2 stripped, perfect-power base)
        cof = n
        for f in {h.factor for h in result.factors}:
            while cof % f == 0:
                cof //= f
        if cof > 1:
            print(f"cofactor: {classify_factor(cof)} {cof}")
    print(f"ran {result.curves_run} curves; timings: "
          + ", ".join(f"{k}={v:.2f}s" for k, v in result.timings.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
