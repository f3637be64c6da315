"""GMP-ECM-compatible savefiles and the factor results log.

Copy of tpu_ecm/io/savefile.py (the port imports nothing of tpu_ecm);
tests/test_torch_host.py holds the two equal.

Byte-format parity with the reference writers:
  savefile lines  (reference ecm.c:1294-1302, 1372-1380):
    METHOD=ECM; SIGMA=<u64>; B1=<u64>; N=0x<hex>; X=0x<hex>; Z=0x<hex>; PROGRAM=AVX-ECM;
  results log     (reference ecm.c:1266-1289):
    found <PRP|C><digits> factor <f> in stage <1|2> (B1|B2 = <b>): curve <i>, thread <t>, vec <v>, sigma <s>

These files are the ecosystem interop surface (`ecm -resume save_b1.txt`);
we also implement the *reader* (the reference never reads its own saves,
delegating resume to GMP-ECM — see SURVEY.md section 5).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterator, List, Optional, TextIO


@dataclasses.dataclass
class SaveRecord:
    sigma: int
    b1: int
    n: int
    x: int
    z: int
    program: str = "AVX-ECM"
    method: str = "ECM"
    param: int = 0     # GMP-ECM parameterization (0 = Suyama sigma)


def format_record(rec: SaveRecord) -> str:
    return (f"METHOD={rec.method}; SIGMA={rec.sigma}; B1={rec.b1}; "
            f"N=0x{rec.n:x}; X=0x{rec.x:x}; Z=0x{rec.z:x}; "
            f"PROGRAM={rec.program};\n")


def append_records(path: str, records: List[SaveRecord]) -> None:
    with open(path, "a") as f:
        for rec in records:
            f.write(format_record(rec))


_FIELD_RE = re.compile(r"\s*([A-Z0-9]+)=([^;]*);")


def parse_records(f: TextIO) -> Iterator[SaveRecord]:
    for line in f:
        line = line.strip()
        if not line:
            continue
        fields = dict((k, v.strip()) for k, v in _FIELD_RE.findall(line))
        if fields.get("METHOD") != "ECM":
            continue

        def num(s: str) -> int:
            return int(s, 16) if s.lower().startswith("0x") else int(s)

        # GMP-ECM compatibility: SIGMA may carry a "param:value" prefix
        # (newer parameterizations), PARAM may appear as its own field, and
        # records with only a normalized X imply Z = 1
        try:
            sig = fields["SIGMA"]
            param = int(fields.get("PARAM", "0"))
            if ":" in sig:
                param_s, sig = sig.split(":", 1)
                param = int(param_s)
            yield SaveRecord(sigma=int(sig), b1=int(fields["B1"]),
                             n=num(fields["N"]), x=num(fields["X"]),
                             z=num(fields.get("Z", "0x1")),
                             program=fields.get("PROGRAM", ""),
                             param=param)
        except (KeyError, ValueError) as exc:
            raise ValueError(
                f"malformed ECM savefile record ({exc!r}): {line[:120]}"
            ) from exc


def classify_factor(f: int) -> str:
    """PRP/C classification string like the reference's
    mpz_probab_prime_p(f,3) + digit count (reference ecm.c:1267-1275)."""
    return ("PRP" if _is_probable_prime(f) else "C") + str(len(str(f)))


def _is_probable_prime(n: int, rounds: int = 24) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    import random as _random
    rng = _random.Random(0xECC)
    for _ in range(rounds):
        a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def log_factor(path: Optional[str], factor: int, stage: int, bound: int,
               curve: int, shard: int, lane: int, sigma: int,
               echo: bool = True) -> str:
    ftype = classify_factor(factor)
    # stage 0 = gcd hit during curve construction; label with B1 like the
    # reference's stage-1 lines (reference ecm.c:1277-1283)
    bname = "B1" if stage <= 1 else "B2"
    msg = (f"\nfound {ftype} factor {factor} in stage {stage} "
           f"({bname} = {bound}): curve {curve}, thread {shard}, "
           f"vec {lane}, sigma {sigma}\n")
    if path:
        with open(path, "a") as f:
            f.write(msg)
    if echo:
        print(msg, end="")
    return msg
