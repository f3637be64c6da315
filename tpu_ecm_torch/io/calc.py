"""Integer expression calculator for CLI inputs.

Copy of tpu_ecm/io/calc.py (the port imports nothing of tpu_ecm);
tests/test_torch_host.py holds the two equal.

Covers the live surface of the reference's shunting-yard calculator
(calc.c, function table reference calc.c:1106-1117; many YAFU slots
there are dead "dummy" entries): operators + - * / ^ % ! # << >> with GMP
(here: Python int) semantics, functions fib, luc, gcd, jacobi, rand, randb,
lg2, log, ln, sqrt, modinv, modexp, nroot, shift, and the `ans` variable.

Implemented as a small Pratt parser on Python ints instead of a C
string-rewriting shunting yard.
"""

from __future__ import annotations

import math
import random
import re
from typing import Dict, List, Optional

_TOKEN_RE = re.compile(
    r"\s*(?:(\d+)|([A-Za-z_][A-Za-z_0-9]*)|(<<|>>|[-+*/%^!#(),]))")


class CalcError(ValueError):
    pass


def _fib(n: int) -> int:
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


def _luc(n: int) -> int:
    a, b = 2, 1
    for _ in range(n):
        a, b = b, a + b
    return a


def _primorial(n: int) -> int:
    out = 1
    for p in range(2, n + 1):
        if all(p % q for q in range(2, int(p ** 0.5) + 1)):
            out *= p
    return out


def _factorial(n: int) -> int:
    return math.factorial(n)


def _jacobi(a: int, n: int) -> int:
    if n <= 0 or n % 2 == 0:
        raise CalcError("jacobi: n must be positive odd")
    a %= n
    result = 1
    while a:
        while a % 2 == 0:
            a //= 2
            if n % 8 in (3, 5):
                result = -result
        a, n = n, a
        if a % 4 == 3 and n % 4 == 3:
            result = -result
        a %= n
    return result if n == 1 else 0


def _nroot(x: int, k: int) -> int:
    if x < 0:
        raise CalcError("nroot of negative")
    # exact integer Newton (float seeds overflow beyond ~2^1024)
    from ..params import iroot
    return iroot(x, k)


_FUNCS = {
    "fib": (1, lambda a: _fib(a[0])),
    "luc": (1, lambda a: _luc(a[0])),
    "gcd": (2, lambda a: math.gcd(a[0], a[1])),
    "jacobi": (2, lambda a: _jacobi(a[0], a[1])),
    "rand": (1, lambda a: random.randrange(0, max(1, a[0]))),
    "randb": (1, lambda a: random.getrandbits(a[0])),
    "lg2": (1, lambda a: a[0].bit_length() - 1),
    "log": (1, lambda a: int(math.log10(a[0]))),
    "ln": (1, lambda a: int(math.log(a[0]))),
    "sqrt": (1, lambda a: _nroot(a[0], 2)),
    "modinv": (2, lambda a: pow(a[0], -1, a[1])),
    "modexp": (3, lambda a: pow(a[0], a[1], a[2])),
    "nroot": (2, lambda a: _nroot(a[0], a[1])),
    "shift": (2, lambda a: a[0] << a[1] if a[1] >= 0 else a[0] >> -a[1]),
}


class _Parser:
    def __init__(self, tokens: List[str], variables: Dict[str, int]):
        self.toks = tokens
        self.pos = 0
        self.vars = variables

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise CalcError("unexpected end of expression")
        self.pos += 1
        return t

    def expect(self, t: str):
        got = self.next()
        if got != t:
            raise CalcError(f"expected {t!r}, got {got!r}")

    # precedence climbing:  << >>  <  + -  <  * / %  <  unary -  <  ^  <  ! #
    def parse(self, min_bp: int = 0) -> int:
        t = self.next()
        if t == "(":
            lhs = self.parse(0)
            self.expect(")")
        elif t == "-":
            lhs = -self.parse(50)
        elif t == "+":
            lhs = self.parse(50)
        elif t.isdigit():
            lhs = int(t)
        elif re.match(r"[A-Za-z_]", t):
            if self.peek() == "(":
                if t not in _FUNCS:
                    raise CalcError(f"unknown function {t!r}")
            if self.peek() == "(":
                nargs, fn = _FUNCS[t]
                self.next()
                args = [self.parse(0)]
                while self.peek() == ",":
                    self.next()
                    args.append(self.parse(0))
                self.expect(")")
                if len(args) != nargs:
                    raise CalcError(f"{t} wants {nargs} args")
                lhs = fn(args)
            elif t in self.vars:
                lhs = self.vars[t]
            else:
                raise CalcError(f"unknown symbol {t!r}")
        else:
            raise CalcError(f"unexpected token {t!r}")

        while True:
            op = self.peek()
            if op is None or op in (")", ","):
                break
            if op == "!":
                self.next()
                lhs = _factorial(lhs)
                continue
            if op == "#":
                self.next()
                lhs = _primorial(lhs)
                continue
            bp = {"<<": 10, ">>": 10, "+": 20, "-": 20,
                  "*": 30, "/": 30, "%": 30, "^": 60}.get(op)
            if bp is None:
                raise CalcError(f"unexpected token {op!r}")
            if bp < min_bp:
                break
            self.next()
            # ^ is right-associative
            rhs = self.parse(bp if op == "^" else bp + 1)
            if op == "+":
                lhs = lhs + rhs
            elif op == "-":
                lhs = lhs - rhs
            elif op == "*":
                lhs = lhs * rhs
            elif op == "/":
                if rhs == 0:
                    raise CalcError("division by zero")
                lhs = abs(lhs) // abs(rhs) * (1 if (lhs < 0) == (rhs < 0) else -1)
            elif op == "%":
                lhs = lhs % rhs
            elif op == "^":
                lhs = lhs ** rhs
            elif op == "<<":
                lhs = lhs << rhs
            elif op == ">>":
                lhs = lhs >> rhs
        return lhs


def calc(expr: str, variables: Optional[Dict[str, int]] = None) -> int:
    """Evaluate an integer expression (the calc() entry,
    reference calc.c:683)."""
    tokens = []
    pos = 0
    while pos < len(expr):
        m = _TOKEN_RE.match(expr, pos)
        if not m or m.end() == pos:
            if expr[pos:].strip() == "":
                break
            raise CalcError(f"bad token at {expr[pos:]!r}")
        tokens.append(m.group(1) or m.group(2) or m.group(3))
        pos = m.end()
    p = _Parser(tokens, variables or {})
    out = p.parse(0)
    if p.peek() is not None:
        raise CalcError(f"trailing input at {p.toks[p.pos:]}")
    return out


def eval_statement(line: str, variables: Dict[str, int]) -> int:
    """Evaluate one calculator statement with persistent state: handles the
    `name = expr` user-variable assignment form and updates `ans` (the
    reference's uvars surface, reference calc.c:273-302 via
    process_expression; `ans` is set after every evaluation)."""
    name = None
    if "=" in line:
        lhs, rhs = line.split("=", 1)
        lhs = lhs.strip()
        if lhs.isidentifier():
            name, line = lhs, rhs
        else:
            raise CalcError(f"bad assignment target {lhs!r}")
    val = calc(line, variables)
    variables["ans"] = val
    if name is not None:
        variables[name] = val
    return val


def repl(stdin=None, stdout=None) -> int:
    """Interactive calculator: one statement per line, persistent user
    variables and `ans`, `quit`/`exit` (or EOF) to leave."""
    import sys
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    variables: Dict[str, int] = {"ans": 0}
    for raw in stdin:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line in ("quit", "exit"):
            break
        try:
            print(eval_statement(line, variables), file=stdout)
        except (CalcError, OverflowError) as e:
            print(f"error: {e}", file=stdout)
    return 0
