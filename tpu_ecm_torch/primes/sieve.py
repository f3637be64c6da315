"""Host-side prime generation: segmented odd-only sieve on numpy.

Copy of tpu_ecm/primes/sieve.py (the port imports nothing of tpu_ecm);
tests/test_torch_host.py holds the two equal.

Replaces the reference's 6.4 kLoC threaded cache-blocked wheel sieve
(eratosthenes/, see SURVEY.md section 2.3) — on the TPU build primes are a
*host-side input tape*, so a vectorized numpy segmented sieve (optionally
the C++ native sieve in native/) is the right tool; the chunked
[rangemin, rangemax) protocol mirrors GetPRIMESRange / the global
PRIMES cache refresh loop (reference ecm.c:1135-1171).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

# same default chunk length as the reference (PRIME_RANGE,
# reference main.c:581)
PRIME_RANGE = 100_000_000

_native = None


def _get_native():
    global _native
    if _native is None:
        try:
            from ..native import lib as native_lib
            _native = native_lib if native_lib.available() else False
        except Exception:
            _native = False
    return _native


def small_primes(limit: int) -> np.ndarray:
    """Simple sieve for p < limit (tiny_soe analog,
    reference eratosthenes/tiny.c:17)."""
    if limit < 3:
        return np.array([2][: max(0, limit - 1)], dtype=np.uint64)
    sieve = np.ones(limit // 2, dtype=bool)   # odds: index i -> 2i+1
    sieve[0] = False                          # 1
    for i in range(1, (int(limit ** 0.5) + 1) // 2 + 1):
        if i < sieve.size and sieve[i]:
            p = 2 * i + 1
            start = (p * p) // 2
            if start < sieve.size:
                sieve[start::p] = False
    odds = 2 * np.nonzero(sieve)[0].astype(np.uint64) + 1
    return np.concatenate([[np.uint64(2)], odds])


def primes_range(lo: int, hi: int) -> np.ndarray:
    """All primes in [lo, hi) as uint64 (segmented, memory O(hi-lo))."""
    if hi <= 2 or hi <= lo:
        return np.zeros(0, dtype=np.uint64)
    nat = _get_native()
    if nat:
        return nat.primes_range(lo, hi)
    lo = max(lo, 2)
    root = int(hi ** 0.5) + 1
    base = small_primes(root + 1)
    out = []
    if lo <= 2 < hi:
        out.append(np.array([2], dtype=np.uint64))
    seg_len = 1 << 24
    start = max(lo, 3)
    if start % 2 == 0:
        start += 1
    for seg_lo in range(start, hi, 2 * seg_len):
        seg_hi = min(seg_lo + 2 * seg_len, hi)
        n_odds = (seg_hi - seg_lo + 1) // 2
        flags = np.ones(n_odds, dtype=bool)   # odd k = seg_lo + 2i
        for p in base[1:]:                    # odd base primes
            p = int(p)
            if p * p >= seg_hi:
                break
            first = max(p * p, ((seg_lo + p - 1) // p) * p)
            if first % 2 == 0:
                first += p
            if first >= seg_hi:
                continue
            flags[(first - seg_lo) // 2::p] = False
        vals = seg_lo + 2 * np.nonzero(flags)[0].astype(np.uint64)
        if vals.size:
            out.append(vals)
    if not out:
        return np.zeros(0, dtype=np.uint64)
    res = np.concatenate(out)
    return res[(res >= lo) & (res < hi)]


class PrimeStream:
    """Chunked prime cache over [0, limit): the global-PRIMES protocol of the
    reference driver, as an object."""

    def __init__(self, chunk: int = PRIME_RANGE):
        self.chunk = chunk
        self.rangemin = -1
        self.rangemax = -1
        self.primes = np.zeros(0, dtype=np.uint64)

    def load(self, lo: int, hi: int) -> np.ndarray:
        if lo != self.rangemin or hi != self.rangemax:
            self.primes = primes_range(lo, hi)
            self.rangemin, self.rangemax = lo, hi
        return self.primes

    def chunks(self, lo: int, hi: int) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield (chunk_lo, chunk_hi, primes) in PRIME_RANGE steps."""
        p = lo
        while p < hi:
            q = min(p + self.chunk, hi)
            yield p, q, self.load(p, q + 1000 if q == hi else q)
            p = q
