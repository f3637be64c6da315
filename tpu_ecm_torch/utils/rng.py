"""Deterministic RNG helpers matching the reference's sigma generation.

Copy of tpu_ecm/utils/rng.py (the port imports nothing of tpu_ecm);
tests/test_torch_host.py holds the two equal.

lcg_rand is Knuth's MMIX LCG (reference main.c:993-998); hash64 is the
byte-sliced FNV-1 variant used to seed per-thread states
(reference main.c:1013-1061).
"""

from __future__ import annotations

_M64 = (1 << 64) - 1


def lcg_rand(state: int) -> int:
    """One MMIX LCG step; returns the new state (also the random value)."""
    return (6364136223846793005 * state + 1442695040888963407) & _M64


def hash64(x: int) -> int:
    """FNV-1-style 64-bit hash, splicing one XORed byte window per round."""
    h = 14695981039346656037 & _M64
    prime = 1099511628211
    for k in range(8):
        h = (h * prime) & _M64
        window = (0xFF << (8 * k)) & _M64     # byte k takes the XOR
        h = (h & ~window & _M64) | ((h ^ x) & window)
    return h


class SigmaGen:
    """Per-shard sigma source: fixed base sigma + offset, or the LCG stream
    (sigma >= 6 constraint as reference ecm.c:1564-1570)."""

    def __init__(self, base_sigma: int, seed: int):
        self.base = base_sigma
        self.state = seed
        self.counter = 0

    def next(self) -> int:
        if self.base > 0:
            s = self.base + self.counter
            self.counter += 1
            return s
        while True:
            self.state = lcg_rand(self.state)
            if self.state >= 6:
                return self.state
