"""Host-side packing between Python ints and [NW, B] int32 digit planes.

Copy of tpu_ecm/limbs/layout.py (the port imports nothing of tpu_ecm);
tests/test_torch_curve.py keeps the two equal.

The reference marshals GMP values lane-by-lane into interleaved AVX-512
vectors (insert_mpz_to_vec / extract_bignum_from_vec_to_mpz,
reference main.c:63-138).  Here the batch axis B is the trailing
(128-lane) axis of a [NW, B] int32 tensor: digit j of every curve is one
contiguous vector register row — the same "limb plane" idea, sized for the
TPU VPU instead of zmm registers.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np


def int_to_digits(x: int, w: int, nw: int) -> np.ndarray:
    """Non-negative int -> [nw] int32 digit vector, little-endian base 2**w."""
    if x < 0:
        raise ValueError("int_to_digits wants x >= 0")
    mask = (1 << w) - 1
    out = np.zeros(nw, dtype=np.int32)
    for j in range(nw):
        out[j] = x & mask
        x >>= w
    if x != 0:
        raise ValueError("value does not fit in nw digits")
    return out


def digits_to_int(d: Sequence[int], w: int) -> int:
    """[nw] (possibly signed, redundant) digits -> exact int value."""
    x = 0
    for j in range(len(d) - 1, -1, -1):
        x = (x << w) + int(d[j])
    return x


def pack_batch(values: Iterable[int], w: int, nw: int) -> np.ndarray:
    """List of B ints -> [nw, B] int32."""
    cols = [int_to_digits(v, w, nw) for v in values]
    return np.stack(cols, axis=-1).astype(np.int32)


def unpack_batch(planes: np.ndarray, w: int) -> List[int]:
    """[nw, B] digit planes (signed/redundant ok) -> list of B exact ints."""
    planes = np.asarray(planes)
    nw, b = planes.shape
    return [digits_to_int(planes[:, i], w) for i in range(b)]


def broadcast_int(x: int, w: int, nw: int, b: int) -> np.ndarray:
    """One int -> [nw, B] planes, all lanes equal (broadcast_mpz_to_vec
    analog, reference main.c:91-115)."""
    return np.repeat(int_to_digits(x, w, nw)[:, None], b, axis=1)
