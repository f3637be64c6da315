"""Stage-2 planning on the host: parameters, residue maps, and the PAIR
algorithm producing the (v, u) pairmap replayed on device.

Copy of tpu_ecm/stage2/plan.py without its environment overrides;
tests/test_torch_curve.py keeps Stage2Params and the pairmaps equal.  U still
comes from the TPU cost model (params.choose_stage2_U_tpu).

This is a faithful re-derivation of the subtlest serial algorithm in the
reference — pair() (reference ecm.c:2559-2910) — plus the residue
bookkeeping built in ecm_work_init (reference ecm.c:301-329) and
thread_init (reference main.c:717-748):

* D (called w): giant-step spacing, from B1 (params.choose_stage2_D);
* U: window multiplier, L = 2U; the device keeps 2L giant-step points
  Pa[i] = [(2*amin + i) * w]Q;
* rprime_map: j in [0, U*D] -> storage index for the baby-step table Pb
  (only j with gcd(j, D) == 1, plus 1, 2, D are stored);
* pair(): for each prime s in (B1, B2], with a = (s+w)//(2w) and
  q = s - 2aw, try to pair s with a queued prime sharing the residue
  +-q mod 2w: paired primes (a+ap)w +- u cost ONE multiply for two primes.
  Unpaired primes wait in per-residue FIFO queues; when the window advances
  ((0,0) sentinel in the map), stale queue entries are flushed as singletons
  2*ap*w +- u.  The executor consumes v-offsets relative to a running amin
  that advances by U per sentinel (L - U == U since L == 2U).

The pairmap depends only on (prime chunk, B1, B2, D, U) — not on N or the
curves — so it is planned once on the host (numpy/deque) and broadcast.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import params as _params


@dataclasses.dataclass(frozen=True)
class Stage2Params:
    D: int                      # giant-step spacing w
    U: int                      # window multiplier
    L: int                      # = 2U
    R: int                      # number of coprime residue queues = phi(2D)
    umax: int                   # U * D
    amin0: int                  # initial window index (B1 + D) // (2D)
    rprime_map: np.ndarray      # [U*D + 4] uint32 storage map
    num_pb: int                 # number of stored baby-step points
    qmap: Dict[int, int]        # residue mod 2D -> queue index
    qrmap: Dict[int, int]       # queue index -> residue


def rprime_map_build(U: int, D: int) -> Tuple[np.ndarray, int]:
    """Baby-step storage map (re-derivation of
    reference ecm.c:301-329): indices 1, 2, D and every j in [3, U*D]
    with gcd(j mod D..., D) == 1 get consecutive storage slots."""
    m = np.zeros(U * (D + 1) + 3, dtype=np.uint32)
    m[0], m[1], m[2] = 0, 1, 2
    nxt = 3
    for i in range(U):
        j = 3 if i == 0 else 1
        while j < D:
            if math.gcd(j, D) == 1:
                m[i * D + j] = nxt
                nxt += 1
            j += 1
        if i == 0:
            m[D] = nxt        # j == D slot (the reference stores [D]Q here)
            nxt += 1
    return m, nxt


def make_stage2_params(b1: int, b2: int, D: Optional[int] = None,
                       U: Optional[int] = None, nw: Optional[int] = None,
                       batch: Optional[int] = None) -> Stage2Params:
    """D/U default to the TPU cost-model choice (params.choose_stage2_U_tpu
    — B2-dependent, capped when nw/batch are known); explicit arguments
    override (any coprime-structured D with U >= 2 is valid — the pairmap
    coverage audit is D/U-generic)."""
    if D is None:
        D = _params.choose_stage2_D(b1)
    if U is None:
        U = _params.choose_stage2_U_tpu(b1, b2, D, nw=nw, batch=batch)
    L = 2 * U
    qmap: Dict[int, int] = {}
    qrmap: Dict[int, int] = {}
    j = 0
    for k in range(2 * D):
        if math.gcd(k, 2 * D) == 1:
            qmap[k] = j
            qrmap[j] = k
            j += 1
    rmap, num_pb = rprime_map_build(U, D)
    return Stage2Params(D=D, U=U, L=L, R=j, umax=U * D,
                        amin0=(b1 + D) // (2 * D), rprime_map=rmap,
                        num_pb=num_pb, qmap=qmap, qrmap=qrmap)


def pair(sp: Stage2Params, primes: Sequence[int], b1: int, b2: int,
         verbose: bool = False, allow_native: bool = True
         ) -> Tuple[np.ndarray, np.ndarray, int, dict]:
    """Montgomery PAIR: primes in [b1, b2) -> (pairmap_v, pairmap_u, amin0, stats).

    Returns uint32 arrays; entry (0,0) is the window-shift sentinel.  amin
    for the executor starts at (b1 + w) // (2w) (the b1 here is the *chunk*
    start, matching the per-chunk call at reference ecm.c:1449-1451).
    Dispatches to the C++ planner (native/planner.cpp) when available.
    """
    if allow_native and not verbose:
        try:
            from ..native import lib as _native
        except Exception:
            _native = None
        if _native is not None and _native.available():
            parr = np.asarray(primes, np.uint64)
            v, u, amin0 = _native.pair(parr, b1, b2, sp.D, sp.U)
            sent = int(np.sum((v == 0) & (u == 0)))
            nump = int(np.searchsorted(parr, b2) - np.searchsorted(parr, b1))
            pairs = len(v) - sent
            stats = dict(pairs=pairs, primes=nump,
                         ratio=(pairs / nump if nump else 0.0))
            return v, u, amin0, stats
    w, U, L, umax = sp.D, sp.U, sp.L, sp.umax
    amin = amin_entry = (b1 + w) // (2 * w)
    queues: List[deque] = [deque() for _ in range(sp.R)]
    map_v: List[int] = []
    map_u: List[int] = []
    pairs = 0
    nump = 0

    def flush_stale(oldmin: int, new_amin: int):
        nonlocal pairs
        for qi in range(sp.R):
            r = sp.qrmap[qi]
            q = 2 * w - r if r > w else r
            keep = deque()
            while queues[qi]:
                ap = queues[qi].popleft()
                if ap < new_amin:
                    map_v.append(2 * ap - oldmin)
                    map_u.append(q)
                    pairs += 1
                else:
                    keep.append(ap)
            queues[qi] = keep

    for s in primes:
        s = int(s)
        if s < b1:
            continue
        if s >= b2:
            break
        a = (s + w) // (2 * w)
        nump += 1

        while a >= amin + L:
            oldmin = amin
            amin = amin + L - U
            flush_stale(oldmin, amin)
            map_v.append(0)
            map_u.append(0)

        q = s - 2 * a * w                      # in (-w, w]
        mq = -q if q < 0 else 2 * w - q        # the mirrored residue mod 2w

        while True:
            qi = sp.qmap.get(mq)
            assert qi is not None, (s, q, mq)
            if queues[qi]:
                ap = queues[qi].popleft()
                u = w * (a - ap) + q          # w(a-ap)-|q| (q<0) or +q
                if u > umax:
                    # partner too far: emit it as a singleton, retry pairing
                    qq = -q if q < 0 else (2 * w - q if q >= w else q)
                    map_v.append(2 * ap - amin)
                    map_u.append(qq)
                    pairs += 1
                    continue
                map_v.append(a + ap - amin)
                map_u.append(u)
                pairs += 1
                break
            else:
                res = (2 * w + q) if q < 0 else q
                queues[sp.qmap[res]].append(a)
                break

    # drain leftovers as singletons (reference ecm.c:2799-2850)
    for qi in range(sp.R):
        r = sp.qrmap[qi]
        q = 2 * w - r if r > w else r
        while queues[qi]:
            ap = queues[qi].popleft()
            map_v.append(2 * ap - amin)
            map_u.append(q)
            pairs += 1

    stats = dict(pairs=pairs, primes=nump,
                 ratio=(pairs / nump if nump else 0.0))
    if verbose:
        print(f"{pairs} map entries from {nump} primes "
              f"(ratio = {stats['ratio']:.2f})")
    return (np.asarray(map_v, dtype=np.uint32),
            np.asarray(map_u, dtype=np.uint32), amin_entry, stats)


def audit_coverage(sp: Stage2Params, map_v: np.ndarray, map_u: np.ndarray,
                   amin0: int, primes: Sequence[int], b1: int, b2: int
                   ) -> List[int]:
    """The 'testcoverage' self-check (reference ecm.c:2585-2900):
    verify every prime in [b1, b2) equals (v+amin)*w +- u for some map entry
    (with the executor's amin advancing by U per sentinel).  Returns the
    list of uncovered primes (must be empty)."""
    w, U = sp.D, sp.U
    covered = set()
    amin = amin0
    for v, u in zip(map_v.tolist(), map_u.tolist()):
        if v == 0 and u == 0:
            amin += U
            continue
        base = (v + amin) * w
        covered.add(base - u)
        covered.add(base + u)
    missing = []
    for s in primes:
        s = int(s)
        if b1 <= s < b2 and s not in covered:
            missing.append(s)
    return missing
