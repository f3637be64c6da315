"""`correct`: the window's answers against the plain reference
(reference/ecm.py), once the window has closed.

A sample of the window's curves, drawn from the seed, is recomputed by the
reference from its sigma alone: the curve, stage 1 to B1, and the stage-2
product over the plan the batch replayed, which the reference judges
first (every prime of the stage-2 range covered).  The sample holds the
window's first and last curves (the edges of the kernels' curve axis) and
at least one curve of every card.  Every number compared has the limit 0:
the arithmetic is exact.

  curve_mismatch   sampled curves built from another sigma than asked for,
                   where the asked-for sigma gives a curve
  stage1_mismatch  sampled curves whose stage-1 point (affine x) or
                   stage-1 gcd differs from the reference's
  stage2_mismatch  sampled curves whose stage-2 product differs (where a
                   factor ends stage 2 on either side: the other side
                   has to find one too)
  finds_mismatch   sampled curves whose reported factors differ from the
                   reference's, plus reported factors that do not divide N
  plan_uncovered   primes B1 < q < B2 that no entry of a batch's stage-2
                   plan covers (-1: an entry outside the baby steps)
  curves_missing   curves of the window's batches with no stage-1 point or
                   no stage-2 product
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import multiprocessing
import os
import random
from typing import Dict, List, Optional, Tuple

from reference import ecm as ref

LIMITS = {"curve_mismatch": 0, "stage1_mismatch": 0, "stage2_mismatch": 0,
          "finds_mismatch": 0, "plan_uncovered": 0, "curves_missing": 0}


def sample(seed: int, batches: int, batch: int, devices: int,
           count: int) -> List[Tuple[int, int]]:
    """(batch, column) of the curves to check: the first and the last, a
    random one of every card's columns, then random others, `count` in
    all (fewer where the window has fewer)."""
    rng = random.Random(f"{seed}:check")
    total = batches * batch
    picks = {0, total - 1}
    for d in range(devices):
        lo, hi = d * batch // devices, (d + 1) * batch // devices
        picks.add(rng.randrange(batches) * batch + rng.randrange(lo, hi))
    while len(picks) < min(count, total):
        picks.add(rng.randrange(total))
    return [(i // batch, i % batch) for i in sorted(picks)]


def program_answers(win, stage2_values, plans, factors,
                    picks) -> List[dict]:
    """What the window produced for each sampled curve."""
    out = []
    for bi, col in picks:
        b = win.batches[bi]
        res = b["residues"]
        base = bi * len(b["sigmas"])
        sig, x, z = res[col] if col < len(res) else (None, 0, 0)
        vals = stage2_values[bi] if bi < len(stage2_values) else []
        out.append({
            "asked": b["sigmas"][col], "sigma": sig, "X": x, "Z": z,
            "acc": vals[col] if col < len(vals) else None,
            "plan": plans[bi] if bi < len(plans) else None,
            "finds": {(f.stage, f.factor) for f in factors
                      if f.curve == base + col and f.stage in (1, 2)}})
    return out


def _reference(args):
    n, sigma, b1, plan, control = args
    return ref.check_curve(n, sigma, b1, plan, control)


def reference_answers(n: int, b1: int, answers: List[dict],
                      control: str = "", workers: Optional[int] = None
                      ) -> List[dict]:
    """The reference on every sampled curve, from the sigma its curve was
    built from, in a pool of spawned processes (one a core, at most one a
    curve); control breaks one guarantee (reference/ecm.py)."""
    jobs = [(n, a["sigma"] if a["sigma"] else a["asked"], b1, a["plan"],
             control) for a in answers]
    workers = workers or min(len(jobs), os.cpu_count() or 1)
    if workers <= 1:
        return [_reference(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        return list(pool.map(_reference, jobs))


def as_program(n: int, answers: List[dict], control: List[dict]
               ) -> List[dict]:
    """The program's answers with the control's in their place: its
    stage-1 point as (x, 1), its stage-2 product, its finds."""
    out = []
    for a, c in zip(answers, control):
        a = dict(a)
        a["X"], a["Z"] = (c["x1"], 1) if c["x1"] is not None else (0, 0)
        a["acc"] = c["acc"]
        a["finds"] = {(s, f) for s, f in ((1, c["find1"]), (2, c["find2"]))
                      if 1 < f < n}
        out.append(a)
    return out


def _expected_finds(n: int, r: dict) -> set:
    return {f for f in (r["find1"], r["find2"]) if 1 < f < n}


def compare(n: int, b1: int, b2: int, win, stage2_values, plans,
            factors, answers: List[dict], refs: List[dict],
            do_stage2: bool) -> Tuple[Dict[str, int], int]:
    """The numbers compared (LIMITS' keys) of a window, and how many
    sampled curves any of them finds wrong."""
    c = dict.fromkeys(LIMITS, 0)
    wrong = 0
    for a, r in zip(answers, refs):
        before = sum(c.values())
        if a["sigma"] != a["asked"] and (
                a["sigma"] is None or ref.builds(n, a["asked"])):
            c["curve_mismatch"] += 1
        x, z = a["X"] % n, a["Z"] % n
        g = math.gcd(z, n)
        if r["x1"] is not None:
            ok1 = g == 1 and x * pow(z, -1, n) % n == r["x1"]
        else:
            ok1 = g == r["find1"]
        c["stage1_mismatch"] += not ok1
        if do_stage2 and r["x1"] is not None:
            prog_s2 = any(s == 2 for s, _f in a["finds"])
            ref_s2 = r["acc"] is None or r["find2"] != 1
            if prog_s2 or ref_s2:
                ok2 = prog_s2 and ref_s2
            else:
                ok2 = a["acc"] is not None and a["acc"] % n == r["acc"]
            c["stage2_mismatch"] += not ok2
        if {f for _s, f in a["finds"]} != _expected_finds(n, r):
            c["finds_mismatch"] += 1
        wrong += sum(c.values()) > before
    c["finds_mismatch"] += sum(1 for f in factors
                               if not (1 < f.factor < n and n % f.factor == 0))
    if do_stage2:
        seen = {}
        for p in plans:
            key = id(p["chunks"][0][0]) if p["chunks"] else None
            if key not in seen:
                seen[key] = ref.plan_uncovered(p, b1, b2)
        bad = [v for v in seen.values() if v != 0]
        c["plan_uncovered"] = (-1 if any(v < 0 for v in bad)
                               else sum(bad))
        if len(plans) < len(win.batches):
            c["plan_uncovered"] = -1
    for bi, b in enumerate(win.batches):
        want = len(b["sigmas"])
        got1 = len(b["residues"])
        got2 = (len(stage2_values[bi]) if bi < len(stage2_values) else 0
                ) if do_stage2 else want
        c["curves_missing"] += max(0, want - got1) + max(0, want - got2)
    return c, wrong


def correct(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] == v for k, v in LIMITS.items())
