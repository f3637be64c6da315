"""The ECM driver for the digit engine and Suyama curves — the twin of
tpu_ecm/driver.py on one device.

Phase structure per batch of B curves (B = the curve axis of every plane):

  phase 0  build curves        host Suyama from sigma
  phase 1  stage 1             tape replay per prime chunk (kernel K1), with
                               GMP-ECM-format checkpoint.txt between chunks
                               and save_b1.txt at the end
  phase 2  stage 2 init        Pb table: chain (K2) + batch inversion (K3,
                               host modinv, K4)
  phase 3  stage 2 pairing     host pair() plan per chunk, giant-step groups
                               (K2-K4) and the replay (K5)
  harvest  gcd checks          host, against the original input

Not ported yet, each raising with the ROADMAP.md item that covers it:
Mersenne-form arithmetic, inputs beyond the digit engine (RNS), Edwards
stage 1.
"""

from __future__ import annotations

import concurrent.futures as _cf
import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import torch

from tpu_ecm import params as _params
from tpu_ecm.io import savefile
from tpu_ecm.primes import PrimeStream
from tpu_ecm.utils import rng as _rng

from . import stage1 as _stage1
from .curve import suyama
from .limbs import torch_ops
from .stage2 import exec as s2exec
from .stage2 import plan as s2plan

# stage-2 pairmaps kept for reuse across curve batches, in total entries
PAIRMAP_CACHE_ENTRIES = 125_000_000


@dataclasses.dataclass
class RunConfig:
    n: int                       # the number to factor (already calc()ed)
    curves: int
    b1: int
    b2: Optional[int] = None     # None -> 100*B1; <= B1 -> stage 1 only
    sigma: int = 0               # 0 -> random sigmas
    batch: Optional[int] = None  # curves per device batch (None: all curves)
    do_stage2: bool = True
    save_b1_path: Optional[str] = "save_b1.txt"
    checkpoint_path: Optional[str] = "checkpoint.txt"
    results_path: Optional[str] = "ecm_results.txt"
    verbose: int = 1
    force_no_mersenne: bool = False
    stop_on_factor: bool = True
    prime_chunk: Optional[int] = None
    curve_mode: str = "suyama"
    device: str = "cuda"


@dataclasses.dataclass
class FactorHit:
    factor: int
    stage: int
    curve: int
    sigma: int
    is_prp: bool


@dataclasses.dataclass
class RunResult:
    n: int
    work_modulus: int
    factors: List[FactorHit]
    curves_run: int
    stage1_residues: List[Tuple[int, int, int]]  # (sigma, X, Z) canonical
    timings: Dict[str, float]
    counters: Dict[str, int]


def prepare_context(n: int, force_no_mersenne: bool = False,
                    verbose: int = 1) -> _params.MontyCtx:
    """Mersenne detection + density rule + algebraic-factor stripping, then
    context construction (the JAX driver's rule, unchanged)."""
    work_n = n
    mers = None if force_no_mersenne else _params.detect_mersenne(n)
    if mers is not None:
        e, c = mers
        if abs(c) == 1:
            g = _params.strip_algebraic_factors(n, e, c)
            if g not in (0, 1) and g != n:
                if verbose:
                    cofactor = n // math.gcd(n, g)
                    print(f"removing algebraic "
                          f"{savefile.classify_factor(cofactor)} factor "
                          f"{cofactor}")
                work_n = math.gcd(n, g)
        if not _params.mersenne_density_ok(work_n, e):
            if verbose:
                print(f"Mersenne input 2^{e} determined to be faster by REDC")
            mers = None
        # pseudo-Mersenne c must leave fold headroom at our radix
        elif c not in (1, -1):
            w, _, _, dev_ok = _params._radix_or_host_only(e)
            if not dev_ok or e <= 2 * abs(c).bit_length() + 2 * w + 16:
                mers = None
    if mers is not None and verbose:
        e, c = mers
        kind = {1: f"2^{e}-1", -1: f"2^{e}+1"}.get(c, f"2^{e}-{c}")
        print(f"Using special Mersenne mod for factor of: {kind}")
    return _params.make_monty(work_n, mersenne=mers)


def check_factor(z: int, n: int) -> Optional[int]:
    """gcd harvest: a factor in (1, n)."""
    g = math.gcd(z % n, n)
    if 1 < g < n:
        return g
    return None


class ECMDriver:
    def __init__(self, cfg: RunConfig):
        if cfg.curve_mode != "suyama":
            raise NotImplementedError(
                f"curve_mode={cfg.curve_mode!r} is not ported yet: "
                "ROADMAP.md, 'Edwards stage 1'")
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        self.cfg = cfg
        # Montgomery arithmetic needs an odd modulus: divide out powers of 2
        # up front and report them as trivial factors
        self._even_factor = 0
        n = cfg.n
        while n % 2 == 0 and n > 1:
            n //= 2
            self._even_factor += 1
        if self._even_factor and cfg.verbose:
            print(f"dividing out factor 2^{self._even_factor}")
        if n == 1:
            raise ValueError("input is a power of 2; nothing to run ECM on")
        # perfect powers: every curve's gcd would hit n itself — factor the
        # base instead (factors lift to n)
        pp = _params.perfect_power(n)
        if pp is not None:
            base, k = pp
            if cfg.verbose:
                print(f"input is a perfect power: {base}^{k}; "
                      f"factoring the base")
            n = base
        # a probable-prime input needs no curves at all
        self._prp_input = (n > 1 and
                           savefile.classify_factor(n).startswith("PRP"))
        cfg = self.cfg = dataclasses.replace(cfg, n=n)
        if cfg.b2 is None:
            self.b2 = 100 * cfg.b1
            self.do_stage2 = cfg.do_stage2
        else:
            self.b2 = cfg.b2
            self.do_stage2 = cfg.do_stage2 and cfg.b2 > cfg.b1
        self.factors: List[FactorHit] = []
        self.timings: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        if self._prp_input:
            if cfg.verbose:
                print(f"input {n} is a probable prime; nothing to run")
            if self._even_factor:
                self._report_factor(2, 0, 0, 0, cfg.b1)
            self._report_factor(n, 0, 0, 0, cfg.b1)
            self._initial_hits = len(self.factors)
            return
        self.ctx = prepare_context(cfg.n, cfg.force_no_mersenne, cfg.verbose)
        if self.ctx.is_mersenne:
            raise NotImplementedError(
                "Mersenne-form input: the fold reduction is not ported yet "
                "(ROADMAP.md, 'Mersenne / pseudo-Mersenne path'); rerun "
                "with force_no_mersenne=True for generic REDC")
        if not self.ctx.p.device_ok:
            raise NotImplementedError(
                f"{self.ctx.p.nbits}-bit modulus exceeds the digit engine's "
                "int32 column bound; the RNS engine is not ported yet "
                "(ROADMAP.md, 'RNS engine')")
        self.dctx = torch_ops.device_ctx(self.ctx, self.device)
        self.stream = PrimeStream(cfg.prime_chunk or PrimeStream().chunk)
        # stage-2 pairmap cache: the (v, u) stream depends only on (chunk
        # bounds, B1, B2, D, U) — never on the curves — so it is planned
        # once and replayed for every curve batch
        self._pairmaps: Dict[Tuple[int, int], tuple] = {}
        self._pairmap_entries = 0
        seed = _rng.hash64(int(time.time() * 1e6) & ((1 << 64) - 1))
        self.sigma_gen = _rng.SigmaGen(cfg.sigma, seed)
        if self._even_factor:
            self._report_factor(2, 0, 0, 0, cfg.b1)
        # trivial up-front factors must not trip stop_on_factor
        self._initial_hits = len(self.factors)

    # ------------------------------------------------------------------

    def _report_factor(self, f: int, stage: int, curve_idx: int, sigma: int,
                       bound: int):
        if any(h.factor == f and h.sigma == sigma for h in self.factors):
            return
        hit = FactorHit(factor=f, stage=stage, curve=curve_idx, sigma=sigma,
                        is_prp=savefile.classify_factor(f).startswith("PRP"))
        self.factors.append(hit)
        savefile.log_factor(self.cfg.results_path, f, stage, bound,
                            curve_idx, 0, curve_idx, sigma,
                            echo=self.cfg.verbose >= 1)

    def _check_batch(self, vals: List[int], sigmas: List[int], stage: int,
                     bound: int, base_idx: int):
        for i, (z, s) in enumerate(zip(vals, sigmas)):
            f = check_factor(z, self.ctx.input_n)
            if f:
                self._report_factor(f, stage, base_idx + i, s, bound)

    def _write_save(self, path: Optional[str], sigmas: List[int],
                    xs: List[int], zs: List[int], b1_label: int):
        if not path:
            return
        n_out = self.ctx.input_n
        recs = [savefile.SaveRecord(sigma=s, b1=b1_label, n=n_out, x=x, z=z)
                for s, x, z in zip(sigmas, xs, zs)]
        savefile.append_records(path, recs)

    def _add_time(self, key: str, t0: float):
        self.timings[key] = self.timings.get(key, 0) + time.time() - t0

    # ------------------------------------------------------------------

    def run_batch(self, sigmas: List[int], base_idx: int
                  ) -> List[Tuple[int, int, int]]:
        cfg, ctx = self.cfg, self.ctx
        t0 = time.time()
        curves = []
        for s in sigmas:
            # keep batch shape: on a gcd hit during construction, report the
            # factor and retry with fresh sigmas (an input with several small
            # factors can trip consecutive substitutes too)
            for _attempt in range(64):
                try:
                    curves.append(suyama.build_one_curve(ctx, s))
                    break
                except suyama.FactorFoundDuringBuild as e:
                    if e.factor:
                        self._report_factor(e.factor, 0, base_idx, e.sigma,
                                            cfg.b1)
                    s = s + 1_000_003
            else:
                raise RuntimeError(
                    "curve construction kept hitting gcd factors; "
                    "input has many small factors — divide them out first")
        state = _stage1.init_state(
            ctx, [c.x_mont for c in curves], [c.z_mont for c in curves],
            [c.s_mont for c in curves], self.device)
        self._add_time("build", t0)

        # ---- stage 1 ----
        t0 = time.time()
        for chunk, state in _stage1.run_stage1(state, self.dctx, cfg.b1,
                                               self.stream):
            for k in ("ptadds", "ptdups", "numprimes"):
                self.counters[k] = (self.counters.get(k, 0)
                                    + getattr(chunk, k))
            if not chunk.is_final:
                # mid-stage-1 checkpoint
                xs, zs = _stage1.extract_point(state, ctx)
                self._check_batch(zs, sigmas, 1, chunk.last_prime, base_idx)
                self._write_save(cfg.checkpoint_path, sigmas, xs, zs,
                                 chunk.last_prime)
        xs, zs = _stage1.extract_point(state, ctx)
        self._add_time("stage1", t0)
        if cfg.verbose >= 2:
            print(f"Stage 1 completed, {self.counters.get('ptadds', 0)} "
                  f"point-adds, {self.counters.get('ptdups', 0)} "
                  f"point-doubles over {self.counters.get('numprimes', 0)} "
                  f"primes")
        self._check_batch(zs, sigmas, 1, cfg.b1, base_idx)
        self._write_save(cfg.save_b1_path, sigmas, xs, zs, cfg.b1)
        residues = [(s, x, z) for s, x, z in zip(sigmas, xs, zs)]

        # ---- stage 2 ----
        self._run_stage2(state.pts[0], state.s_const, sigmas, base_idx)
        return residues

    def _stage2_chunk_bounds(self) -> List[Tuple[int, int]]:
        """Chunk bounds of the stage-2 prime walk — the stream.chunks
        protocol without materializing primes."""
        out = []
        p = self.cfg.b1
        while p < self.b2:
            q = min(p + self.stream.chunk, self.b2)
            out.append((p, q))
            p = q
        return out

    def _iter_pairmaps(self, sp):
        """Yield each stage-2 chunk's pairmap, planning (sieve + pair) one
        chunk AHEAD on a background thread so the host planner overlaps the
        device replay of the previous chunk.  The exposed wait lands in
        timings['stage2_plan_wait'], the cumulative sieve/pair wall in
        timings['stage2_sieve'/'stage2_pair']."""
        bounds = self._stage2_chunk_bounds()
        # a dedicated stream: the planner thread must not race the driver's
        # chunk cache (PrimeStream.load mutates self.primes)
        stream = PrimeStream(self.stream.chunk)
        timings = self.timings

        def make(lo: int, hi: int):
            t0 = time.time()
            primes = stream.load(lo, hi + 1000 if hi == self.b2 else hi)
            t1 = time.time()
            cached = s2plan.pair(sp, primes, lo, hi,
                                 verbose=self.cfg.verbose >= 2)
            t2 = time.time()
            timings["stage2_sieve"] = (timings.get("stage2_sieve", 0)
                                       + t1 - t0)
            timings["stage2_pair"] = timings.get("stage2_pair", 0) + t2 - t1
            return cached

        pool = _cf.ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="s2plan")
        futs: Dict[int, object] = {}

        def ensure(i: int):
            if (0 <= i < len(bounds) and i not in futs
                    and bounds[i] not in self._pairmaps):
                futs[i] = pool.submit(make, *bounds[i])

        try:
            ensure(0)
            for i, (lo, hi) in enumerate(bounds):
                ensure(i + 1)
                cached = self._pairmaps.get((lo, hi))
                if cached is None:
                    t0 = time.time()
                    cached = futs.pop(i).result()
                    self._add_time("stage2_plan_wait", t0)
                    if (self._pairmap_entries + cached[0].size
                            <= PAIRMAP_CACHE_ENTRIES):
                        self._pairmaps[(lo, hi)] = cached
                        self._pairmap_entries += cached[0].size
                yield cached
        finally:
            for f in futs.values():
                f.cancel()
            pool.shutdown(wait=False)

    def _run_stage2(self, pts0, s_const, sigmas: List[int], base_idx: int):
        cfg = self.cfg
        if not self.do_stage2:
            return
        t0 = time.time()
        sp = s2plan.make_stage2_params(cfg.b1, self.b2, nw=self.ctx.p.nw,
                                       batch=int(pts0.shape[-1]))
        runner = s2exec.Stage2Runner(self.ctx, self.dctx, sp, pts0, s_const)
        runner.init()
        self._sync()
        self._add_time("stage2_init", t0)
        t0 = time.time()
        s2_pairs = s2_primes = 0
        for map_v, map_u, amin0, stats in self._iter_pairmaps(sp):
            s2_pairs += stats["pairs"]
            s2_primes += stats["primes"]
            runner.run_chunk(map_v, map_u, amin0)
        res = runner.result()
        self._add_time("stage2", t0)
        if cfg.verbose >= 1 and s2_primes:
            print(f"stage 2: {s2_pairs} pairs from {s2_primes} primes "
                  f"(ratio = {s2_pairs / s2_primes:.2f})")
        for k in ("paired", "ptadds", "ptdups", "numinv"):
            self.counters[k] = self.counters.get(k, 0) + getattr(res, k)
        for i, f in res.factors.items():
            if f:
                self._report_factor(f, 2, base_idx + i, sigmas[i], self.b2)
        self._check_batch(res.acc, sigmas, 2, self.b2, base_idx)

    def _sync(self):
        """Wait for the device so a phase timing covers its kernels."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------

    def run(self) -> RunResult:
        cfg = self.cfg
        if self._prp_input:
            return RunResult(n=cfg.n, work_modulus=cfg.n,
                             factors=self.factors, curves_run=0,
                             stage1_residues=[], timings={}, counters={})
        total = cfg.curves
        batch = cfg.batch or total
        residues: List[Tuple[int, int, int]] = []
        done = 0
        while done < total:
            b = min(batch, total - done)
            sigmas = [self.sigma_gen.next() for _ in range(b)]
            if cfg.verbose:
                print(f"Commencing curves {done}-{done + b - 1} of {total}")
            residues += self.run_batch(sigmas, done)
            done += b
            if len(self.factors) > self._initial_hits and cfg.stop_on_factor:
                break
        return RunResult(n=cfg.n, work_modulus=self.ctx.n_int,
                         factors=self.factors, curves_run=done,
                         stage1_residues=residues, timings=dict(self.timings),
                         counters=dict(self.counters))


def run_ecm(n: int, curves: int, b1: int, **kw) -> RunResult:
    cfg = RunConfig(n=n, curves=curves, b1=b1, **kw)
    return ECMDriver(cfg).run()
