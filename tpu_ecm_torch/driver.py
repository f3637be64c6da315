"""The ECM driver — the twin of tpu_ecm/driver.py, with its two arithmetic
engines and two curve families, on one device or with the curve axis
split over several (RunConfig.sharder):

  digit  int32 digit planes [.., NW, B], kernels K1-K9
         (limbs/kernels.py), reducing by REDC or, for a special form
         2^e - c, by the fold; the default wherever a digit radix exists
         (params.device_ok), and the only engine of Edwards curves and of
         special forms under engine="auto"
  rns    residue planes [.., 2K+1, B], kernels K10-K15
         (limbs/rns_kernels.py), Suyama curves only; the only engine above
         the digit engine's int32 column bound (~2000 bits), and selectable
         below it

  suyama   Montgomery curves from sigma, PRAC stage-1 tapes (K1 / K10)
  edwards  a=-1 twisted Edwards curves from sigma, wNAF stage-1 tapes over
           a cached window table (K9), handed to the Montgomery stage 2
           through (U : W) = (Z+Y : Z-Y)

Phase structure per batch of B curves (B = the curve axis of every plane):

  phase 0  build curves        host Suyama or Edwards from sigma
  phase 1  stage 1             tape replay per prime chunk (K1 / K10 / K9),
                               with GMP-ECM-format checkpoint.txt between
                               chunks and save_b1.txt at the end (Edwards:
                               the window table is rebuilt on the host from
                               each chunk-boundary point)
  phase 2  stage 2 init        Pb table: chain (K2 / K11) + batch inversion
                               (K3 / K12, host modinv, K4 / K13)
  phase 3  stage 2 pairing     host pair() plan per chunk, giant-step groups
                               (chain, prefix, apply) and the replay in the
                               engine's default mode or the one
                               RunConfig.replay names: stream (K5 / K15),
                               gather (K6 / K14), parow (K7) or resident
                               (K8; both digit engine only); under
                               RunConfig.cross="noinv" (digit engine) the
                               Pb table and Pa groups stay projective and
                               the replay runs on torch ops
  harvest  gcd checks          host, against the original input

resume_stage2 runs phases 2-3 (and the leftover stage-1 gcd) from a
stage-1 savefile instead of phases 0-1.

With a Sharder (parallel/mesh.py) the driver keeps one shard per device:
its own DeviceCtx and engine ops, and its contiguous slice of the batch.
The host builds the curves, plans every stage-1 tape, Edwards window
table and stage-2 pairmap once for the whole batch and hands each shard
its slice; the stage-1 kernels are launched on every shard in turn from
this thread.  Stage 2 runs one Stage2Runner a shard, all replaying the
same pairmap chunk by chunk on one Pa group, in lock-step from this
thread (run_steps): each group's kernels are launched on every shard
before the host crosses any of them, and each runner takes its own host
modular inverse per group.  The host serializes at the gcd harvest, the
checkpoint and save_b1.txt writes (in curve order, over the whole batch,
so the files are one device's bytes) and, in stage 2, at every shard's
host crossing in turn: its unpacking, host modinv, the RNS engine's CRT
packing and the kernel launches themselves.
A run stops early on a factor found by any process of a job when
RunConfig.hit_flag (parallel/coordination.py) says so at a batch
boundary.
"""

from __future__ import annotations

import collections
import concurrent.futures as _cf
import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as _dist

from . import params as _params
from .io import savefile
from .primes import PrimeStream
from .utils import rng as _rng

from . import stage1 as _stage1
from .curve import edops, edwards, suyama
from .limbs import kernels, layout, rns, rns_exec, torch_ops
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
    # arithmetic engine: "digit", "rns", or "auto" (digit wherever a digit
    # radix exists, RNS above the digit engine's bound)
    engine: str = "auto"
    # stage-2 replay mode (stage2/exec.py:REPLAY_MODES): None takes the
    # engine's default (stream on both engines); "stream",
    # "gather", "parow" or "resident" choose one for tests and
    # measurements; a mode the engine has no kernel for raises
    replay: Optional[str] = None
    # stage-2 cross-product form (stage2/exec.py:CROSS_FORMS): "inv"
    # (batch inversion, the replay kernels) or "noinv" (projective rows,
    # torch ops, digit engine only; replay must stay None)
    cross: str = "inv"
    # stage-1 PRAC rule set: False the reduced 3/4/5/9 set, True all nine
    # rules (curve/prac.py; planned in Python)
    full_prac: bool = False
    # the curve axis split over several devices (parallel.mesh.Sharder):
    # its devices take the place of `device`, and batch and total are
    # rounded up to a multiple of their count
    sharder: Optional[object] = None
    # stop-on-factor across processes (parallel.coordination.HitFlag):
    # planned before the batch loop, polled at every batch boundary and
    # drained after it
    hit_flag: Optional[object] = None


ENGINES = ("auto", "digit", "rns")
CURVE_MODES = ("suyama", "edwards")
# the savefile PROGRAM tag of Edwards records, whose SIGMA is an Edwards
# seed (X, Z are on the equivalent Montgomery curve either way)
ED_PROGRAM = "AVX-ECM-ED"


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


def process_index() -> int:
    """This process's rank in torch.distributed's default group, 0 without
    an initialized group."""
    if _dist.is_available() and _dist.is_initialized():
        return _dist.get_rank()
    return 0


def merged_finds(results: list, offsets: List[int]) -> List[Tuple[int, int]]:
    """(curve, factor) of the shards' stage-2 inversion finds, shard i's
    curves starting at offsets[i], in the order one runner over the whole
    batch meets them: by the inversion that found them, then by curve."""
    return [(i, f) for _inv, i, f in sorted(
        (r.found_at[j], off + j, f) for off, r in zip(offsets, results)
        for j, f in r.factors.items())]


def run_steps(steps: list) -> None:
    """Run the shards' step generators in lock-step from this thread: one
    step of each a round, in shard order, until all are done.  A step ends
    where its shard's next host crossing would wait on its kernels
    (Stage2Runner.init_steps, chunk_steps), so the other shards' kernels
    run while one shard's host work does."""
    while steps:
        steps = [s for s in steps if next(s, StopIteration)
                 is not StopIteration]


def check_factor(z: int, n: int) -> Optional[int]:
    """gcd harvest: a factor in (1, n)."""
    g = math.gcd(z % n, n)
    if 1 < g < n:
        return g
    return None


class ECMDriver:
    def __init__(self, cfg: RunConfig):
        if cfg.curve_mode not in CURVE_MODES:
            raise ValueError(f"unknown curve_mode {cfg.curve_mode!r}; "
                             f"expected one of {CURVE_MODES}")
        if cfg.engine not in ENGINES:
            raise ValueError(f"unknown engine {cfg.engine!r}; "
                             f"expected one of {ENGINES}")
        if cfg.engine == "rns" and cfg.curve_mode == "edwards":
            # the Edwards doubling nests two subtractions (E = E0 - A - B),
            # which breaks the RNS engine's 2V input bound
            raise ValueError("engine='rns' supports curve_mode='suyama' only")
        # the shards' devices: the sharder's, else the one device
        self.devices = (list(cfg.sharder.devices) if cfg.sharder is not None
                        else [torch.device(cfg.device)])
        self.device = self.devices[0]
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
        # stage-2 replay entry slots, pads included (Stage2Result.slots);
        # kept apart from the counters, which match tpu_ecm's
        self.replay_slots = 0
        if self._prp_input:
            if cfg.verbose:
                print(f"input {n} is a probable prime; nothing to run")
            if self._even_factor:
                self._report_factor(2, 0, 0, 0, cfg.b1)
            self._report_factor(n, 0, 0, 0, cfg.b1)
            self._initial_hits = len(self.factors)
            return
        self.ctx = prepare_context(cfg.n, cfg.force_no_mersenne, cfg.verbose)
        # "auto" takes the digit engine wherever a digit radix exists: it is
        # the only engine of special forms and of Edwards curves there, and
        # the port has no measured digit/RNS crossover (ROADMAP A.18)
        self.engine = "digit" if cfg.engine == "auto" else cfg.engine
        if not self.ctx.p.device_ok:
            # no int32 digit radix exists (params._radix_or_host_only): the
            # RNS engine is the only device path
            if cfg.engine == "digit":
                raise ValueError(
                    f"{self.ctx.p.nbits}-bit modulus exceeds the digit "
                    "engine's int32 column bound (about 2000 bits, "
                    "params._radix_or_host_only); use engine='rns'")
            if cfg.curve_mode != "suyama":
                raise ValueError(
                    f"{self.ctx.p.nbits}-bit moduli require the RNS engine, "
                    "which supports curve_mode='suyama' only")
            self.engine = "rns"
        # one engine ops a shard, each with the constants on its device
        if self.engine == "rns":
            self.rhost = rns.make_rns(self.ctx,
                                      cw=rns.choose_cw(self.ctx.p.nbits))
            self.shard_ops = [s2exec.RnsOps(self.rhost,
                                            rns.device_ctx(self.rhost, d))
                              for d in self.devices]
            if cfg.verbose:
                print(f"engine: RNS, K={self.rhost.K} channels x 2 bases")
        else:
            self.shard_ops = [s2exec.DigitOps(
                self.ctx, torch_ops.device_ctx(self.ctx, d))
                for d in self.devices]
        # the devices as their tensors name them ("cuda" is "cuda:0"); shards
        # on one device share its memory (the Pa group, noinv's row slices)
        self.devices = [ops.device for ops in self.shard_ops]
        self.device = self.devices[0]
        per_device = collections.Counter(self.devices)
        for ops in self.shard_ops:
            ops.mem_share = 1 / per_device[ops.device]
        self.ops = self.shard_ops[0]
        self.replay = s2exec.replay_mode(cfg.replay, self.ops, cfg.cross)
        self.stream = PrimeStream(cfg.prime_chunk or PrimeStream().chunk)
        # stage-2 pairmap cache: the (v, u) stream depends only on (chunk
        # bounds, B1, B2, D, U) — never on the curves — so it is planned
        # once and replayed for every curve batch
        self._pairmaps: Dict[Tuple[int, int], tuple] = {}
        self._pairmap_entries = 0
        # the process index is mixed into the random-sigma seed, so that
        # processes of one job do not rest on their clocks alone to draw
        # different sigmas (tpu_ecm/driver.py:422-431)
        seed = _rng.hash64((int(time.time() * 1e6)
                            ^ (process_index() * 0x9E3779B97F4A7C15))
                           & ((1 << 64) - 1))
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
                    xs: List[int], zs: List[int], b1_label: int,
                    program: str = "AVX-ECM"):
        # PROGRAM tags the curve family: AVX-ECM-ED records carry an Edwards
        # seed in SIGMA (X/Z are on the equivalent Montgomery curve either
        # way); N is the input, also when the arithmetic is mod 2^e - c
        if not path:
            return
        n_out = self.ctx.input_n
        recs = [savefile.SaveRecord(sigma=s, b1=b1_label, n=n_out, x=x, z=z,
                                    program=program)
                for s, x, z in zip(sigmas, xs, zs)]
        savefile.append_records(path, recs)

    def _add_time(self, key: str, t0: float):
        self.timings[key] = self.timings.get(key, 0) + time.time() - t0

    # ------------------------------------------------------------------

    def _build_curves(self, sigmas: List[int], base_idx: int,
                      build=suyama.build_one_curve) -> list:
        curves = []
        for i, s in enumerate(sigmas):
            # keep batch shape: on a gcd hit during construction, report the
            # factor at the curve's own index (tpu_ecm reports base_idx,
            # ROADMAP C.1) and retry with fresh sigmas (an input with several
            # small factors can trip consecutive substitutes too)
            for _attempt in range(64):
                try:
                    curves.append(build(self.ctx, s))
                    break
                except suyama.FactorFoundDuringBuild as e:
                    if e.factor:
                        self._report_factor(e.factor, 0, base_idx + i,
                                            e.sigma, self.cfg.b1)
                    s = s + 1_000_003
            else:
                raise RuntimeError(
                    "curve construction kept hitting gcd factors; "
                    "input has many small factors — divide them out first")
        return curves

    def _split(self, b: int) -> List[Tuple[int, int]]:
        """Each shard's columns [lo, hi) of a batch of b curves."""
        if self.cfg.sharder is None:
            return [(0, b)]
        return self.cfg.sharder.split(b)

    def _put(self, x: np.ndarray) -> List[torch.Tensor]:
        """A host array [.., B] as one tensor a shard: its columns, on its
        device."""
        if self.cfg.sharder is None:
            return [torch.from_numpy(np.ascontiguousarray(x)).to(self.device)]
        return self.cfg.sharder.device_put(x)

    def _init_state(self, curves: List[suyama.CurveInit]
                    ) -> List[_stage1.Stage1State]:
        """The batch's stage-1 state, packed on the host and split into one
        state a shard."""
        ctx = self.ctx
        if self.engine == "digit":
            pts, sc = _stage1.pack_state(
                ctx, [c.x_mont for c in curves], [c.z_mont for c in curves],
                [c.s_mont for c in curves])
        else:
            conv = ctx.from_mont_int
            pts, sc = rns_exec.init_state(
                self.rhost, [conv(c.x_mont) for c in curves],
                [conv(c.z_mont) for c in curves],
                [conv(c.s_mont) for c in curves])
        return [_stage1.Stage1State(pts=p, s_const=c)
                for p, c in zip(self._put(pts), self._put(sc))]

    def _extract_point(self, states: List[_stage1.Stage1State]
                       ) -> Tuple[List[int], List[int]]:
        """Canonical (X, Z) of slot 0 of every shard, in curve order: the
        phase-boundary handoff."""
        xs: List[int] = []
        zs: List[int] = []
        for st in states:
            if self.engine == "digit":
                x, z = _stage1.extract_point(st, self.ctx)
            else:
                x, z = rns_exec.extract_point(self.rhost, st.pts)
            xs += x
            zs += z
        return xs, zs

    def run_batch(self, sigmas: List[int], base_idx: int
                  ) -> List[Tuple[int, int, int]]:
        cfg = self.cfg
        if cfg.curve_mode == "edwards":
            return self._run_batch_edwards(sigmas, base_idx)
        t0 = time.time()
        curves = self._build_curves(sigmas, base_idx)
        # each curve keeps the sigma it was built from, on both engines
        # (tpu_ecm's digit engine keeps the requested one, ROADMAP C.2)
        sigmas = [c.sigma for c in curves]
        states = self._init_state(curves)
        self._add_time("build", t0)

        # ---- stage 1: each chunk's tape planned once, run on every shard
        t0 = time.time()
        for chunk in _stage1.run_stage1(states,
                                        [o.tape for o in self.shard_ops],
                                        cfg.b1, self.stream,
                                        full_prac=cfg.full_prac):
            for k in ("ptadds", "ptdups", "numprimes"):
                self.counters[k] = (self.counters.get(k, 0)
                                    + getattr(chunk, k))
            if not chunk.is_final:
                # mid-stage-1 checkpoint
                xs, zs = self._extract_point(states)
                self._check_batch(zs, sigmas, 1, chunk.last_prime, base_idx)
                self._write_save(cfg.checkpoint_path, sigmas, xs, zs,
                                 chunk.last_prime)
        xs, zs = self._extract_point(states)
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
        self._run_stage2([st.pts[0] for st in states],
                         [st.s_const for st in states], sigmas, base_idx)
        return residues

    # -- Edwards stage 1 -------------------------------------------------

    def _ed_normalize(self, accs: List[torch.Tensor], sigmas: List[int],
                      base_idx: int, bound: int):
        """Normalize the shards' Edwards accumulators on the host at a chunk
        boundary, as one batch in curve order (ONE batch modinv): returns
        (base_pts [(x, y)], u, w) with u/w the canonical Montgomery-x
        projective pair (Z+Y, Z-Y) of the checkpoint record.  A lane whose
        Z shares a factor with n is a find (harvested like an inversion
        failure); it continues from the identity (0, 1) so the batch keeps
        its shape."""
        ctx = self.ctx
        n = ctx.n_int
        arr = np.concatenate([a.cpu().numpy() for a in accs], axis=-1)
        xc, yc, zc = ([ctx.from_mont_int(v % n)
                       for v in layout.unpack_batch(arr[k], ctx.p.w)]
                      for k in range(3))
        invs, fnd = s2exec.host_batch_inverse(ctx, zc, premul=1)
        for i, f in fnd.items():
            if f:
                self._report_factor(f, 1, base_idx + i, sigmas[i], bound)
        base_pts = [(0, 1) if i in fnd else
                    (xc[i] * invs[i] % n, yc[i] * invs[i] % n)
                    for i in range(len(zc))]
        u = [(z + y) % n for z, y in zip(zc, yc)]
        w = [(z - y) % n for z, y in zip(zc, yc)]
        return base_pts, u, w

    def _run_batch_edwards(self, sigmas: List[int], base_idx: int
                           ) -> List[Tuple[int, int, int]]:
        """Stage 1 on a=-1 twisted Edwards curves (curve/edwards.py), then
        the Montgomery stage 2 on the birationally equivalent curve through
        (U : W) = (Z+Y : Z-Y) and (A+2)/4 = 1/(1+d).

        Stage 1 runs per prime chunk: the scalar factorizes over the chunks
        (s = s_c0 * s_c1 * ...), each chunk replays its own wNAF tape (K9)
        with the window table rebuilt from the normalized chunk-boundary
        point, and checkpoint.txt is appended per chunk, as on the Suyama
        path."""
        cfg, ctx = self.cfg, self.ctx
        t0 = time.time()
        curves = self._build_curves(sigmas, base_idx,
                                    build=edwards.build_one_curve)
        sigmas = [c.sigma for c in curves]
        self._add_time("build", t0)

        t0 = time.time()
        chunk_list = list(self.stream.chunks(0, cfg.b1))
        accs = None
        base_pts = None          # None: the curves' own base points
        nprimes = 0
        for ci, (_lo, _hi, primes) in enumerate(chunk_list):
            tape, lead = edwards.stage1_tape(primes, cfg.b1,
                                             include_two=(ci == 0))
            # (re)build the window tables from the chunk's start point (may
            # harvest a factor from a non-invertible Z)
            try:
                pts, table = edwards.build_batch_tables(ctx, curves,
                                                        base_pts=base_pts)
            except suyama.FactorFoundDuringBuild as e:
                if e.factor:
                    # the index of the curve whose sigma hit (tpu_ecm
                    # reports base_idx, ROADMAP C.1)
                    hit = next((i for i, c in enumerate(curves)
                                if c.sigma == e.sigma), 0)
                    self._report_factor(e.factor, 1 if ci else 0,
                                        base_idx + hit, e.sigma, cfg.b1)
                raise RuntimeError(
                    "window table hit a factor of n; rerun with fresh "
                    "sigmas or divide the reported factor out") from e
            # the tables are built once for the batch and split; K9 runs on
            # every shard
            accs = self._put(edwards.init_accumulator(ctx, pts, lead))
            for acc, tab, ops in zip(accs, self._put(table), self.shard_ops):
                kernels.ed_tape(acc, tape, tab, ops.dctx)
            ops_col = tape[:, 0]
            nadd = int(np.count_nonzero((ops_col == edwards.ED_ADD)
                                        | (ops_col == edwards.ED_SUB)))
            self.counters["ptdups"] = (
                self.counters.get("ptdups", 0)
                + int(np.count_nonzero(ops_col <= edwards.ED_DBLT)) + 1)
            self.counters["ptadds"] = (self.counters.get("ptadds", 0) + nadd
                                       + table.shape[0] - 1)
            nprimes += int(np.count_nonzero((primes < cfg.b1)
                                            & (primes > 2))) + (ci == 0)
            if ci < len(chunk_list) - 1:
                # mid-stage-1 checkpoint and the next chunk's table base
                bound = min(int(primes[-1]), cfg.b1)
                t1 = time.time()
                base_pts, u_c, w_c = self._ed_normalize(accs, sigmas,
                                                        base_idx, bound)
                self._add_time("ed_normalize", t1)
                self._check_batch(w_c, sigmas, 1, bound, base_idx)
                self._write_save(cfg.checkpoint_path, sigmas, u_c, w_c,
                                 bound, program=ED_PROGRAM)
        self.counters["numprimes"] = (self.counters.get("numprimes", 0)
                                      + nprimes)
        # Montgomery handoff, shard by shard
        pts0, xs, zs, ax = [], [], [], []
        for acc, ops in zip(accs, self.shard_ops):
            u, w = edops.to_montgomery_pair(acc, ops.dctx)
            pts0.append(torch.stack([u, w]))
            xs += [ops.from_mont_int(v) for v in ops.unpack(u)]
            zs += [ops.from_mont_int(v) for v in ops.unpack(w)]
            ax += [ops.from_mont_int(v) for v in ops.unpack(acc[0])]
        self._add_time("stage1", t0)
        if cfg.verbose >= 2:
            print(f"Stage 1 (edwards) completed, "
                  f"{self.counters.get('ptadds', 0)} window-adds, "
                  f"{self.counters.get('ptdups', 0)} doublings")
        # the identity mod p shows as X=0 (and (0,-1) too); y=1 as W=0
        self._check_batch(ax, sigmas, 1, cfg.b1, base_idx)
        self._check_batch(zs, sigmas, 1, cfg.b1, base_idx)
        self._write_save(cfg.save_b1_path, sigmas, xs, zs, cfg.b1,
                         program=ED_PROGRAM)
        residues = [(s, x, z) for s, x, z in zip(sigmas, xs, zs)]
        s_const = self._put(layout.pack_batch([c.s_mont for c in curves],
                                              ctx.p.w, ctx.p.nw))
        self._run_stage2(pts0, s_const, sigmas, base_idx)
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

    def _pa_group(self, sp, widths: List[int]) -> Optional[int]:
        """One Pa group for every shard of a batch: on CUDA the smallest
        that any shard's memory rule allows; None on the CPU, where the
        runner takes PA_GROUP["cpu"]."""
        if self.device.type != "cuda":
            return None
        return min(s2exec.pa_group_for_ops(ops, sp, b, self.cfg.cross)
                   for ops, b in zip(self.shard_ops, widths))

    def _run_stage2(self, pts0: List[torch.Tensor],
                    s_const: List[torch.Tensor], sigmas: List[int],
                    base_idx: int):
        """Stage 2 of a batch from each shard's stage-1 point and curve
        constant: one runner a shard on the batch's parameters, Pa group
        and pairmaps, the finds harvested in curve order and the counters
        taken once a batch, as tpu_ecm's one runner counts them."""
        cfg = self.cfg
        if not self.do_stage2:
            return
        t0 = time.time()
        # the global width: one device and n devices pair the same entries
        sp = s2plan.make_stage2_params(cfg.b1, self.b2, nw=self.ctx.p.nw,
                                       batch=len(sigmas))
        g = self._pa_group(sp, [int(p.shape[-1]) for p in pts0])
        runners = [s2exec.Stage2Runner(self.ctx, None, sp, pt, sc, ops=ops,
                                       replay=self.replay, cross=cfg.cross,
                                       pa_group=g)
                   for pt, sc, ops in zip(pts0, s_const, self.shard_ops)]
        run_steps([r.init_steps() for r in runners])
        self._sync()
        self._add_time("stage2_init", t0)
        t0 = time.time()
        s2_pairs = s2_primes = 0
        for map_v, map_u, amin0, stats in self._iter_pairmaps(sp):
            s2_pairs += stats["pairs"]
            s2_primes += stats["primes"]
            run_steps([r.chunk_steps(map_v, map_u, amin0)
                       for r in runners])
        results = [r.result() for r in runners]
        self._add_time("stage2", t0)
        if cfg.verbose >= 1 and s2_primes:
            print(f"stage 2: {s2_pairs} pairs from {s2_primes} primes "
                  f"(ratio = {s2_pairs / s2_primes:.2f})")
        # every runner replays the same entries and inverts the same
        # groups: the batch's counts are any one runner's
        for k in ("paired", "ptadds", "ptdups", "numinv"):
            self.counters[k] = self.counters.get(k, 0) + getattr(results[0], k)
        self.replay_slots += results[0].slots
        offsets = [lo for lo, _hi in self._split(len(sigmas))]
        for i, f in merged_finds(results, offsets):
            if f:
                self._report_factor(f, 2, base_idx + i, sigmas[i], self.b2)
        self._check_batch([a for r in results for a in r.acc], sigmas, 2,
                          self.b2, base_idx)

    def _sync(self):
        """Wait for the devices so a phase timing covers its kernels."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------

    def run(self) -> RunResult:
        cfg = self.cfg
        if self._prp_input:
            return RunResult(n=cfg.n, work_modulus=cfg.n,
                             factors=self.factors, curves_run=0,
                             stage1_residues=[], timings={}, counters={})
        total = cfg.curves
        batch = cfg.batch or total
        if (not cfg.batch and self.engine == "rns"
                and self.device.type == "cuda"):
            # the card's batch on every device (tpu_ecm/driver.py:972-983)
            batch = min(total, len(self.devices) * min(
                rns_exec.default_batch(d) for d in self.devices))
        if cfg.sharder is not None:
            # whole shards: rounded to the device count, not to 128 lanes
            # (the kernels take any batch; tpu_ecm/driver.py:989-991)
            batch = cfg.sharder.round_batch(batch)
            total = cfg.sharder.round_batch(total)
        flag = cfg.hit_flag
        residues: List[Tuple[int, int, int]] = []
        done = 0
        if flag is not None:
            # collective flags agree on a poll budget first: the batch
            # count follows the local devices and engine, so processes can
            # differ (parallel/coordination.py)
            flag.plan((total + batch - 1) // batch)
        try:
            while done < total:
                b = min(batch, total - done)
                sigmas = [self.sigma_gen.next() for _ in range(b)]
                if cfg.verbose:
                    print(f"Commencing curves {done}-{done + b - 1} of "
                          f"{total}")
                residues += self.run_batch(sigmas, done)
                done += b
                hit = len(self.factors) > self._initial_hits
                if flag is not None:
                    # publish this process's bit and learn every process's
                    # at the batch boundary
                    hit = flag.poll(hit)
                if hit and cfg.stop_on_factor:
                    break
        finally:
            if flag is not None:
                flag.drain()
        return RunResult(n=cfg.n, work_modulus=self.ctx.n_int,
                         factors=self.factors, curves_run=done,
                         stage1_residues=residues, timings=dict(self.timings),
                         counters=dict(self.counters))


def run_ecm(n: int, curves: int, b1: int, **kw) -> RunResult:
    cfg = RunConfig(n=n, curves=curves, b1=b1, **kw)
    return ECMDriver(cfg).run()


def resume_stage2(path: str, b2: int, *,
                  results_path: Optional[str] = "ecm_results.txt",
                  verbose: int = 1, force_no_mersenne: bool = False,
                  prime_chunk: Optional[int] = None,
                  batch: Optional[int] = None, device: str = "cuda",
                  engine: str = "auto", cross: str = "inv",
                  replay: Optional[str] = None,
                  sharder: Optional[object] = None) -> RunResult:
    """Stage 2 (only) from a stage-1 savefile (tpu_ecm/driver.py:1032-1149,
    GMP-ECM's `ecm -resume`): every record's curve constant is rebuilt
    from its SIGMA, its X and Z are lifted into the engine's Montgomery
    form, the saved Z takes the leftover stage-1 gcd, and stage 2 runs to
    B2.  Records run in groups of `batch` curves (default: the RNS
    engine's card batch, rns_exec.default_batch, times the sharder's
    device count; the whole file on the digit engine), rounded down to a
    multiple of the device count; a sharded group is padded to whole
    shards by repeating its last record, as tpu_ecm pads (a repeated
    curve's find is reported once), and split over the sharder's devices.

    Records tagged PROGRAM=AVX-ECM-ED carry an Edwards seed: their curve
    is rebuilt by curve/edwards.py and stage 2 takes the Montgomery
    constant 1/(1+d) of the Edwards run's handoff (tpu_ecm rebuilds a
    Suyama curve from that seed, ROADMAP C.4).  A file that mixes inputs,
    bounds or program tags raises, as do B2 <= B1, a SIGMA <= 5 and a
    parameterization other than 0."""
    with open(path) as f:
        recs = list(savefile.parse_records(f))
    if not recs:
        raise ValueError(f"no savefile records in {path}")
    ns, b1s = {r.n for r in recs}, {r.b1 for r in recs}
    if len(ns) != 1 or len(b1s) != 1:
        raise ValueError(f"savefile mixes inputs/bounds: N x{len(ns)}, "
                         f"B1 x{len(b1s)}; split it first")
    n, b1 = ns.pop(), b1s.pop()
    if b2 <= b1:
        raise ValueError(f"B2 ({b2}) must exceed the savefile B1 ({b1})")
    if any(r.sigma <= 5 for r in recs):
        raise ValueError("record without a usable SIGMA; cannot rebuild "
                         "the curve constant")
    if any(r.param != 0 for r in recs):
        raise ValueError("only param-0 (sigma) records can be resumed; "
                         "this file uses another GMP-ECM parameterization")
    edwards_tag = {r.program == ED_PROGRAM for r in recs}
    if len(edwards_tag) != 1:
        raise ValueError(f"savefile mixes {ED_PROGRAM} records with other "
                         "programs' (Edwards and Suyama seeds); split it "
                         "first")
    curve_mode = "edwards" if edwards_tag.pop() else "suyama"

    d = ECMDriver(RunConfig(
        n=n, curves=len(recs), b1=b1, b2=b2, results_path=results_path,
        verbose=verbose, force_no_mersenne=force_no_mersenne,
        prime_chunk=prime_chunk, save_b1_path=None, checkpoint_path=None,
        stop_on_factor=False, curve_mode=curve_mode, device=device,
        engine=engine, cross=cross, replay=replay, sharder=sharder))
    if d._prp_input:
        return d.run()
    ctx = d.ctx
    ndev = len(d.devices)
    if batch is None:
        batch = (ndev * min(rns_exec.default_batch(dev) for dev in d.devices)
                 if d.engine == "rns" and d.device.type == "cuda"
                 else len(recs))
    batch = max(ndev, batch // ndev * ndev)
    build = (edwards.build_one_curve if curve_mode == "edwards"
             else suyama.build_one_curve)
    if verbose:
        print(f"resuming {len(recs)} curves from {path} (B1={b1}) into "
              f"stage 2 to B2={b2}"
              + (f" in groups of {batch}" if len(recs) > batch else ""))
    for base in range(0, len(recs), batch):
        group = recs[base:base + batch]
        group += [group[-1]] * (-len(group) % ndev)
        sigmas = [r.sigma for r in group]
        t0 = time.time()
        states = d._init_state([suyama.CurveInit(
            sigma=r.sigma, x_mont=ctx.to_mont_int(r.x % ctx.n_int),
            z_mont=ctx.to_mont_int(r.z % ctx.n_int),
            s_mont=build(ctx, r.sigma).s_mont) for r in group])
        d._add_time("build", t0)
        # leftover stage-1 factors first (gcd of the saved Z)
        d._check_batch([r.z for r in group], sigmas, 1, b1, base)
        d._run_stage2([st.pts[0] for st in states],
                      [st.s_const for st in states], sigmas, base)
    return RunResult(n=n, work_modulus=ctx.n_int, factors=d.factors,
                     curves_run=len(recs), stage1_residues=[],
                     timings=dict(d.timings), counters=dict(d.counters))
