"""Stage-2 execution: streamed baby-step table, global giant-step chain,
grouped batch inversion and pairmap replay — the twin of
tpu_ecm/stage2/exec.py in both its cross-product forms (`cross=`):

  inv    points normalized by batch inversion, one product a pair through
         the replay kernels below (the default)
  noinv  points kept projective as rows (X, Z, X*Z), no inversion, two
         products a pair, (Xa - Xb)(Za + Zb) + Xb*Zb - Xa*Za, replayed in
         512-entry segments multiplied in a pairwise tree
         (DigitOps.replay_segment_noinv); torch ops on the tensors' device,
         as tpu_ecm runs it on jnp: it has no Pallas kernel to port.  The
         digit engine only; an explicit replay= raises, since no replay
         kernel runs

The rest of this note is the inv form.

* The window-relative pairmap is flattened to GLOBAL giant-step indices
  (j = v - amin0 + U*s) so a prime chunk becomes one gather list; points are
  built in fixed-size groups on one differential-add chain (chain kernel).
* Montgomery's inversion trick runs on the device across each point group
  (prefix and apply kernels) and on the host across the curve batch: ONE
  modular inverse per group.  Only rows the replay or the table reads are
  inverted, so the gcd-harvest set is the same for any grouping.
* A curve whose Z-product is not invertible has gcd(Z..., N) > 1: that gcd
  is a factor, harvested like the reference's inversion-failure path.
* The replay acc *= Pa_inv[pa] - PbX[pb] runs in the replay kernel of the
  runner's `replay` mode; pbx[0] is the zero row and pa_ext[G] the
  Montgomery one, so a pad entry changes acc by a unit (digits: by one;
  RNS: by one + F, equal mod n).  The modes (replay_calls):

    stream  K5 / K15: packed pa << 16 | pb entries with a live count
    gather  K6 / K14: [T, 2] (pa, pb) pairs, REPLAY_E entries per step
            multiplied in a tree, padded with (G, 0) to whole steps
    parow   K7, digit engine only: steps [pa, pb_0..pb_{E-1}] sharing one
            Pa row, pb = 0 masked to one
    resident  K8, digit engine only: the entries partitioned by Pb slab
            of `slab_rows` rows, each slab's part in local rows and padded
            to whole steps; the kernel holds a slab in shared memory

  Each engine names its default (`default_replay`: the mode whose kernel
  is fastest per entry on the H100, PERF.md); `replay=` overrides it for
  tests and measurements, never the environment.  A mode the engine has no
  kernel for raises (tpu_ecm falls back to gather there).

The orchestration is engine-generic, as the JAX runner's is through `ops`:
DigitOps (digit planes [.., NW, B], kernels K1-K8) and RnsOps (residue
planes [.., 2K+1, B], kernels K10-K15) give it packing and the kernel
calls.  The plain versions of the kernels are beside their wrappers
(limbs/kernels.py, limbs/rns_kernels.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..params import MontyCtx

from ..curve import ops as curve_ops
from ..curve import prac
from ..limbs import kernels, layout, rns, rns_kernels, torch_ops
from ..limbs.torch_ops import DeviceCtx
from .plan import Stage2Params


# ---------------------------------------------------------------------------
# host batch inversion (one modular inverse for the whole curve batch)
# ---------------------------------------------------------------------------

def host_batch_inverse(ctx: MontyCtx, vals_mont: List[int],
                       premul: Optional[int] = None
                       ) -> Tuple[List[int], Dict[int, int]]:
    """Invert Montgomery-domain values sharing modulus N with one modinv.

    Input: canonical ints v_i = z_i * R mod N.  Output: device-pushable
    V_i = R^2 * v_i^-1 mod N (so mont_mul(X_m, V_i) = (x/z)*R mod N), plus
    {curve_index: factor} for curves with gcd(v_i, N) > 1 (factor == 0 when
    the gcd is trivial N itself); those curves get V_i = 0.  `premul`
    overrides the R^2 factor (the RNS engine passes P^2); a special-form
    context has no Montgomery factor, so its default is 1."""
    n = ctx.n_int
    if premul is not None:
        r2 = premul % n
    else:
        r2 = 1 if ctx.is_mersenne else (ctx.p.R * ctx.p.R) % n
    b = len(vals_mont)
    factors: Dict[int, int] = {}
    vals = [v % n for v in vals_mont]
    good = []
    for i in range(b):
        g = math.gcd(vals[i], n)
        if g == 1:
            good.append(i)
        else:
            factors[i] = 0 if g == n else g
    out = [0] * b
    if good:
        prefix = []
        acc = 1
        for i in good:
            acc = acc * vals[i] % n
            prefix.append(acc)
        inv = pow(acc, -1, n)
        for k in range(len(good) - 1, -1, -1):
            i = good[k]
            pre = prefix[k - 1] if k > 0 else 1
            out[i] = (r2 * (inv * pre % n)) % n
            inv = inv * vals[i] % n
    return out, factors


# ---------------------------------------------------------------------------
# engine adapters: packing and the five kernel calls of each representation
# ---------------------------------------------------------------------------

class DigitOps:
    """Digit planes [.., NW, B] on the runner's device (the twin of
    tpu_ecm's DigitOps); kernels K1-K8."""

    inv_premul = None                 # host_batch_inverse's R^2 default
    # replay mode -> the kernel it launches (kernels.KERNELS)
    replay_kernels = {"stream": "replay", "gather": "replay_gather",
                      "parow": "replay_parow", "resident": "replay_resident"}
    default_replay = "stream"

    def __init__(self, ctx: MontyCtx, dctx: DeviceCtx):
        self.ctx, self.dctx = ctx, dctx
        self.rows = ctx.p.nw
        self.device = dctx.device

    def one_plane(self, b: int) -> torch.Tensor:
        return torch.from_numpy(layout.broadcast_int(
            self.ctx.r_mod_n, self.ctx.p.w, self.ctx.p.nw, b)).to(
                self.device)

    def pack(self, ints: List[int]) -> torch.Tensor:
        return torch.from_numpy(layout.pack_batch(
            ints, self.ctx.p.w, self.ctx.p.nw)).to(self.device)

    def unpack(self, plane: torch.Tensor) -> List[int]:
        return layout.unpack_batch(plane.cpu().numpy(), self.ctx.p.w)

    def from_mont_int(self, v: int) -> int:
        return self.ctx.from_mont_int(v % self.ctx.n_int)

    def tape(self, pts, tape, s_const):
        return kernels.tape(pts, tape, s_const, self.dctx)

    def chain(self, p1, p2, pd, count):
        return kernels.chain(p1, p2, pd, count, self.dctx)

    def prefix(self, zs, one):
        return kernels.prefix(zs, one, self.dctx)

    def apply_inverse(self, xs, zs, pres, total_inv):
        return kernels.apply_inverse(xs, zs, pres, total_inv, self.dctx)

    # the replay of one call's index array (replay_calls) in each mode;
    # `one` is the one plane, which K7 takes for its pb = 0 pads
    def replay_stream(self, acc, pa_ext, pbx, idx, one):
        return kernels.replay(acc, pa_ext, pbx, idx, self.dctx)

    def replay_gather(self, acc, pa_ext, pbx, idx, one):
        return kernels.replay_gather(acc, pa_ext, pbx, idx, self.dctx,
                                     e=REPLAY_E)

    def replay_parow(self, acc, pa_ext, pbx, steps, one):
        return kernels.replay_parow(acc, pa_ext, pbx, steps, one, self.dctx)

    def replay_resident(self, acc, pa_ext, pbx, call, one):
        return kernels.replay_resident(acc, pa_ext, pbx, call.entries,
                                       call.slabs, call.cap, self.dctx,
                                       e=REPLAY_E)

    def slab_rows(self, b: int = 1) -> int:
        """K8's default slab height at B curves: on the card the tallest
        slab at which the launch's blocks are resident at once
        (kernels.resident_slab_rows), PLAIN_SLAB_ROWS on the CPU."""
        if self.device.type == "cuda":
            return kernels.resident_slab_rows(self.ctx.p.nw, b, self.device)
        return PLAIN_SLAB_ROWS

    # -- the noinv form: torch ops (tpu_ecm/stage2/exec.py:176-209) ------
    #
    # A batched product of K rows holds NW^2 product columns a row
    # (torch_ops._product_columns): 5.4 GB at NW=36, B=2048, 512 rows.  So
    # each product runs in slices of rows sized from the free memory;
    # a product is row-wise, so slicing changes no digit.

    # rows of one sliced product; None: what the card's free memory holds
    # (all rows on the CPU)
    row_slice: Optional[int] = None
    # the share of the card's free memory this ops may fill: 1/k when k
    # shards of a run share the device (driver.py; pa_group_for_ops)
    mem_share: float = 1.0

    def _rows_per_product(self, b: int) -> Optional[int]:
        if self.row_slice is not None:
            return self.row_slice
        if self.device.type != "cuda":
            return None
        nw = self.ctx.p.nw
        # the product columns and their sums, then REDC's copy and terms
        row_bytes = (nw * nw + 4 * nw) * b * 4
        return max(1, int(MEM_HEADROOM * self.mem_share
                          * device_free_bytes(self.device)) // row_bytes)

    def mul_planes(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Row-wise products of stacked planes [K, NW, B] (tpu_ecm's
        _mul_planes: operands pre-safe), in row slices."""
        k = int(a.shape[0])
        step = self._rows_per_product(int(a.shape[-1]))
        if step is None or step >= k:
            return torch_ops.mulmod(a, b, self.dctx, pre=True)
        return torch.cat([torch_ops.mulmod(a[i:i + step], b[i:i + step],
                                           self.dctx, pre=True)
                          for i in range(0, k, step)])

    def replay_segment_noinv(self, acc: torch.Tensor, pa_ext: torch.Tensor,
                             pbx: torch.Tensor, idx: np.ndarray
                             ) -> torch.Tensor:
        """acc *= prod (Xa*Zb - Xb*Za) over the [T, 2] (pa, pb) entries, T
        a power of two: each value (Xa - Xb)(Za + Zb) + Xb*Zb - Xa*Za from
        rows (X, Z, X*Z) of pa_ext [G+1, 3, NW, B] and pbx [num_pb, 3, NW,
        B], the values multiplied as a pairwise tree, the root into acc
        last.  A pad entry (G, 0) reads (one, one, 0) and (0, 0, 0): its
        value is one.  tpu_ecm's _replay_segment_noinv, digit for digit."""
        rows = torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(
            acc.device)
        pa = pa_ext.index_select(0, rows[:, 0])
        pb = pbx.index_select(0, rows[:, 1])
        d = self.dctx
        t1 = torch_ops.submod_n(pa[:, 0], pb[:, 0], d)
        t2 = torch_ops.addmod_n(pa[:, 1], pb[:, 1], d)
        t3 = self.mul_planes(t1, t2)
        del t1, t2
        vals = torch_ops.submod_n(torch_ops.addmod_n(t3, pb[:, 2], d),
                                  pa[:, 2], d)
        del pa, pb, t3
        t = int(vals.shape[0])
        while t > 1:
            half = t // 2
            vals = self.mul_planes(vals[:half], vals[half:t])
            t = half
        return torch_ops.mulmod(acc, vals[0], d)


class RnsOps:
    """Residue planes [.., 2K+1, B] (the twin of rns_exec.RnsOps); kernels
    K10-K15 (no shared-Pa-row replay: tpu_ecm has none for RNS)."""

    replay_kernels = {"stream": "rns_replay", "gather": "rns_replay_gather"}
    # K15 takes 80% of K14's time a live entry on the rns job's first call
    # (K=200, B=1024; PERF.md), as tpu_ecm streams (rns_exec.py:772)
    default_replay = "stream"
    # the share of the card's free memory (DigitOps.mem_share)
    mem_share: float = 1.0

    def __init__(self, host: rns.RnsHost, rc: rns.RnsCtx):
        self.host, self.rc = host, rc
        self.ctx = host.ctx
        self.rows = host.rows
        self.device = rc.device
        # mont_mul(X, P^2 * v^-1) = (x/v) * P: the RNS analogue of the
        # digit engine's R^2 premultiplier
        self.inv_premul = host.P * host.P

    def one_plane(self, b: int) -> torch.Tensor:
        return self.pack([self.host.to_mont_int(1)] * b)

    def pack(self, ints: List[int]) -> torch.Tensor:
        return torch.from_numpy(self.host.pack(ints)).to(self.device)

    def unpack(self, plane: torch.Tensor) -> List[int]:
        return self.host.unpack(plane.cpu().numpy())

    def from_mont_int(self, v: int) -> int:
        return self.host.from_mont_int(v % self.ctx.n_int)

    def tape(self, pts, tape, s_const):
        return rns_kernels.tape(pts, tape, s_const, self.rc)

    def chain(self, p1, p2, pd, count):
        return rns_kernels.chain(p1, p2, pd, count, self.rc)

    def prefix(self, zs, one):
        return rns_kernels.prefix(zs, one, self.rc)

    def apply_inverse(self, xs, zs, pres, total_inv):
        return rns_kernels.apply_inverse(xs, zs, pres, total_inv, self.rc)

    def replay_stream(self, acc, pa_ext, pbx, idx, one):
        return rns_kernels.replay(acc, pa_ext, pbx, idx, self.rc)

    def replay_gather(self, acc, pa_ext, pbx, idx, one):
        return rns_kernels.replay_gather(acc, pa_ext, pbx, idx, self.rc,
                                         e=REPLAY_E)


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stage2Result:
    acc: List[int]                  # canonical accumulator per curve (mod n)
    factors: Dict[int, int]         # curve -> factor found during inversions
    paired: int
    slots: int                      # replay entry slots, pads included
    ptadds: int
    ptdups: int
    numinv: int
    # curve -> the count of host inversions when its factor was found (the
    # order a runner met the finds, for merging shards in curve order)
    found_at: Dict[int, int] = dataclasses.field(default_factory=dict)


# Pa group rows and replay entries per kernel call, by device kind.  The
# CPU pair is the JAX package's CPU pair (so the tests compare like with
# like).  On CUDA the group is the largest power of two up to
# PA_GROUP["cuda"] that fits the card's free memory (pa_group_for_memory,
# device_free_bytes);
# the replay block, the most entries of one kernel call, is fixed here,
# not tuned (PERF.md).
PA_GROUP = {"cpu": 512, "cuda": 4096}
REPLAY_BLOCK = {"cpu": 4096, "cuda": 1 << 16}
# the replay modes (an engine's ops name the kernel of each they have);
# entries per step of the gather, parow and resident modes (tpu_ecm's
# _replay_e(16) default; every replay block is a multiple of it)
REPLAY_MODES = ("stream", "gather", "parow", "resident")
REPLAY_E = 16
# the cross-product forms, and the noinv segment: entries a tree product
# (tpu_ecm's _replay_noinv), padded with (G, 0) to a power of two
CROSS_FORMS = ("inv", "noinv")
NOINV_SEGMENT = 512
# K8's slab height on the CPU, where no shared memory bounds the plain
# version: small, so that CPU runs cut their Pb tables into several slabs
PLAIN_SLAB_ROWS = 16
# planes live per Pa group row at the peak of a group: the chain output
# (2), the contiguous x and z stacks (2), prefix, shifted prefix, apply
# output and the extended inverse table
GROUP_PLANES = 8
# the smallest group the memory rule takes, and the share of the free
# bytes it plans to fill (the rest is allocator slack)
PA_GROUP_MIN = 64
MEM_HEADROOM = 0.9


def device_free_bytes(device) -> int:
    """Bytes a new allocation on the card can take: the driver's free
    memory and what the caching allocator holds reserved but unused, so
    the memory rule gives a job the same Pa group whatever ran before it
    in the process."""
    free, _total = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def pa_group_for_memory(plane_bytes: int, num_pb: int, free_bytes: int,
                        g_max: int = PA_GROUP["cuda"],
                        planes: int = 1) -> int:
    """The largest power of two G <= g_max for which the Pb table and
    GROUP_PLANES * G rows fit MEM_HEADROOM of the free bytes, with
    `planes` planes a Pb row and a Pa row (1 inv, 3 noinv: X, Z, X*Z);
    raises when even PA_GROUP_MIN rows do not fit."""
    plane_bytes *= planes
    budget = MEM_HEADROOM * free_bytes - num_pb * plane_bytes
    g = g_max
    while g > PA_GROUP_MIN and GROUP_PLANES * g * plane_bytes > budget:
        g //= 2
    if GROUP_PLANES * g * plane_bytes > budget:
        need = (num_pb + GROUP_PLANES * g) * plane_bytes
        raise RuntimeError(
            f"stage 2 needs ~{need / 2**30:.2f} GiB (Pb table of {num_pb} "
            f"rows + Pa group of {g} rows) but {free_bytes / 2**30:.2f} GiB "
            "are free; run fewer curves per batch")
    return g


def replay_mode(mode: Optional[str], ops, cross: str = "inv"
                ) -> Optional[str]:
    """The replay mode a runner on `ops` takes for `mode` (None: the
    engine's default) in the cross-product form `cross` (CROSS_FORMS);
    raises unless the engine has a kernel for it.  Under noinv, which
    replays through torch ops, None; it raises on an engine without it
    (RNS, as in tpu_ecm) and for an explicit mode (tpu_ecm ignores the
    mode there; ROADMAP C.3)."""
    if cross not in CROSS_FORMS:
        raise ValueError(f"unknown cross-product form {cross!r}; expected "
                         f"one of {CROSS_FORMS}")
    if cross == "noinv":
        if not hasattr(ops, "replay_segment_noinv"):
            raise ValueError("cross='noinv' requires the digit engine")
        if mode is not None:
            raise ValueError(f"cross='noinv' runs no replay kernel; "
                             f"replay={mode!r} does not apply")
        return None
    if mode is None:
        return ops.default_replay
    if mode not in REPLAY_MODES:
        raise ValueError(f"unknown replay mode {mode!r}; expected one of "
                         f"{REPLAY_MODES}")
    if mode not in ops.replay_kernels:
        raise ValueError(f"replay={mode!r} has no kernel on the "
                         f"{type(ops).__name__} engine")
    return mode


def pack_parow_steps(idx: np.ndarray, e: int) -> np.ndarray:
    """[T, 2] v-sorted entries -> [S, 1+E] parow steps: runs of equal Pa
    row split into ceil(run/E)-step groups, short tails padded with pb = 0
    (masked to one in kernel).  Packing efficiency is T / (S*E)
    (tpu_ecm/stage2/exec.py:1065-1085)."""
    pa = idx[:, 0].astype(np.int64)
    pb = idx[:, 1].astype(np.int32)
    uniq, start, counts = np.unique(pa, return_index=True,
                                    return_counts=True)
    nsteps_per = -(-counts // e)
    total = int(nsteps_per.sum())
    steps = np.zeros((total, 1 + e), dtype=np.int32)
    steps[:, 0] = np.repeat(uniq, nsteps_per)
    ranks = (np.arange(idx.shape[0], dtype=np.int64)
             - np.repeat(start, counts))
    sbase = np.concatenate([[0], np.cumsum(nsteps_per)[:-1]])
    estep = np.repeat(sbase, counts) + ranks // e
    steps[estep, 1 + (ranks % e)] = pb
    return steps


class SlabCall(NamedTuple):
    """The arguments of one K8 call: entries [T, 2] (pa, local slab row),
    its slab segments [S, 3] (lo, first step, steps) and the slab
    height."""
    entries: np.ndarray
    slabs: np.ndarray
    cap: int


def slab_segments(idx: np.ndarray, cap: int, g: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The v-sorted [T, 2] (pa, pb) entries of a Pa group of g rows,
    partitioned by Pb slab as tpu_ecm's _replay_resident partitions them
    (exec.py:1037-1063): slab h holds pbx rows [h*cap, (h+1)*cap); its
    entries, slab after slab and in v-order within each, get the local row
    pb - h*cap + 1, and each slab's part is padded with (g, 0) to whole
    REPLAY_E-entry steps.  Returns (entries [T', 2], segments [S, 3] of
    (lo, first step, steps)), int32."""
    e = REPLAY_E
    h = idx[:, 1].astype(np.int64) // cap
    order = np.argsort(h, kind="stable")
    hs = h[order]
    ent = idx[order].astype(np.int32)
    ent[:, 1] -= (hs * cap - 1).astype(np.int32)
    heads, starts, counts = np.unique(hs, return_index=True,
                                      return_counts=True)
    steps = -(-counts // e)
    first = np.concatenate([[0], np.cumsum(steps)[:-1]])
    out = np.tile(np.asarray([[g, 0]], np.int32), (int(steps.sum()) * e, 1))
    out[np.repeat(first * e - starts, counts) + np.arange(ent.shape[0])] = ent
    return out, np.stack([heads * cap, first, steps], 1).astype(np.int32)


def replay_calls(mode: str, idx: np.ndarray, block: int, g: int,
                 cap: Optional[int] = None):
    """(call, entry slots) of each kernel call that replays the v-sorted
    [T, 2] int32 (pa, pb) entries of one Pa group of g rows in `mode`, each
    call at most `block` entries (a multiple of REPLAY_E); the slots are
    the entries the kernel steps through, pads included:

      stream    [count, pa << 16 | pb, ...]
      gather    [T', 2] pairs, the last call padded with (g, 0) to whole
                steps of REPLAY_E entries
      parow     [S', 1 + REPLAY_E] steps of pack_parow_steps (S' * E slots)
      resident  SlabCall: slab_segments' entries with slabs of cap rows,
                cut into calls at step boundaries, each with the segments
                it holds

    tpu_ecm pads every call to the whole block (exec.py:1087-1106,
    1214-1222), the fixed shape of its Pallas kernels; the CUDA kernels
    take their length at run time, so no call runs a pad step."""
    if mode == "stream":
        packed = ((idx[:, 0].astype(np.int64) << 16)
                  | idx[:, 1].astype(np.int64)).astype(np.int32)
        for lo in range(0, packed.shape[0], block):
            blk = packed[lo:lo + block]
            yield (np.concatenate([np.asarray([blk.shape[0]], np.int32),
                                   blk]), blk.shape[0])
        return
    if mode == "resident":
        ent, segs = slab_segments(idx, cap, g)
        e, total = REPLAY_E, ent.shape[0] // REPLAY_E
        seg_end = segs[:, 1] + segs[:, 2]
        for a in range(0, total, block // e):
            b = min(a + block // e, total)
            s0 = np.maximum(segs[:, 1], a)
            s1 = np.minimum(seg_end, b)
            held = s1 > s0
            tab = np.stack([segs[held, 0], s0[held] - a, (s1 - s0)[held]],
                           1).astype(np.int32)
            yield SlabCall(ent[a * e:b * e], tab, cap), (b - a) * e
        return
    if mode == "gather":
        arr = np.concatenate([idx, np.tile(np.asarray([[g, 0]], np.int32),
                                           (-idx.shape[0] % REPLAY_E, 1))])
        per = 1
    else:
        arr, block = pack_parow_steps(idx, REPLAY_E), block // REPLAY_E
        per = REPLAY_E
    for lo in range(0, arr.shape[0], block):
        blk = arr[lo:lo + block]
        yield blk, per * blk.shape[0]


def entries_global(sp: Stage2Params, map_v: np.ndarray, map_u: np.ndarray,
                   amin0: int) -> np.ndarray:
    """Pairmap -> [T, 2] int64 (global Pa index j, Pb storage index),
    sorted by j (stably)."""
    v = map_v.astype(np.int64)
    u = map_u.astype(np.int64)
    sent = (v == 0) & (u == 0)
    shifts = np.cumsum(sent)                 # s at each position
    keep = ~sent
    j = v[keep] - amin0 + sp.U * shifts[keep]
    win_lo = 2 * sp.U * shifts[keep]
    if j.size and not ((j >= win_lo).all()
                       and (j < win_lo + 2 * sp.L).all()):
        raise ValueError("pairmap v outside its window")
    pb = sp.rprime_map[u[keep]].astype(np.int64)
    if not (pb > 0).all():
        raise ValueError("pairmap u outside the stored baby steps")
    entries = np.stack([j, pb], axis=1)
    return entries[np.argsort(entries[:, 0], kind="stable")]


def pa_group_for_ops(ops, sp: Stage2Params, b: int,
                     cross: str = "inv") -> int:
    """The memory rule's Pa group for a runner of ops at b curves on the
    card: pa_group_for_memory over ops' share of its device's free bytes
    (shards of a run on one device share them, ops.mem_share)."""
    return pa_group_for_memory(
        ops.rows * b * 4, sp.num_pb,
        int(ops.mem_share * device_free_bytes(ops.device)),
        planes=3 if cross == "noinv" else 1)


class Stage2Runner:
    """Per-batch stage-2 state machine (phases 2+3 of vececm)."""

    def __init__(self, ctx: MontyCtx, dctx: Optional[DeviceCtx],
                 sp: Stage2Params, pt: torch.Tensor, s_const: torch.Tensor,
                 ops=None, replay: Optional[str] = None,
                 slab_rows: Optional[int] = None, cross: str = "inv",
                 pa_group: Optional[int] = None):
        self.ctx, self.sp = ctx, sp
        self.ops = ops if ops is not None else DigitOps(ctx, dctx)
        self.replay = replay_mode(replay, self.ops, cross)
        self.cross = cross
        self.pt = pt                  # stage-1 point [2, rows, B]
        self.s_const = s_const
        self.b = b = int(pt.shape[-1])
        # K8's Pb rows per slab: the keyword (tests cut many slabs) or the
        # device's rule at this batch (DigitOps.slab_rows)
        self.slab_rows = None
        if self.replay == "resident":
            self.slab_rows = slab_rows or self.ops.slab_rows(b)
        kind = pt.device.type
        if kind not in PA_GROUP:
            raise ValueError(f"stage 2 runs on cpu or cuda, not {pt.device}")
        self.pa_group = PA_GROUP[kind]
        self.replay_block = REPLAY_BLOCK[kind]
        if pa_group is not None:
            # the driver's group for every shard of a batch
            self.pa_group = pa_group
        elif kind == "cuda":
            self.pa_group = pa_group_for_ops(self.ops, sp, b, cross)
        # replay entries pack pa << 16 | pb
        if self.pa_group + 1 > 1 << 16 or sp.num_pb > 1 << 16:
            raise ValueError("Pa group or Pb table exceeds 2^16 rows")
        self.one_plane = self.ops.one_plane(b)
        # the row past a Pa group's rows that pad entries (G, 0) read: the
        # Montgomery one (inv), (one, one, 0) (noinv)
        self.pad_row = self.one_plane
        if cross == "noinv":
            self.pad_row = torch.stack([self.one_plane, self.one_plane,
                                        torch.zeros_like(self.one_plane)])
        self.acc = self.one_plane     # mdata->one init
        self.factors: Dict[int, int] = {}
        self.found_at: Dict[int, int] = {}
        self.paired = 0
        self.slots = 0
        self.ptadds = 0
        self.ptdups = 0
        self.numinv = 0
        self.pbx: Optional[torch.Tensor] = None
        self.pd: Optional[torch.Tensor] = None

    def _count_tape(self, tape: np.ndarray):
        """ADD/DUP op counters for a host-planned tape."""
        if tape.shape[0]:
            opc = np.asarray(tape)[:, 0]
            self.ptadds += int(np.count_nonzero(opc == curve_ops.OP_ADD))
            self.ptdups += int(np.count_nonzero(opc == curve_ops.OP_DUP))

    def _run_tape(self, pt: torch.Tensor, tape: np.ndarray) -> torch.Tensor:
        """Point file with pt in slot 0 after replaying tape (stage-1
        kernel)."""
        pts = torch.zeros((curve_ops.NUM_SLOTS,) + tuple(pt.shape),
                          dtype=torch.int32, device=pt.device)
        pts[0] = pt
        if tape.shape[0]:
            self.ops.tape(pts, tape, self.s_const)
        return pts

    def _ladder(self, pt: torch.Tensor, k: int) -> torch.Tensor:
        """[k]P by a host-planned binary-ladder tape."""
        tape, res_slot = prac.ladder_tape_result_slot(k)
        self._count_tape(tape)
        return self._run_tape(pt, tape)[res_slot]

    # -- inversion helpers ------------------------------------------------

    def _harvest_inverse(self, total_plane: torch.Tensor) -> torch.Tensor:
        """ONE host modinv for a prefix-product total; harvests
        inversion-failure gcds into self.factors.  Returns the packed
        total-inverse plane."""
        self.numinv += 1
        inv_ints, fnd = host_batch_inverse(self.ctx,
                                           self.ops.unpack(total_plane),
                                           premul=self.ops.inv_premul)
        for i, f in fnd.items():
            if f and i not in self.factors:
                self.factors[i] = f
                self.found_at[i] = self.numinv
        return self.ops.pack(inv_ints)

    def _invert_steps(self, xs: torch.Tensor, zs: torch.Tensor):
        """x_i/z_i in Montgomery form for stacked planes [K, rows, B]; one
        host modinv for the whole (K x B) block.  A generator of steps
        (its value the rows): like every step generator of the runner, it
        yields after each launch that its next host crossing would wait
        on (here the prefix before the modinv, the apply before the next
        copy of host data to the device, which waits on the stream), so
        that a driver can launch the other shards' kernels there
        (driver.run_steps)."""
        xs, zs = xs.contiguous(), zs.contiguous()
        prefix = self.ops.prefix(zs, self.one_plane)
        yield
        total_inv = self._harvest_inverse(prefix[-1])
        pres = torch.cat([self.one_plane[None], prefix[:-1]], dim=0)
        rows = self.ops.apply_inverse(xs, zs, pres, total_inv)
        yield
        return rows

    def _table_rows(self, xs: torch.Tensor, zs: torch.Tensor):
        """Pb table rows of the points (xs, zs) [K, rows, B]: x/z (inv) or
        (X, Z, X*Z) [K, 3, rows, B] (noinv, no host crossing), as
        _invert_steps' generator."""
        if self.cross == "noinv":
            return torch.stack([xs, zs, self.ops.mul_planes(xs, zs)], dim=1)
        return (yield from self._invert_steps(xs, zs))

    # -- phase 2: init ----------------------------------------------------

    def init(self):
        """Phase 2 in one go (init_steps)."""
        for _ in self.init_steps():
            pass
        return self

    def init_steps(self):
        """Build the affine-x baby-step table pbx [num_pb, rows, B]: the
        chain S_d = S_{d-1} + Q (diff S_{d-2}) in groups of G points; each
        group's stored rows (rprime_map) are batch-inverted and scattered
        into pbx, so the full [U*D, 2, rows, B] chain never exists.

        Under noinv the table keeps projective rows (X, Z, X*Z) [num_pb,
        3, rows, B], row 0 all zeros, and nothing is inverted
        (tpu_ecm's _init_noinv).  A generator of steps (_invert_steps)."""
        sp = self.sp
        q1 = self.pt
        dup = np.asarray([[curve_ops.OP_DUP, 1, 0, 0, 0]], dtype=np.int32)
        q2 = self._run_tape(q1, dup)[1]
        self.ptdups += 1
        noinv = self.cross == "noinv"
        pbx = torch.zeros((sp.num_pb,) + ((3,) if noinv else ())
                          + (self.ops.rows, self.b),
                          dtype=torch.int32, device=q1.device)
        pbx[1:3] = yield from self._table_rows(torch.stack([q1[0], q2[0]]),
                                               torch.stack([q1[1], q2[1]]))
        G = self.pa_group
        p_last, p_prev = q2, q1
        for base in range(3, sp.umax + 1, G):
            cnt = min(G, sp.umax + 1 - base)
            group = self.ops.chain(p_last, p_prev, q1, G)
            yield
            p_last, p_prev = group[-1], group[-2]
            slots = sp.rprime_map[base:base + cnt].astype(np.int64)
            sel = np.nonzero(slots)[0]
            if sel.size == 0:
                continue
            rows = torch.from_numpy(sel).to(q1.device)
            table = yield from self._table_rows(group[rows, 0],
                                                group[rows, 1])
            pbx[torch.from_numpy(slots[sel]).to(q1.device)] = table
        self.pbx = pbx                # row 0 stays the zero row
        self.ptadds += sp.umax - 2
        # Pd = [D]Q (not inverted)
        self.pd = self._ladder(self.pt, sp.D)

    # -- phase 3: per-chunk pairmap replay ---------------------------------
    #
    # The executor contract (amin advances by U per (0,0) sentinel, local
    # index v - amin into a 2L window of points spaced D apart) is
    # flattened to one global giant-step index
    #
    #     j = (v - amin_s) + 2*U*s = v - amin0 + U*s,   Pa[j] = [(2*amin0+j)*D]Q
    #
    # so a chunk's pairmap becomes one list of (j, pb) entries whose product
    # order is irrelevant.  Points are built once, in groups of G, each
    # group batch-inverted with ONE host modinv for the whole block.

    def run_chunk(self, map_v: np.ndarray, map_u: np.ndarray, amin0: int):
        """Replay one chunk's pairmap (built by plan.pair for this chunk)
        in one go (chunk_steps)."""
        for _ in self.chunk_steps(map_v, map_u, amin0):
            pass

    def chunk_steps(self, map_v: np.ndarray, map_u: np.ndarray, amin0: int):
        """run_chunk as a generator of steps (_invert_steps)."""
        sp = self.sp
        entries = entries_global(sp, map_v, map_u, amin0)
        if entries.shape[0] == 0:
            return
        max_j = int(entries[-1, 0])
        G = self.pa_group

        # chain seeds.  Pa_global[j] = [(2*amin0 + j) * D]Q = [2*amin0 + j]Pd,
        # so ONE ladder over Pd for k = 2*amin0 - 2 yields both seeds
        # ([k]Pd, [k+1]Pd) = (global[-2], global[-1]) and every group is a
        # uniform G-step extension.
        k = 2 * amin0 - 2
        pending = None
        if k >= 1:
            tape, lo, hi = prac.ladder_pair_tape(k)
            self._count_tape(tape)
            pts = self._run_tape(self.pd, tape)
            p_prev, p_last = pts[lo], pts[hi]
        else:
            # amin0 <= 1: [2*amin0-2]Pd would be the point at infinity; seed
            # from Q ladders and fold Pa[0] in as the first group row
            a_val = 2 * amin0 * sp.D
            p_last = self._ladder(self.pt, a_val)            # global[0]
            p_prev = self._ladder(self.pt, a_val - sp.D)     # global[-1]
            pending = p_last

        pos = 0
        base = 0
        while base <= max_j:
            hi = int(np.searchsorted(entries[:, 0], base + G))
            if pending is not None:
                rest = self.ops.chain(p_last, p_prev, self.pd, G - 1)
                group = torch.cat([pending[None], rest], dim=0)
                pending = None
                self.ptadds += G - 1
            else:
                group = self.ops.chain(p_last, p_prev, self.pd, G)
                self.ptadds += G
            p_last, p_prev = group[-1], group[-2]

            if hi > pos:
                idx = np.stack([entries[pos:hi, 0] - base,
                                entries[pos:hi, 1]], axis=1).astype(np.int32)
                # rows past max_j are never paired: inverting only the
                # rows below keeps the harvest set independent of G
                valid = min(max_j - base + 1, G)
                rows = yield from self._table_rows(group[:valid, 0],
                                                   group[:valid, 1])
                pad = self.pad_row[None].expand(
                    (G + 1 - valid,) + tuple(self.pad_row.shape))
                yield from self._replay(torch.cat([rows, pad], dim=0), idx)
                self.paired += int(idx.shape[0])
                pos = hi
            base += G

    def _replay(self, pa_ext: torch.Tensor, idx: np.ndarray):
        """acc *= prod (Pa_inv[v] - PbX[u]) over the v-sorted [T, 2] entry
        list, through the kernel of the runner's replay mode (noinv:
        _replay_noinv); steps of a launch each (_invert_steps)."""
        if self.cross == "noinv":
            yield from self._replay_noinv(pa_ext, idx)
            return
        launch = getattr(self.ops, "replay_" + self.replay)
        for arr, slots in replay_calls(self.replay, idx, self.replay_block,
                                       self.pa_group, self.slab_rows):
            self.acc = launch(self.acc, pa_ext, self.pbx, arr,
                              self.one_plane)
            self.slots += slots
            yield

    def _replay_noinv(self, pa_ext: torch.Tensor, idx: np.ndarray):
        """acc *= prod (Xa*Zb - Xb*Za) over the v-sorted [T, 2] entries,
        pa_ext [G+1, 3, rows, B] the group's rows (X, Z, X*Z) and pad
        rows: NOINV_SEGMENT-entry segments, each padded with (G, 0) to a
        power of two (tpu_ecm's _replay_noinv)."""
        G = self.pa_group
        for lo in range(0, idx.shape[0], NOINV_SEGMENT):
            blk = idx[lo:lo + NOINV_SEGMENT]
            tpad = 1 << max(0, (blk.shape[0] - 1).bit_length())
            blk = np.concatenate([blk, np.tile(np.asarray([[G, 0]], np.int32),
                                               (tpad - blk.shape[0], 1))])
            self.acc = self.ops.replay_segment_noinv(self.acc, pa_ext,
                                                     self.pbx, blk)
            self.slots += tpad
            yield

    # -- harvest ----------------------------------------------------------

    def result(self) -> Stage2Result:
        accs = [self.ops.from_mont_int(a)
                for a in self.ops.unpack(self.acc)]
        return Stage2Result(acc=accs, factors=dict(self.factors),
                            paired=self.paired, slots=self.slots,
                            ptadds=self.ptadds,
                            ptdups=self.ptdups, numinv=self.numinv,
                            found_at=dict(self.found_at))
