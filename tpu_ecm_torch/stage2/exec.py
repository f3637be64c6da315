"""Stage-2 execution: streamed baby-step table, global giant-step chain,
grouped batch inversion and pairmap replay — the twin of
tpu_ecm/stage2/exec.py in its inverted cross form.

* The window-relative pairmap is flattened to GLOBAL giant-step indices
  (j = v - amin0 + U*s) so a prime chunk becomes one gather list; points are
  built in fixed-size groups on one differential-add chain (kernel K2).
* Montgomery's inversion trick runs on the device across each point group
  (prefix K3, apply K4) and on the host across the curve batch: ONE modular
  inverse per group.  Only rows the replay or the table reads are inverted,
  so the gcd-harvest set is the same for any grouping.
* A curve whose Z-product is not invertible has gcd(Z..., N) > 1: that gcd
  is a factor, harvested like the reference's inversion-failure path.
* The replay acc *= Pa_inv[pa] - PbX[pb] runs in kernel K5; pbx[0] is the
  zero row and pa_ext[G] the Montgomery one, so a pad entry is a no-op.

The plain versions of K2-K5 (what the kernels' wrappers run for CPU
tensors) are in limbs/kernels.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_ecm.params import MontyCtx

from ..curve import ops as curve_ops
from ..curve import prac
from ..limbs import kernels, layout
from ..limbs.torch_ops import DeviceCtx
from .plan import Stage2Params


# ---------------------------------------------------------------------------
# host batch inversion (one modular inverse for the whole curve batch)
# ---------------------------------------------------------------------------

def host_batch_inverse(ctx: MontyCtx, vals_mont: List[int]
                       ) -> Tuple[List[int], Dict[int, int]]:
    """Invert Montgomery-domain values sharing modulus N with one modinv.

    Input: canonical ints v_i = z_i * R mod N.  Output: device-pushable
    V_i = R^2 * v_i^-1 mod N (so mont_mul(X_m, V_i) = (x/z)*R mod N), plus
    {curve_index: factor} for curves with gcd(v_i, N) > 1 (factor == 0 when
    the gcd is trivial N itself); those curves get V_i = 0."""
    n = ctx.n_int
    r2 = (ctx.p.R * ctx.p.R) % n
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
# digit-plane representation behind one object
# ---------------------------------------------------------------------------

class TorchDigitOps:
    """Packing between canonical integers and digit planes on the runner's
    device (the twin of tpu_ecm's DigitOps; an RNS engine would be a
    second adapter)."""

    def __init__(self, ctx: MontyCtx, dctx: DeviceCtx):
        self.ctx, self.dctx = ctx, dctx

    def one_plane(self, b: int) -> torch.Tensor:
        return torch.from_numpy(layout.broadcast_int(
            self.ctx.r_mod_n, self.ctx.p.w, self.ctx.p.nw, b)).to(
                self.dctx.device)

    def pack(self, ints: List[int]) -> torch.Tensor:
        return torch.from_numpy(layout.pack_batch(
            ints, self.ctx.p.w, self.ctx.p.nw)).to(self.dctx.device)

    def unpack(self, plane: torch.Tensor) -> List[int]:
        return layout.unpack_batch(plane.cpu().numpy(), self.ctx.p.w)

    def from_mont_int(self, v: int) -> int:
        return self.ctx.from_mont_int(v % self.ctx.n_int)


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stage2Result:
    acc: List[int]                  # canonical accumulator per curve (mod n)
    factors: Dict[int, int]         # curve -> factor found during inversions
    paired: int
    ptadds: int
    ptdups: int
    numinv: int


# Pa group rows and replay entries per kernel call, by device kind.  The
# CPU pair is the JAX package's CPU pair (so the tests compare like with
# like); the CUDA pair is fixed here, not tuned (PERF.md).
PA_GROUP = {"cpu": 512, "cuda": 4096}
REPLAY_BLOCK = {"cpu": 4096, "cuda": 1 << 16}
# [NW, B] planes live per Pa group row at the peak of a group: the chain
# output (2), the contiguous x and z stacks (2), prefix, shifted prefix,
# apply output and the extended inverse table
GROUP_PLANES = 8


class Stage2Runner:
    """Per-batch stage-2 state machine (phases 2+3 of vececm)."""

    def __init__(self, ctx: MontyCtx, dctx: DeviceCtx, sp: Stage2Params,
                 pt: torch.Tensor, s_const: torch.Tensor):
        self.ctx, self.dctx, self.sp = ctx, dctx, sp
        self.ops = TorchDigitOps(ctx, dctx)
        self.pt = pt                  # stage-1 point [2, NW, B]
        self.s_const = s_const
        self.b = b = int(pt.shape[-1])
        kind = pt.device.type
        if kind not in PA_GROUP:
            raise ValueError(f"stage 2 runs on cpu or cuda, not {pt.device}")
        self.pa_group = PA_GROUP[kind]
        self.replay_block = REPLAY_BLOCK[kind]
        # replay entries pack pa << 16 | pb
        if self.pa_group + 1 > 1 << 16 or sp.num_pb > 1 << 16:
            raise ValueError("Pa group or Pb table exceeds 2^16 rows")
        if kind == "cuda":
            self._check_memory()
        self.one_plane = self.ops.one_plane(b)
        self.acc = self.one_plane     # mdata->one init
        self.factors: Dict[int, int] = {}
        self.paired = 0
        self.ptadds = 0
        self.ptdups = 0
        self.numinv = 0
        self.pbx: Optional[torch.Tensor] = None
        self.pd: Optional[torch.Tensor] = None

    def _check_memory(self):
        """Raise unless the Pb table and one Pa group's transients fit the
        card's free memory."""
        row = self.ctx.p.nw * self.b * 4
        need = (self.sp.num_pb + GROUP_PLANES * self.pa_group) * row
        free, _total = torch.cuda.mem_get_info(self.pt.device)
        if need > free:
            raise RuntimeError(
                f"stage 2 needs ~{need / 2**30:.2f} GiB (Pb table of "
                f"{self.sp.num_pb} rows + Pa group of {self.pa_group} rows) "
                f"but {free / 2**30:.2f} GiB are free on {self.pt.device}; "
                "run fewer curves per batch")

    def _count_tape(self, tape: np.ndarray):
        """ADD/DUP op counters for a host-planned tape."""
        if tape.shape[0]:
            opc = np.asarray(tape)[:, 0]
            self.ptadds += int(np.count_nonzero(opc == curve_ops.OP_ADD))
            self.ptdups += int(np.count_nonzero(opc == curve_ops.OP_DUP))

    def _run_tape(self, pt: torch.Tensor, tape: np.ndarray) -> torch.Tensor:
        """Point file with pt in slot 0 after replaying tape (kernel K1)."""
        pts = torch.zeros((curve_ops.NUM_SLOTS,) + tuple(pt.shape),
                          dtype=torch.int32, device=pt.device)
        pts[0] = pt
        if tape.shape[0]:
            kernels.tape(pts, tape, self.s_const, self.dctx)
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
                                           self.ops.unpack(total_plane))
        for i, f in fnd.items():
            if f and i not in self.factors:
                self.factors[i] = f
        return self.ops.pack(inv_ints)

    def _invert_planes(self, xs: torch.Tensor, zs: torch.Tensor
                       ) -> torch.Tensor:
        """x_i/z_i in Montgomery form for stacked planes [K, NW, B]; one host
        modinv for the whole (K x B) block."""
        xs, zs = xs.contiguous(), zs.contiguous()
        prefix = kernels.prefix(zs, self.one_plane, self.dctx)
        total_inv = self._harvest_inverse(prefix[-1])
        pres = torch.cat([self.one_plane[None], prefix[:-1]], dim=0)
        return kernels.apply_inverse(xs, zs, pres, total_inv, self.dctx)

    # -- phase 2: init ----------------------------------------------------

    def init(self):
        """Build the affine-x baby-step table pbx [num_pb, NW, B]: the chain
        S_d = S_{d-1} + Q (diff S_{d-2}) in groups of G points; each group's
        stored rows (rprime_map) are batch-inverted and scattered into
        pbx, so the full [U*D, 2, NW, B] chain never exists."""
        sp = self.sp
        q1 = self.pt
        dup = np.asarray([[curve_ops.OP_DUP, 1, 0, 0, 0]], dtype=np.int32)
        q2 = self._run_tape(q1, dup)[1]
        self.ptdups += 1
        inv12 = self._invert_planes(torch.stack([q1[0], q2[0]]),
                                    torch.stack([q1[1], q2[1]]))
        nw = self.ctx.p.nw
        pbx = torch.zeros((sp.num_pb, nw, self.b), dtype=torch.int32,
                          device=q1.device)
        pbx[1:3] = inv12
        G = self.pa_group
        p_last, p_prev = q2, q1
        for base in range(3, sp.umax + 1, G):
            cnt = min(G, sp.umax + 1 - base)
            group = kernels.chain(p_last, p_prev, q1, G, self.dctx)
            p_last, p_prev = group[-1], group[-2]
            slots = sp.rprime_map[base:base + cnt].astype(np.int64)
            sel = np.nonzero(slots)[0]
            if sel.size == 0:
                continue
            rows = torch.from_numpy(sel).to(q1.device)
            inv = self._invert_planes(group[rows, 0], group[rows, 1])
            pbx[torch.from_numpy(slots[sel]).to(q1.device)] = inv
        self.pbx = pbx                # row 0 stays the zero row
        self.ptadds += sp.umax - 2
        # Pd = [D]Q (not inverted)
        self.pd = self._ladder(self.pt, sp.D)
        return self

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

    def _entries_global(self, map_v: np.ndarray, map_u: np.ndarray,
                        amin0: int) -> np.ndarray:
        """Pairmap -> [T, 2] int64 (global Pa index j, Pb storage index)."""
        sp = self.sp
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
        return np.stack([j, pb], axis=1)

    def run_chunk(self, map_v: np.ndarray, map_u: np.ndarray, amin0: int):
        """Replay one chunk's pairmap (built by plan.pair for this chunk)."""
        sp = self.sp
        entries = self._entries_global(map_v, map_u, amin0)
        if entries.shape[0] == 0:
            return
        order = np.argsort(entries[:, 0], kind="stable")
        entries = entries[order]
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
                rest = kernels.chain(p_last, p_prev, self.pd, G - 1,
                                     self.dctx)
                group = torch.cat([pending[None], rest], dim=0)
                pending = None
                self.ptadds += G - 1
            else:
                group = kernels.chain(p_last, p_prev, self.pd, G, self.dctx)
                self.ptadds += G
            p_last, p_prev = group[-1], group[-2]

            if hi > pos:
                idx = np.stack([entries[pos:hi, 0] - base,
                                entries[pos:hi, 1]], axis=1).astype(np.int32)
                # rows past max_j are never paired: inverting only the
                # rows below keeps the harvest set independent of G
                valid = min(max_j - base + 1, G)
                pa_inv = self._invert_planes(group[:valid, 0],
                                             group[:valid, 1])
                pad = self.one_plane[None].expand(
                    (G + 1 - valid,) + tuple(self.one_plane.shape))
                pa_inv_ext = torch.cat([pa_inv, pad], dim=0)
                self._replay(pa_inv_ext, idx)
                self.paired += int(idx.shape[0])
                pos = hi
            base += G

    def _replay(self, pa_inv_ext: torch.Tensor, idx: np.ndarray):
        """acc *= prod (Pa_inv[v] - PbX[u]) over the entry list, in blocks
        of replay_block entries per kernel call."""
        packed = ((idx[:, 0].astype(np.int64) << 16)
                  | idx[:, 1].astype(np.int64)).astype(np.int32)
        tb = self.replay_block
        for lo in range(0, packed.shape[0], tb):
            blk = packed[lo:lo + tb]
            arr = np.concatenate([np.asarray([blk.shape[0]], np.int32), blk])
            self.acc = kernels.replay(self.acc, pa_inv_ext, self.pbx, arr,
                                      self.dctx)

    # -- harvest ----------------------------------------------------------

    def result(self) -> Stage2Result:
        accs = [self.ops.from_mont_int(a)
                for a in self.ops.unpack(self.acc)]
        return Stage2Result(acc=accs, factors=dict(self.factors),
                            paired=self.paired, ptadds=self.ptadds,
                            ptdups=self.ptdups, numinv=self.numinv)
