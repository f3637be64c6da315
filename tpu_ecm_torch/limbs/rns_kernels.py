"""Wrappers of the six CUDA kernels of the RNS engine (csrc/rns_*.cu) and
the plain PyTorch versions beside them.

The same contract as limbs/kernels.py: each wrapper checks device, dtype,
shape and contiguity, runs the plain version for CPU tensors, launches the
kernel on the tensors' device and its current stream for CUDA tensors
(never the plain version),
raises for anything else, and counts its launches in kernels.launches.
Planes are int32 [..., 2K+1, B] residue planes, curve axis last; the plain
version of K10 is rns_exec.run_tape.  All six run on the tensor-core core
csrc/rns_mma.cuh, the RNS engine's one arithmetic core: K10 at
tape_geometry's tile, K11 at chain_geometry's tile and halves, K12 at
prefix_geometry's, K13 at apply_inverse_geometry's, K14 at
gather_geometry's and K15 at replay_geometry's.  Every kernel gives the
plain version's residues exactly (K15: both multiply acc by one difference
per entry, in entry order; K14: both multiply each step's differences in
the same pairwise tree).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..curve.ops import NUM_SLOTS
from . import build, rns, rns_exec
from .kernels import (PLAIN_REPLAY_BLOCK, _check, _launch,
                      check_pairs, step_roots)
from .rns import RnsCtx

# tape entries per stage-1 kernel launch: keeps every launch short
TAPE_SLICE = 1 << 12


class TapeGeometry(NamedTuple):
    tile: int          # curves a block (T)
    threads: int
    blocks: int
    smem: int          # dynamic shared memory a block, bytes
    resident: bool     # the weight planes in shared memory


class ChainGeometry(NamedTuple):
    """The launch of K11, K12 or K13."""
    tile: int          # curves a block (T)
    halves: int        # products a pass (2: paired, mma_mul2)
    threads: int
    blocks: int
    smem: int          # dynamic shared memory a block, bytes
    resident: bool     # the weight planes in shared memory


class GatherGeometry(NamedTuple):
    tile: int          # curves a block (T)
    halves: int        # products a pass (2: paired, mma_mul2)
    threads: int
    blocks: int
    smem: int          # dynamic shared memory a block, bytes
    resident: bool     # the weight planes in shared memory
    scratch: int       # scratch planes of [2K+1, B] int32 a call takes


def _geometry(entry: str, K: int, b: int, tile: int, n: int, lib) -> list:
    """The n numbers a geometry entry point of csrc/ fills at K, B and
    `tile` (0: the kernel's own), from `lib` (a build of those sources;
    the card's library by default)."""
    out = (ctypes.c_longlong * n)()
    fn = getattr(lib or build.library(), entry)
    if fn(K, b, tile, out):
        raise ValueError(f"{entry}: no launch covers K={K}, B={b}, "
                         f"tile={tile}")
    return list(out)


def tape_geometry(K: int, b: int, lib=None, tile: int = 0
                  ) -> TapeGeometry:
    """K10's launch at K and B curves, as csrc/rns_mma.cuh:rns_tape_config
    picks it (tpuecm_rns_tape_geometry): a tile of T = 8 curves a block
    where X, the P/Q tiles, the channel pairs' constants and the four u8
    weight planes fit in shared memory (K <= 222), else T = 4 with the
    weights read from the global table; G = T/4 threads a channel pair,
    and at least two warps a 32-row M tile, up to 17.  A `tile` other
    than 0 asks for that tile's launch."""
    g = _geometry("tpuecm_rns_tape_geometry", K, b, tile, 5, lib)
    return TapeGeometry(*g[:4], bool(g[4]))


def chain_geometry(K: int, b: int, lib=None, tile: int = 0
                   ) -> ChainGeometry:
    """K11's launch at K and B curves, as
    csrc/rns_chain.cu:rns_chain_config picks it
    (tpuecm_rns_chain_geometry): K10's tile and threads, with two halves
    (paired products) where they fit beside the resident weights (K <=
    208), one where only one does (208 < K <= 222), and two at T = 4 past
    it (global fragments).  A `tile` other than 0 asks for that tile's
    launch."""
    g = _geometry("tpuecm_rns_chain_geometry", K, b, tile, 6, lib)
    return ChainGeometry(*g[:5], bool(g[5]))


def prefix_geometry(K: int, b: int, lib=None, tile: int = 0
                    ) -> ChainGeometry:
    """K12's launch at K and B curves, as
    csrc/rns_batch_inverse.cu:rns_prefix_config picks it
    (tpuecm_rns_prefix_geometry): K10's, one product a pass (T = 8 with
    the weights resident up to K = 222, T = 4 past it).  A `tile` other
    than 0 asks for that tile's launch."""
    g = _geometry("tpuecm_rns_prefix_geometry", K, b, tile, 6, lib)
    return ChainGeometry(*g[:5], bool(g[5]))


def apply_inverse_geometry(K: int, b: int, lib=None, tile: int = 0
                           ) -> ChainGeometry:
    """K13's launch at K and B curves, as
    csrc/rns_batch_inverse.cu:rns_apply_inverse_config picks it
    (tpuecm_rns_apply_inverse_geometry): K11's, two halves (a row's two
    products of the old suffix in one pass) up to K = 208, one where only
    one fits beside the resident weights (208 < K <= 222), and two at
    T = 4 past it.  A `tile` other than 0 asks for that tile's launch."""
    g = _geometry("tpuecm_rns_apply_inverse_geometry", K, b, tile, 6, lib)
    return ChainGeometry(*g[:5], bool(g[5]))


def gather_geometry(K: int, b: int, lib=None, tile: int = 0
                    ) -> GatherGeometry:
    """K14's launch at K and B curves, as
    csrc/rns_replay_gather.cu:rns_gather_config picks it
    (tpuecm_rns_gather_geometry): K10's tile and threads, with two halves
    (paired products) where they fit beside the resident weights and the
    entry ring (K <= 208), one where only one does (208 < K <= 222), and
    two at T = 4 past it (global fragments); one scratch plane at T = 8,
    five at T = 4.  A `tile` other than 0 asks for that tile's launch."""
    g = _geometry("tpuecm_rns_gather_geometry", K, b, tile, 7, lib)
    return GatherGeometry(*g[:5], bool(g[5]), g[6])


def replay_geometry(K: int, b: int, lib=None, tile: int = 0
                    ) -> TapeGeometry:
    """K15's launch at K and B curves, as csrc/rns_replay.cu:
    rns_replay_config picks it (tpuecm_rns_replay_geometry): K12's, one
    product a pass, with the 768-byte entry ring beside the core (T = 8
    with the weights resident up to K = 222, T = 4 past it).  A `tile`
    other than 0 asks for that tile's launch."""
    g = _geometry("tpuecm_rns_replay_geometry", K, b, tile, 5, lib)
    return TapeGeometry(*g[:4], bool(g[4]))


def _on_cpu(name: str, rc: RnsCtx) -> bool:
    """True for the plain version (CPU tensors), False for the kernel."""
    kind = rc.device.type
    if kind == "cpu":
        return True
    if kind != "cuda":
        raise ValueError(f"{name}: unsupported device {rc.device}")
    if rc.K % 2 or not 2 <= rc.K <= rns.K_MAX:
        raise ValueError(f"{name}: K={rc.K} outside the kernels' even "
                         f"2 <= K <= {rns.K_MAX}")
    return False


def tape(pts: torch.Tensor, tape_np: np.ndarray, s_const: torch.Tensor,
         rc: RnsCtx) -> torch.Tensor:
    """K10: replay a [T, 5] (op, dst, a, b, c) tape over the
    [6, 2, rows, B] point file, in place; returns pts."""
    rows, b = rc.rows, int(s_const.shape[-1])
    _check("rns_tape", "pts", pts, (NUM_SLOTS, 2, rows, b), rc)
    _check("rns_tape", "s_const", s_const, (rows, b), rc)
    t = np.ascontiguousarray(tape_np, dtype=np.int32).reshape(-1, 5)
    if t.shape[0] and (t[:, 0].min() < 0 or t[:, 0].max() > 2
                       or t[:, 1:].min() < 0 or t[:, 1:].max() >= NUM_SLOTS):
        raise ValueError("rns_tape: opcode outside DUP/ADD/NOP or slot "
                         f"outside [0, {NUM_SLOTS})")
    if _on_cpu("rns_tape", rc):
        return rns_exec.run_tape(pts, t, s_const, rc)
    if t.shape[0] == 0:
        return pts
    dev = torch.from_numpy(t).to(pts.device)
    tile = tape_geometry(rc.K, b).tile
    for lo in range(0, t.shape[0], TAPE_SLICE):
        steps = min(TAPE_SLICE, t.shape[0] - lo)
        _launch("rns_tape", rc, "tpuecm_rns_tape", dev[lo].data_ptr(), steps,
                pts.data_ptr(), s_const.data_ptr(), rc.tab.data_ptr(),
                rc.wmma.data_ptr(), rc.K, b, tile)
    return pts


def chain(p1: torch.Tensor, p2: torch.Tensor, pd: torch.Tensor, count: int,
          rc: RnsCtx) -> torch.Tensor:
    """K11: out[i] = out[i-1] + pd (difference out[i-2]) for i < count, from
    (out[-1], out[-2]) = (p1, p2); points [2, rows, B]."""
    rows, b = rc.rows, int(p1.shape[-1])
    for what, t in (("p1", p1), ("p2", p2), ("pd", pd)):
        _check("rns_chain", what, t, (2, rows, b), rc)
    if count < 1:
        raise ValueError(f"rns_chain: count must be >= 1, got {count}")
    if _on_cpu("rns_chain", rc):
        return chain_plain(p1, p2, pd, count, rc)
    out = torch.empty((count, 2, rows, b), dtype=torch.int32,
                      device=p1.device)
    _launch("rns_chain", rc, "tpuecm_rns_chain", p1.data_ptr(), p2.data_ptr(),
            pd.data_ptr(), out.data_ptr(), count, rc.tab.data_ptr(),
            rc.wmma.data_ptr(), rc.K, b, chain_geometry(rc.K, b).tile)
    return out


def prefix(zs: torch.Tensor, one: torch.Tensor, rc: RnsCtx) -> torch.Tensor:
    """K12: out[i] = one * zs[0] * ... * zs[i]; [count, rows, B]."""
    rows, b = rc.rows, int(one.shape[-1])
    count = int(zs.shape[0])
    _check("rns_prefix", "zs", zs, (count, rows, b), rc)
    _check("rns_prefix", "one", one, (rows, b), rc)
    if count < 1:
        raise ValueError("rns_prefix: empty stack")
    if _on_cpu("rns_prefix", rc):
        return prefix_plain(zs, one, rc)
    out = torch.empty_like(zs)
    _launch("rns_prefix", rc, "tpuecm_rns_prefix", zs.data_ptr(),
            one.data_ptr(), out.data_ptr(), count, rc.tab.data_ptr(),
            rc.wmma.data_ptr(), rc.K, b, prefix_geometry(rc.K, b).tile)
    return out


def apply_inverse(xs: torch.Tensor, zs: torch.Tensor, pres: torch.Tensor,
                  total_inv: torch.Tensor, rc: RnsCtx) -> torch.Tensor:
    """K13: out[i] = xs[i] * zs[i]^-1 from pres[i] = one * zs[0..i-1] and
    total_inv = (zs[0] ... zs[count-1])^-1; [count, rows, B]."""
    rows, b = rc.rows, int(total_inv.shape[-1])
    count = int(xs.shape[0])
    for what, t in (("xs", xs), ("zs", zs), ("pres", pres)):
        _check("rns_apply_inverse", what, t, (count, rows, b), rc)
    _check("rns_apply_inverse", "total_inv", total_inv, (rows, b), rc)
    if count < 1:
        raise ValueError("rns_apply_inverse: empty stack")
    if _on_cpu("rns_apply_inverse", rc):
        return apply_inverse_plain(xs, zs, pres, total_inv, rc)
    out = torch.empty_like(xs)
    _launch("rns_apply_inverse", rc, "tpuecm_rns_apply_inverse", xs.data_ptr(),
            zs.data_ptr(), pres.data_ptr(), total_inv.data_ptr(),
            out.data_ptr(), count, rc.tab.data_ptr(), rc.wmma.data_ptr(), rc.K,
            b, apply_inverse_geometry(rc.K, b).tile)
    return out


def replay(acc: torch.Tensor, pa_ext: torch.Tensor, pbx: torch.Tensor,
           idx: np.ndarray, rc: RnsCtx) -> torch.Tensor:
    """K15: acc times (pa_ext[pa] - pbx[pb]) for each of the idx[0] live
    entries e = pa << 16 | pb, in entry order; idx is host int32 [1 + T].
    Returns a new [rows, B] plane."""
    rows, b = rc.rows, int(acc.shape[-1])
    pa_rows, pb_rows = int(pa_ext.shape[0]), int(pbx.shape[0])
    _check("rns_replay", "acc", acc, (rows, b), rc)
    _check("rns_replay", "pa_ext", pa_ext, (pa_rows, rows, b), rc)
    _check("rns_replay", "pbx", pbx, (pb_rows, rows, b), rc)
    idx = np.ascontiguousarray(idx, dtype=np.int32).reshape(-1)
    if idx.size < 1 or not 0 <= int(idx[0]) <= idx.size - 1:
        raise ValueError("rns_replay: idx[0] must be a live count "
                         "<= len(idx)-1")
    live = idx[1:1 + int(idx[0])].view(np.uint32)
    if live.size and (int((live >> 16).max()) >= pa_rows
                      or int((live & 0xFFFF).max()) >= pb_rows):
        raise ValueError("rns_replay: entry row outside pa_ext / pbx")
    if _on_cpu("rns_replay", rc):
        return replay_plain(acc, pa_ext, pbx, idx, rc)
    out = torch.empty_like(acc)
    dev = torch.from_numpy(idx[1:1 + live.size]).to(acc.device)
    _launch("rns_replay", rc, "tpuecm_rns_replay", acc.data_ptr(),
            out.data_ptr(), pa_ext.data_ptr(), pbx.data_ptr(), dev.data_ptr(),
            live.size, rc.tab.data_ptr(), rc.wmma.data_ptr(), rc.K, b,
            replay_geometry(rc.K, b).tile)
    return out


def replay_gather(acc: torch.Tensor, pa_ext: torch.Tensor, pbx: torch.Tensor,
                  idx: np.ndarray, rc: RnsCtx, *, e: int) -> torch.Tensor:
    """K14: acc times the product over the entries (pa, pb) of idx [T, 2]
    of sub(pa_ext[pa], pbx[pb]), in steps of e entries multiplied in a
    pairwise tree before acc (T a multiple of e).  Returns a new [rows, B]
    plane."""
    rows, b = rc.rows, int(acc.shape[-1])
    pa_rows, pb_rows = int(pa_ext.shape[0]), int(pbx.shape[0])
    _check("rns_replay_gather", "acc", acc, (rows, b), rc)
    _check("rns_replay_gather", "pa_ext", pa_ext, (pa_rows, rows, b), rc)
    _check("rns_replay_gather", "pbx", pbx, (pb_rows, rows, b), rc)
    idx = check_pairs("rns_replay_gather", idx, e, pa_rows, pb_rows)
    if _on_cpu("rns_replay_gather", rc):
        return replay_gather_plain(acc, pa_ext, pbx, idx, e, rc)
    out = torch.empty_like(acc)
    g = gather_geometry(rc.K, b)
    scratch = torch.empty((g.scratch, rows, b), dtype=torch.int32,
                          device=acc.device)
    dev = torch.from_numpy(idx).to(acc.device)
    _launch("rns_replay_gather", rc, "tpuecm_rns_replay_gather",
            acc.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            pa_ext.data_ptr(), pbx.data_ptr(), dev.data_ptr(),
            idx.shape[0] // e, e, rc.tab.data_ptr(), rc.wmma.data_ptr(), rc.K,
            b, g.tile)
    return out


# ---------------------------------------------------------------------------
# plain versions of K11-K15 (the twins of rns_exec.py:135-191 and
# of the Pallas kernels' loops)
# ---------------------------------------------------------------------------

def chain_plain(p1: torch.Tensor, p2: torch.Tensor, pd: torch.Tensor,
                count: int, rc: RnsCtx) -> torch.Tensor:
    out = torch.empty((count,) + tuple(p1.shape), dtype=p1.dtype,
                      device=p1.device)
    for i in range(count):
        out[i] = torch.stack(rns_exec.xadd(p1, pd, p2, rc))
        p1, p2 = out[i], p1
    return out


def prefix_plain(zs: torch.Tensor, one: torch.Tensor, rc: RnsCtx
                 ) -> torch.Tensor:
    out = torch.empty_like(zs)
    acc = one
    for i in range(zs.shape[0]):
        acc = rns.mont_mul(acc, zs[i], rc)
        out[i] = acc
    return out


def apply_inverse_plain(xs: torch.Tensor, zs: torch.Tensor,
                        pres: torch.Tensor, total_inv: torch.Tensor,
                        rc: RnsCtx) -> torch.Tensor:
    out = torch.empty_like(xs)
    suffix = total_inv
    for i in range(xs.shape[0] - 1, -1, -1):
        inv_i = rns.mont_mul(suffix, pres[i], rc)
        out[i] = rns.mont_mul(xs[i], inv_i, rc)
        suffix = rns.mont_mul(suffix, zs[i], rc)
    return out


def replay_plain(acc: torch.Tensor, pa_ext: torch.Tensor, pbx: torch.Tensor,
                 idx: np.ndarray, rc: RnsCtx) -> torch.Tensor:
    """acc times sub(pa_ext[pa], pbx[pb]) entry by entry, in order (the
    Pallas K15's association); differences are formed in blocks of
    PLAIN_REPLAY_BLOCK entries, which bounds memory."""
    count = int(idx[0])
    e = idx[1:1 + count].view(np.uint32).astype(np.int64)
    dev = acc.device
    for lo in range(0, count, PLAIN_REPLAY_BLOCK):
        blk = e[lo:lo + PLAIN_REPLAY_BLOCK]
        pa = torch.from_numpy(blk >> 16).to(dev)
        pb = torch.from_numpy(blk & 0xFFFF).to(dev)
        d = rns.sub(pa_ext[pa], pbx[pb], rc)
        for k in range(d.shape[0]):
            acc = rns.mont_mul(acc, d[k], rc)
    return acc


def replay_gather_plain(acc: torch.Tensor, pa_ext: torch.Tensor,
                        pbx: torch.Tensor, idx: np.ndarray, e: int,
                        rc: RnsCtx) -> torch.Tensor:
    """K14 in the kernel's association: each step's e differences
    sub(pa_ext[pa], pbx[pb]) multiplied in the pairwise tree (one batched
    product per level over a block of steps), the roots into acc in
    order."""
    mul = lambda x, y: rns.mont_mul(x, y, rc)
    ent = torch.from_numpy(idx.astype(np.int64)).to(acc.device)
    for lo in range(0, ent.shape[0], PLAIN_REPLAY_BLOCK):
        blk = ent[lo:lo + PLAIN_REPLAY_BLOCK]
        d = rns.sub(pa_ext[blk[:, 0]], pbx[blk[:, 1]], rc)
        for root in step_roots(d, e, mul):
            acc = mul(acc, root)
    return acc
