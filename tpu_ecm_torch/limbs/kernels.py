"""Wrappers of the five CUDA kernels of the main path (csrc/*.cu).

Each wrapper checks device, dtype, shape and contiguity, then routes on
where its tensors lie: on the CPU it runs the kernel's plain PyTorch
version, on a CUDA device it launches the kernel (built by limbs/build.py)
on the current stream, and anything else raises.  There is no fallback from
a CUDA tensor to the plain version.  `launches` counts the kernel launches
of each wrapper, so a run can show that it went through the kernels.

Planes are int32 [..., NW, B] with the curve axis last; host index arrays
(the stage-1 tape, the replay entries) are numpy int32 and are checked on
the host before they reach a kernel.  The plain versions sit beside the
wrappers: *_plain below for K2-K5, curve/ops.run_tape for K1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..curve.ops import NUM_SLOTS, run_tape, xadd
from . import build, torch_ops
from .torch_ops import DeviceCtx

# name -> (CUDA source, the Pallas kernel it replaces)
KERNELS = {
    "tape": ("tpu_ecm_torch/csrc/tape.cu",
             "tpu_ecm/limbs/pallas_ops.py:1284 (_tape_kernel :418)"),
    "chain": ("tpu_ecm_torch/csrc/chain.cu",
              "tpu_ecm/limbs/pallas_ops.py:519 (make_chain_executor :492)"),
    "prefix": ("tpu_ecm_torch/csrc/batch_inverse.cu",
               "tpu_ecm/limbs/pallas_ops.py:576 (make_prefix_executor :551)"),
    "apply_inverse": (
        "tpu_ecm_torch/csrc/batch_inverse.cu",
        "tpu_ecm/limbs/pallas_ops.py:632 (make_apply_inverse_executor :604)"),
    "replay": (
        "tpu_ecm_torch/csrc/replay.cu",
        "tpu_ecm/limbs/pallas_ops.py:1127 "
        "(make_replay_stream_executor :933)"),
}

launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

# tape entries per stage-1 kernel launch: keeps every launch short
TAPE_SLICE = 1 << 16


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(name: str, what: str, t: torch.Tensor, shape, ctx: DeviceCtx):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {what} must be a torch.Tensor")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: {what} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if t.device != ctx.device:
        raise ValueError(f"{name}: {what} is on {t.device}, the modulus "
                         f"context on {ctx.device}")


def _on_cpu(name: str, ctx: DeviceCtx) -> bool:
    """True for the plain version (CPU tensors), False for the kernel."""
    if ctx.is_mersenne:
        raise NotImplementedError(
            f"{name}: Mersenne-form arithmetic is not ported yet "
            "(ROADMAP.md, 'Mersenne / pseudo-Mersenne path')")
    kind = ctx.device.type
    if kind == "cpu":
        return True
    if kind != "cuda":
        raise ValueError(f"{name}: unsupported device {ctx.device}")
    if ctx.p.nw > build.NW_MAX:
        raise ValueError(f"{name}: nw={ctx.p.nw} exceeds the kernels' "
                         f"NW_MAX={build.NW_MAX}")
    return False


def _mod(ctx: DeviceCtx):
    p = ctx.p
    return (ctx.n.data_ptr(), p.nw, p.w, ctx.nprime, int(p.norm_inputs))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _done(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, "
                           f"cudaGetLastError() = {rc}")
    launches[name] += 1


def tape(pts: torch.Tensor, tape_np: np.ndarray, s_const: torch.Tensor,
         ctx: DeviceCtx) -> torch.Tensor:
    """K1: replay a [T, 5] (op, dst, a, b, c) tape over the [6, 2, NW, B]
    point file, in place; returns pts."""
    nw, b = ctx.p.nw, int(s_const.shape[-1])
    _check("tape", "pts", pts, (NUM_SLOTS, 2, nw, b), ctx)
    _check("tape", "s_const", s_const, (nw, b), ctx)
    t = np.ascontiguousarray(tape_np, dtype=np.int32).reshape(-1, 5)
    if t.shape[0] and (t[:, 0].min() < 0 or t[:, 0].max() > 2
                       or t[:, 1:].min() < 0 or t[:, 1:].max() >= NUM_SLOTS):
        raise ValueError("tape: opcode outside DUP/ADD/NOP or slot outside "
                         f"[0, {NUM_SLOTS})")
    if _on_cpu("tape", ctx):
        return run_tape(pts, t, s_const, ctx)
    if t.shape[0] == 0:
        return pts
    lib = build.library()
    dev = torch.from_numpy(t).to(pts.device)
    for lo in range(0, t.shape[0], TAPE_SLICE):
        steps = min(TAPE_SLICE, t.shape[0] - lo)
        _done("tape", lib.tpuecm_tape(
            dev[lo].data_ptr(), steps, pts.data_ptr(), s_const.data_ptr(),
            *_mod(ctx), b, _stream()))
    return pts


def chain(p1: torch.Tensor, p2: torch.Tensor, pd: torch.Tensor, count: int,
          ctx: DeviceCtx) -> torch.Tensor:
    """K2: out[i] = out[i-1] + pd (difference out[i-2]) for i < count, from
    (out[-1], out[-2]) = (p1, p2); points [2, NW, B] -> [count, 2, NW, B]."""
    nw, b = ctx.p.nw, int(p1.shape[-1])
    for what, t in (("p1", p1), ("p2", p2), ("pd", pd)):
        _check("chain", what, t, (2, nw, b), ctx)
    if count < 1:
        raise ValueError(f"chain: count must be >= 1, got {count}")
    if _on_cpu("chain", ctx):
        return chain_plain(p1, p2, pd, count, ctx)
    out = torch.empty((count, 2, nw, b), dtype=torch.int32, device=p1.device)
    _done("chain", build.library().tpuecm_chain(
        p1.data_ptr(), p2.data_ptr(), pd.data_ptr(), out.data_ptr(), count,
        *_mod(ctx), b, _stream()))
    return out


def prefix(zs: torch.Tensor, one: torch.Tensor, ctx: DeviceCtx
           ) -> torch.Tensor:
    """K3: out[i] = one * zs[0] * ... * zs[i]; [count, NW, B]."""
    nw, b = ctx.p.nw, int(one.shape[-1])
    count = int(zs.shape[0])
    _check("prefix", "zs", zs, (count, nw, b), ctx)
    _check("prefix", "one", one, (nw, b), ctx)
    if count < 1:
        raise ValueError("prefix: empty stack")
    if _on_cpu("prefix", ctx):
        return prefix_plain(zs, one, ctx)
    out = torch.empty_like(zs)
    _done("prefix", build.library().tpuecm_prefix(
        zs.data_ptr(), one.data_ptr(), out.data_ptr(), count, *_mod(ctx), b,
        _stream()))
    return out


def apply_inverse(xs: torch.Tensor, zs: torch.Tensor, pres: torch.Tensor,
                  total_inv: torch.Tensor, ctx: DeviceCtx) -> torch.Tensor:
    """K4: out[i] = xs[i] * zs[i]^-1 from pres[i] = one * zs[0..i-1] and
    total_inv = (zs[0] ... zs[count-1])^-1; [count, NW, B]."""
    nw, b = ctx.p.nw, int(total_inv.shape[-1])
    count = int(xs.shape[0])
    for what, t in (("xs", xs), ("zs", zs), ("pres", pres)):
        _check("apply_inverse", what, t, (count, nw, b), ctx)
    _check("apply_inverse", "total_inv", total_inv, (nw, b), ctx)
    if count < 1:
        raise ValueError("apply_inverse: empty stack")
    if _on_cpu("apply_inverse", ctx):
        return apply_inverse_plain(xs, zs, pres, total_inv, ctx)
    out = torch.empty_like(xs)
    _done("apply_inverse", build.library().tpuecm_apply_inverse(
        xs.data_ptr(), zs.data_ptr(), pres.data_ptr(), total_inv.data_ptr(),
        out.data_ptr(), count, *_mod(ctx), b, _stream()))
    return out


def replay(acc: torch.Tensor, pa_ext: torch.Tensor, pbx: torch.Tensor,
           idx: np.ndarray, ctx: DeviceCtx) -> torch.Tensor:
    """K5: acc * prod over the idx[0] live entries e = pa << 16 | pb of
    (pa_ext[pa] - pbx[pb]); idx is host int32 [1 + T].  Returns a new
    [NW, B] plane, equal mod n to the plain version."""
    nw, b = ctx.p.nw, int(acc.shape[-1])
    pa_rows, pb_rows = int(pa_ext.shape[0]), int(pbx.shape[0])
    _check("replay", "acc", acc, (nw, b), ctx)
    _check("replay", "pa_ext", pa_ext, (pa_rows, nw, b), ctx)
    _check("replay", "pbx", pbx, (pb_rows, nw, b), ctx)
    idx = np.ascontiguousarray(idx, dtype=np.int32).reshape(-1)
    if idx.size < 1 or not 0 <= int(idx[0]) <= idx.size - 1:
        raise ValueError("replay: idx[0] must be a live count <= len(idx)-1")
    live = idx[1:1 + int(idx[0])].view(np.uint32)
    if live.size and (int((live >> 16).max()) >= pa_rows
                      or int((live & 0xFFFF).max()) >= pb_rows):
        raise ValueError("replay: entry row outside pa_ext / pbx")
    if _on_cpu("replay", ctx):
        return replay_plain(acc, pa_ext, pbx, idx, ctx)
    out = torch.empty_like(acc)
    dev = torch.from_numpy(idx).to(acc.device)
    _done("replay", build.library().tpuecm_replay(
        acc.data_ptr(), out.data_ptr(), pa_ext.data_ptr(), pbx.data_ptr(),
        dev.data_ptr(), *_mod(ctx), b, _stream()))
    return out


# ---------------------------------------------------------------------------
# plain versions of K2-K5 (the twins of tpu_ecm/stage2/exec.py:104-173)
# ---------------------------------------------------------------------------

def chain_plain(p1: torch.Tensor, p2: torch.Tensor, pd: torch.Tensor,
                count: int, ctx: DeviceCtx) -> torch.Tensor:
    """K2: out[i] = out[i-1] + pd (difference out[i-2]) from (p1, p2)."""
    out = torch.empty((count,) + tuple(p1.shape), dtype=p1.dtype,
                      device=p1.device)
    for i in range(count):
        out[i] = torch.stack(xadd(p1[0], p1[1], pd[0], pd[1], p2[0], p2[1],
                                  ctx))
        p1, p2 = out[i], p1
    return out


def prefix_plain(zs: torch.Tensor, one: torch.Tensor, ctx: DeviceCtx
                 ) -> torch.Tensor:
    """K3: running products one * zs[0] * ... * zs[i] -> [K, NW, B]."""
    out = torch.empty_like(zs)
    acc = one
    for i in range(zs.shape[0]):
        # operands are mulmod outputs or host-packed values: pre-safe
        acc = torch_ops.mulmod(acc, zs[i], ctx, pre=True)
        out[i] = acc
    return out


def apply_inverse_plain(xs: torch.Tensor, zs: torch.Tensor,
                        pres: torch.Tensor, total_inv: torch.Tensor,
                        ctx: DeviceCtx) -> torch.Tensor:
    """K4: x_i * z_i^-1 for every row, walking the suffix back from the
    inverse of the total product; pres[i] = one * zs[0..i-1]."""
    out = torch.empty_like(xs)
    suffix = total_inv
    for i in range(xs.shape[0] - 1, -1, -1):
        inv_i = torch_ops.mulmod(suffix, pres[i], ctx, pre=True)
        out[i] = torch_ops.mulmod(xs[i], inv_i, ctx, pre=True)
        suffix = torch_ops.mulmod(suffix, zs[i], ctx, pre=True)
    return out


def replay_plain(acc: torch.Tensor, pa_ext: torch.Tensor, pbx: torch.Tensor,
                 idx: np.ndarray, ctx: DeviceCtx) -> torch.Tensor:
    """K5: acc * prod over the idx[0] live entries pa << 16 | pb of
    (pa_ext[pa] - pbx[pb]), in the kernel's association: each difference
    gets one lazy pass, whole quadruples multiply as ((d0 d1)(d2 d3)) into
    acc in order, the count % 4 tail entries one by one."""
    count = int(idx[0])
    e = idx[1:1 + count].view(np.uint32).astype(np.int64)
    dev = acc.device
    pa = torch.from_numpy(e >> 16).to(dev)
    pb = torch.from_numpy(e & 0xFFFF).to(dev)
    d = torch_ops._norm_out(pa_ext[pa] - pbx[pb], ctx)
    quads = count // 4
    if quads:
        q = d[:4 * quads].reshape((quads, 4) + tuple(d.shape[1:]))
        m01 = torch_ops.mulmod(q[:, 0], q[:, 1], ctx, pre=True)
        m23 = torch_ops.mulmod(q[:, 2], q[:, 3], ctx, pre=True)
        m = torch_ops.mulmod(m01, m23, ctx, pre=True)
        for t in range(quads):
            acc = torch_ops.mulmod(acc, m[t], ctx, pre=True)
    for k in range(4 * quads, count):
        acc = torch_ops.mulmod(acc, d[k], ctx, pre=True)
    return acc
