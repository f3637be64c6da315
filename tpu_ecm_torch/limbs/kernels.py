"""Wrappers of the nine CUDA kernels of the digit engine (csrc/*.cu), and
the registry of every kernel of the port (the RNS engine's six wrappers
are in limbs/rns_kernels.py and count their launches here too).  The digit
kernels run on the lane core csrc/arith_lanes.cuh, several lanes per curve
(tape_geometry), and take both reductions from one build: REDC for a
generic n, the fold for a special form 2^e - c (ctx.is_mersenne).

Each wrapper checks device, dtype, shape and contiguity, then routes on
where its tensors lie: on the CPU it runs the kernel's plain PyTorch
version, on a CUDA device it launches the kernel (built by limbs/build.py)
on that device, whichever is current, and on its current stream (_launch);
tensors on two devices, or anything else, raise.  There is no fallback from
a CUDA tensor to the plain version.  `launches` counts the kernel launches
of each wrapper, so a run can show that it went through the kernels.

Planes are int32 [..., NW, B] with the curve axis last; host index arrays
(the stage-1 tapes, the replay entries and steps) are numpy int32 and are
checked on the host before they reach a kernel.  The plain versions sit
beside the wrappers: *_plain below for K2-K8, curve/ops.run_tape for K1
and curve/edops.run_tape for K9.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..curve import edops
from ..curve.ops import NUM_SLOTS, run_tape, xadd
from . import build, torch_ops
from .torch_ops import DeviceCtx

# name -> (CUDA source, the Pallas kernel it replaces: the line of its
# pallas_call, and the kernel function)
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
    "replay_gather": (
        "tpu_ecm_torch/csrc/replay_gather.cu",
        "tpu_ecm/limbs/pallas_ops.py:735 (make_replay_executor :664)"),
    "replay_parow": (
        "tpu_ecm_torch/csrc/replay_gather.cu",
        "tpu_ecm/limbs/pallas_ops.py:834 (make_replay_parow_executor :761)"),
    "replay_resident": (
        "tpu_ecm_torch/csrc/replay_resident.cu",
        "tpu_ecm/limbs/pallas_ops.py:1231 "
        "(make_replay_resident_executor :1152)"),
    "ed_tape": ("tpu_ecm_torch/csrc/ed_tape.cu",
                "tpu_ecm/limbs/pallas_ops.py:1438 (_ed_tape_kernel :1338)"),
    "rns_tape": (
        "tpu_ecm_torch/csrc/rns_tape.cu",
        "tpu_ecm/limbs/rns_exec.py:712 (_rns_tape_kernel :198, "
        "make_rns_tape_executor :681)"),
    "rns_chain": (
        "tpu_ecm_torch/csrc/rns_chain.cu",
        "tpu_ecm/limbs/rns_exec.py:303 (make_rns_chain_executor :276)"),
    "rns_prefix": (
        "tpu_ecm_torch/csrc/rns_batch_inverse.cu",
        "tpu_ecm/limbs/rns_exec.py:350 (make_rns_prefix_executor :330)"),
    "rns_apply_inverse": (
        "tpu_ecm_torch/csrc/rns_batch_inverse.cu",
        "tpu_ecm/limbs/rns_exec.py:399 "
        "(make_rns_apply_inverse_executor :375)"),
    "rns_replay": (
        "tpu_ecm_torch/csrc/rns_replay.cu",
        "tpu_ecm/limbs/rns_exec.py:653 "
        "(make_rns_replay_stream_executor :509)"),
    "rns_replay_gather": (
        "tpu_ecm_torch/csrc/rns_replay_gather.cu",
        "tpu_ecm/limbs/rns_exec.py:483 (make_rns_replay_executor :426)"),
}

launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

# tape entries per stage-1 kernel launch (K1, K9): keeps every launch
# short
TAPE_SLICE = 1 << 16
# The geometry of the lane-core kernels K1-K9 (csrc/tape.cu,
# csrc/chain.cu, csrc/batch_inverse.cu, csrc/replay.cu,
# csrc/replay_gather.cu, csrc/replay_resident.cu, csrc/ed_tape.cu on
# csrc/arith_lanes.cuh):
# a group of `lanes` threads works on one curve, each lane holding
# `digits` digits of every operand in registers.  The lane counts they
# take, the digit counts they are instantiated for (the dispatch of each),
# and the threads of a block (TPUECM_TAPE_BLOCK of csrc/arith_lanes.cuh)
TAPE_LANES = (4, 8, 16, 32)
TAPE_DIGITS = (2, 3, 4, 5, 6, 7, 8)
TAPE_BLOCK = 128
# entries per step of the gather-form replays (K6-K8, K14): a power of two
# up to E_MAX, the bound of the kernels' partial-product stacks
E_MAX = 16
# replay entries whose differences the plain K6-K8, K14 and K15 form at
# once (bounds their memory; a multiple of every E)
PLAIN_REPLAY_BLOCK = 1024


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


def check_e(name: str, e: int) -> None:
    """Entries per step: a power of two from 1 to E_MAX."""
    if not (1 <= e <= E_MAX and e & (e - 1) == 0):
        raise ValueError(f"{name}: entries per step must be a power of two "
                         f"from 1 to {E_MAX}, got {e!r}")


def check_pairs(name: str, idx: np.ndarray, e: int, pa_rows: int,
                pb_rows: int) -> np.ndarray:
    """idx as contiguous int32 [T, 2] (pa, pb) pairs, T a multiple of e,
    every row inside its table."""
    check_e(name, e)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    if idx.ndim != 2 or idx.shape[1] != 2 or idx.shape[0] % e:
        raise ValueError(f"{name}: idx must be [T, 2] with T a multiple of "
                         f"E={e}, got {idx.shape}")
    if idx.size and (int(idx.min()) < 0 or int(idx[:, 0].max()) >= pa_rows
                     or int(idx[:, 1].max()) >= pb_rows):
        raise ValueError(f"{name}: entry row outside pa_ext / pbx")
    return idx


def step_roots(d: torch.Tensor, e: int, mul) -> torch.Tensor:
    """[S*E, ...] differences -> [S, ...]: each step's E values multiplied
    in the Pallas gather kernels' pairwise tree ((d0 d1)(d2 d3))..., one
    batched product per level."""
    d = d.reshape((-1, e) + tuple(d.shape[1:]))
    while d.shape[1] > 1:
        d = mul(d[:, 0::2], d[:, 1::2])
    return d[:, 0]


def _on_cpu(name: str, ctx: DeviceCtx) -> bool:
    """True for the plain version (CPU tensors), False for the kernel."""
    kind = ctx.device.type
    if kind == "cpu":
        return True
    if kind != "cuda":
        raise ValueError(f"{name}: unsupported device {ctx.device}")
    if ctx.p.nw > build.NW_MAX:
        raise ValueError(f"{name}: nw={ctx.p.nw} exceeds the kernels' "
                         f"NW_MAX={build.NW_MAX}")
    cl, k0 = int(ctx.c.shape[0]), ctx.mersenne_e // ctx.p.w
    if ctx.is_mersenne and not (cl <= build.CL_MAX and cl <= k0 < ctx.p.nw):
        raise ValueError(f"{name}: the fold takes |c| of at most "
                         f"{build.CL_MAX} digits below bit e; this context "
                         f"has {cl} digits at e={ctx.mersenne_e}")
    return False


def _mod(ctx: DeviceCtx):
    """TPUECM_MOD_PARAMS of csrc/arith.cuh; e = 0 selects REDC."""
    p = ctx.p
    return (ctx.n.data_ptr(), ctx.c.data_ptr(), int(ctx.c.shape[0]),
            ctx.mersenne_e, ctx.mersenne_c_sign, p.nw, p.w, ctx.nprime,
            int(p.norm_inputs))


@contextlib.contextmanager
def on_device(device):
    """`device` current in this thread for torch and for the kernel
    library's own CUDA runtime (limbs/build.py links it into the library),
    whichever device was current before."""
    with torch.cuda.device(device):
        rc = build.library().tpuecm_set_device(torch.cuda.current_device())
        if rc != 0:
            raise RuntimeError(f"cudaSetDevice({device}) failed, CUDA "
                               f"error {rc}")
        yield


def _done(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, "
                           f"cudaGetLastError() = {rc}")
    launches[name] += 1


def _launch(name: str, ctx, entry: str, *args) -> None:
    """Launch the library's `entry` on ctx's device, which every tensor
    argument was checked to lie on (_check), and on that device's current
    stream; count it in launches."""
    with on_device(ctx.device):
        rc = getattr(build.library(), entry)(
            *args, torch.cuda.current_stream(ctx.device).cuda_stream)
    _done(name, rc)


def tape_geometry(nw: int, b: int):
    """(lanes, digits, curves_per_block, blocks) of the lane-core kernels
    (K1-K9) at nw digits and B curves: the fewest lanes per curve
    (TAPE_LANES) that hold nw digits at most TAPE_DIGITS[-1] digits a lane,
    digits = ceil(nw / lanes) (at least TAPE_DIGITS[0]), TAPE_BLOCK threads
    a block."""
    if not 2 <= nw <= build.NW_MAX:
        raise ValueError(f"no lane-core (K1-K9) instantiation "
                         f"covers nw={nw} (2 <= nw <= {build.NW_MAX})")
    if b < 1:
        raise ValueError(f"lane core (K1-K9): batch must be "
                         f">= 1, got {b}")
    for lanes in TAPE_LANES:
        digits = max(-(-nw // lanes), TAPE_DIGITS[0])
        if digits <= TAPE_DIGITS[-1]:
            break
    per_block = TAPE_BLOCK // lanes
    return lanes, digits, per_block, -(-b // per_block)


def tape(pts: torch.Tensor, tape_np: np.ndarray, s_const: torch.Tensor,
         ctx: DeviceCtx) -> torch.Tensor:
    """K1: replay a [T, 5] (op, dst, a, b, c) tape over the [6, 2, NW, B]
    point file, in place, at tape_geometry's lanes and digits per curve;
    returns pts."""
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
    lanes, digits, _per_block, _blocks = tape_geometry(nw, b)
    if t.shape[0] == 0:
        return pts
    dev = torch.from_numpy(t).to(pts.device)
    for lo in range(0, t.shape[0], TAPE_SLICE):
        steps = min(TAPE_SLICE, t.shape[0] - lo)
        _launch("tape", ctx, "tpuecm_tape", dev[lo].data_ptr(), steps,
                pts.data_ptr(), s_const.data_ptr(), *_mod(ctx), b, lanes,
                digits)
    return pts


def ed_tape(acc: torch.Tensor, tape_np: np.ndarray, table: torch.Tensor,
            ctx: DeviceCtx) -> torch.Tensor:
    """K9: replay a [T, 2] (op, arg) Edwards wNAF tape over the [4, NW, B]
    accumulator, in place, with the [Tp, 3, NW, B] cached window table, at
    tape_geometry's lanes and digits per curve; returns acc."""
    nw, b = ctx.p.nw, int(acc.shape[-1])
    tp = int(table.shape[0])
    _check("ed_tape", "acc", acc, (4, nw, b), ctx)
    _check("ed_tape", "table", table, (tp, 3, nw, b), ctx)
    t = np.ascontiguousarray(tape_np, dtype=np.int32).reshape(-1, 2)
    if t.shape[0] and (t[:, 0].min() < 0 or t[:, 0].max() > edops.MAX_OP
                       or t[:, 1].min() < 0 or t[:, 1].max() >= tp):
        raise ValueError(f"ed_tape: opcode outside 0..{edops.MAX_OP} or "
                         f"table row "
                         f"outside [0, {tp})")
    if _on_cpu("ed_tape", ctx):
        return edops.run_tape(acc, t, table, ctx)
    lanes, digits, _per_block, _blocks = tape_geometry(nw, b)
    if t.shape[0] == 0:
        return acc
    dev = torch.from_numpy(t).to(acc.device)
    for lo in range(0, t.shape[0], TAPE_SLICE):
        steps = min(TAPE_SLICE, t.shape[0] - lo)
        _launch("ed_tape", ctx, "tpuecm_ed_tape", dev[lo].data_ptr(), steps,
                acc.data_ptr(), table.data_ptr(), *_mod(ctx), b, lanes, digits)
    return acc


def chain(p1: torch.Tensor, p2: torch.Tensor, pd: torch.Tensor, count: int,
          ctx: DeviceCtx) -> torch.Tensor:
    """K2: out[i] = out[i-1] + pd (difference out[i-2]) for i < count, from
    (out[-1], out[-2]) = (p1, p2); points [2, NW, B] -> [count, 2, NW, B],
    at tape_geometry's lanes and digits per curve."""
    nw, b = ctx.p.nw, int(p1.shape[-1])
    for what, t in (("p1", p1), ("p2", p2), ("pd", pd)):
        _check("chain", what, t, (2, nw, b), ctx)
    if count < 1:
        raise ValueError(f"chain: count must be >= 1, got {count}")
    if _on_cpu("chain", ctx):
        return chain_plain(p1, p2, pd, count, ctx)
    lanes, digits, _per_block, _blocks = tape_geometry(nw, b)
    out = torch.empty((count, 2, nw, b), dtype=torch.int32, device=p1.device)
    _launch("chain", ctx, "tpuecm_chain", p1.data_ptr(), p2.data_ptr(),
            pd.data_ptr(), out.data_ptr(), count, *_mod(ctx), b, lanes, digits)
    return out


def prefix(zs: torch.Tensor, one: torch.Tensor, ctx: DeviceCtx
           ) -> torch.Tensor:
    """K3: out[i] = one * zs[0] * ... * zs[i]; [count, NW, B], at
    tape_geometry's lanes and digits per curve."""
    nw, b = ctx.p.nw, int(one.shape[-1])
    count = int(zs.shape[0])
    _check("prefix", "zs", zs, (count, nw, b), ctx)
    _check("prefix", "one", one, (nw, b), ctx)
    if count < 1:
        raise ValueError("prefix: empty stack")
    if _on_cpu("prefix", ctx):
        return prefix_plain(zs, one, ctx)
    lanes, digits, _per_block, _blocks = tape_geometry(nw, b)
    out = torch.empty_like(zs)
    _launch("prefix", ctx, "tpuecm_prefix", zs.data_ptr(), one.data_ptr(),
            out.data_ptr(), count, *_mod(ctx), b, lanes, digits)
    return out


def apply_inverse(xs: torch.Tensor, zs: torch.Tensor, pres: torch.Tensor,
                  total_inv: torch.Tensor, ctx: DeviceCtx) -> torch.Tensor:
    """K4: out[i] = xs[i] * zs[i]^-1 from pres[i] = one * zs[0..i-1] and
    total_inv = (zs[0] ... zs[count-1])^-1; [count, NW, B], at
    tape_geometry's lanes and digits per curve."""
    nw, b = ctx.p.nw, int(total_inv.shape[-1])
    count = int(xs.shape[0])
    for what, t in (("xs", xs), ("zs", zs), ("pres", pres)):
        _check("apply_inverse", what, t, (count, nw, b), ctx)
    _check("apply_inverse", "total_inv", total_inv, (nw, b), ctx)
    if count < 1:
        raise ValueError("apply_inverse: empty stack")
    if _on_cpu("apply_inverse", ctx):
        return apply_inverse_plain(xs, zs, pres, total_inv, ctx)
    lanes, digits, _per_block, _blocks = tape_geometry(nw, b)
    out = torch.empty_like(xs)
    _launch("apply_inverse", ctx, "tpuecm_apply_inverse", xs.data_ptr(),
            zs.data_ptr(), pres.data_ptr(), total_inv.data_ptr(),
            out.data_ptr(), count, *_mod(ctx), b, lanes, digits)
    return out


def replay(acc: torch.Tensor, pa_ext: torch.Tensor, pbx: torch.Tensor,
           idx: np.ndarray, ctx: DeviceCtx) -> torch.Tensor:
    """K5: acc * prod over the idx[0] live entries e = pa << 16 | pb of
    (pa_ext[pa] - pbx[pb]); idx is host int32 [1 + T].  The kernel runs at
    tape_geometry's lanes and digits per curve.  Returns a new [NW, B]
    plane, digit for digit the plain version's."""
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
    lanes, digits, _per_block, _blocks = tape_geometry(nw, b)
    out = torch.empty_like(acc)
    dev = torch.from_numpy(idx).to(acc.device)
    _launch("replay", ctx, "tpuecm_replay", acc.data_ptr(), out.data_ptr(),
            pa_ext.data_ptr(), pbx.data_ptr(), dev.data_ptr(), *_mod(ctx), b,
            lanes, digits)
    return out


def replay_gather(acc: torch.Tensor, pa_ext: torch.Tensor, pbx: torch.Tensor,
                  idx: np.ndarray, ctx: DeviceCtx, *, e: int) -> torch.Tensor:
    """K6: acc * prod over the entries (pa, pb) of idx [T, 2] of
    (pa_ext[pa] - pbx[pb]), in steps of e entries whose differences
    multiply in a pairwise tree before acc (T a multiple of e), at
    tape_geometry's lanes and digits per curve.  Returns a new [NW, B]
    plane, digit for digit the plain version's."""
    nw, b = ctx.p.nw, int(acc.shape[-1])
    pa_rows, pb_rows = int(pa_ext.shape[0]), int(pbx.shape[0])
    _check("replay_gather", "acc", acc, (nw, b), ctx)
    _check("replay_gather", "pa_ext", pa_ext, (pa_rows, nw, b), ctx)
    _check("replay_gather", "pbx", pbx, (pb_rows, nw, b), ctx)
    idx = check_pairs("replay_gather", idx, e, pa_rows, pb_rows)
    if _on_cpu("replay_gather", ctx):
        return replay_gather_plain(acc, pa_ext, pbx, idx, e, ctx)
    lanes, digits, _per_block, _blocks = tape_geometry(nw, b)
    out = torch.empty_like(acc)
    dev = torch.from_numpy(idx).to(acc.device)
    _launch("replay_gather", ctx, "tpuecm_replay_gather", acc.data_ptr(),
            out.data_ptr(), pa_ext.data_ptr(), pbx.data_ptr(), dev.data_ptr(),
            idx.shape[0] // e, e, *_mod(ctx), b, lanes, digits)
    return out


def replay_parow(acc: torch.Tensor, pa_ext: torch.Tensor, pbx: torch.Tensor,
                 steps: np.ndarray, one: torch.Tensor, ctx: DeviceCtx
                 ) -> torch.Tensor:
    """K7: acc * prod over the steps [S, 1 + E] rows [pa, pb_0..pb_{E-1}]
    of the tree product of the E values (pa_ext[pa] - pbx[pb_k]), where
    pb_k == 0 stands for `one` (a pad), at tape_geometry's lanes and digits
    per curve.  Returns a new [NW, B] plane, digit for digit the plain
    version's."""
    nw, b = ctx.p.nw, int(acc.shape[-1])
    pa_rows, pb_rows = int(pa_ext.shape[0]), int(pbx.shape[0])
    _check("replay_parow", "acc", acc, (nw, b), ctx)
    _check("replay_parow", "pa_ext", pa_ext, (pa_rows, nw, b), ctx)
    _check("replay_parow", "pbx", pbx, (pb_rows, nw, b), ctx)
    _check("replay_parow", "one", one, (nw, b), ctx)
    steps = np.ascontiguousarray(steps, dtype=np.int32)
    if steps.ndim != 2:
        raise ValueError(f"replay_parow: steps must be [S, 1 + E], got "
                         f"{steps.shape}")
    e = steps.shape[1] - 1
    check_e("replay_parow", e)
    if steps.size and (int(steps.min()) < 0
                       or int(steps[:, 0].max()) >= pa_rows
                       or int(steps[:, 1:].max()) >= pb_rows):
        raise ValueError("replay_parow: step row outside pa_ext / pbx")
    if _on_cpu("replay_parow", ctx):
        return replay_parow_plain(acc, pa_ext, pbx, steps, one, ctx)
    lanes, digits, _per_block, _blocks = tape_geometry(nw, b)
    out = torch.empty_like(acc)
    dev = torch.from_numpy(steps).to(acc.device)
    _launch("replay_parow", ctx, "tpuecm_replay_parow", acc.data_ptr(),
            out.data_ptr(), pa_ext.data_ptr(), pbx.data_ptr(), dev.data_ptr(),
            one.data_ptr(), steps.shape[0], e, *_mod(ctx), b, lanes, digits)
    return out


class ResidentSmem(NamedTuple):
    """K8's shared memory a block at tape_geometry's lanes and digits
    (csrc/replay_resident.cu, tpuecm_replay_resident_smem): the kernel's
    static bytes, its slots' dynamic bytes, one slab row's bytes (the
    block's curves) and the device's opt-in limit a block."""
    static: int
    slots: int
    row: int
    optin: int

    def block_bytes(self, cap: int) -> int:
        """Dynamic bytes a block at a slab of cap rows: the slots, then
        the zero row and cap rows."""
        return self.slots + (cap + 1) * self.row

    @property
    def max_rows(self) -> int:
        """The tallest slab a block holds beside its slots and static
        memory, less the zero row."""
        return (self.optin - self.static - self.slots) // self.row - 1


def resident_smem(nw: int, device) -> ResidentSmem:
    """K8's shared memory at nw digits on `device` (the lanes and digits
    depend on nw alone)."""
    lanes, digits, _per_block, _blocks = tape_geometry(nw, 1)
    out = [ctypes.c_int() for _ in range(4)]
    with on_device(device):
        rc = build.library().tpuecm_replay_resident_smem(
            lanes, digits, *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"replay_resident: shared-memory query failed, "
                           f"CUDA error {rc}")
    return ResidentSmem(*(v.value for v in out))


def resident_blocks_per_sm(nw: int, cap: int, device) -> int:
    """Blocks of K8 an SM of `device` holds at a slab of cap rows (the
    card's occupancy calculator)."""
    lanes, digits, _per_block, _blocks = tape_geometry(nw, 1)
    per_sm = ctypes.c_int()
    with on_device(device):
        rc = build.library().tpuecm_replay_resident_occupancy(
            lanes, digits, cap, ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"replay_resident: occupancy query failed, CUDA "
                           f"error {rc}")
    return per_sm.value


def resident_slab_rows(nw: int, b: int, device) -> int:
    """The Pb rows of K8's slab at nw digits and B curves on `device`: the
    tallest slab at which an SM holds ceil(blocks / SMs) blocks, the
    launch in one wave, or as many blocks as any slab allows.  A taller
    slab means fewer segments, but a wave more costs more
    (tools/k8_time.py, PERF.md section 6)."""
    top = resident_smem(nw, device).max_rows
    if top < 1:
        raise ValueError(f"replay_resident: the device's shared memory per "
                         f"block holds no slab row at nw={nw}")
    blocks = tape_geometry(nw, b)[3]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = min(-(-blocks // sms), resident_blocks_per_sm(nw, 1, device))
    cap = top
    while cap > 1 and resident_blocks_per_sm(nw, cap, device) < want:
        cap -= 1
    return cap


def pbx_rows(entries: np.ndarray, slabs: np.ndarray, e: int) -> np.ndarray:
    """The pbx row of each entry of a K8 call: lo + u - 1 for a live local
    row u of its segment's slab, 0 (the zero row) for a pad (u = 0)."""
    lo = np.repeat(slabs[:, 0].astype(np.int64),
                   slabs[:, 2].astype(np.int64) * e)
    u = entries[:, 1].astype(np.int64)
    return np.where(u > 0, lo + u - 1, 0)


def check_slabs(name: str, slabs: np.ndarray, idx: np.ndarray, e: int,
                cap: int, pb_rows: int) -> np.ndarray:
    """slabs as contiguous int32 [S, 3] (lo, first step, steps): segments
    of whole steps covering the call's idx in order, each slab inside the
    Pb table, and every live entry's row lo + u - 1 in it."""
    slabs = np.ascontiguousarray(slabs, dtype=np.int32).reshape(-1, 3)
    nsteps = idx.shape[0] // e
    ends = np.cumsum(slabs[:, 2], dtype=np.int64)
    starts = ends - slabs[:, 2]
    if (slabs.size and (int(slabs[:, 2].min()) < 1
                        or int(slabs[:, 0].min()) < 0
                        or int(slabs[:, 0].max()) >= pb_rows)
            or not np.array_equal(slabs[:, 1], starts)
            or (ends[-1] if slabs.size else 0) != nsteps):
        raise ValueError(f"{name}: slabs must be [S, 3] (lo, first step, "
                         f"steps) segments covering the {nsteps} steps in "
                         f"order, each lo inside pbx")
    if cap < 1:
        raise ValueError(f"{name}: slab rows must be >= 1, got {cap}")
    if idx.size and int(pbx_rows(idx, slabs, e).max()) >= pb_rows:
        raise ValueError(f"{name}: entry row outside pbx")
    return slabs


def replay_resident(acc: torch.Tensor, pa_ext: torch.Tensor,
                    pbx: torch.Tensor, entries: np.ndarray,
                    slabs: np.ndarray, cap: int, ctx: DeviceCtx, *, e: int
                    ) -> torch.Tensor:
    """K8: acc * prod over the entries (pa, u) of entries [T, 2] of
    (pa_ext[pa] - slab[u]) in steps of e entries multiplied in a pairwise
    tree before acc, where the segment of slabs [S, 3] (lo, first step,
    steps) that holds the entry gives slab[0] = 0 and slab[u] = pbx[lo + u
    - 1] for 1 <= u <= cap, at tape_geometry's lanes and digits per curve.
    Returns a new [NW, B] plane, digit for digit the plain version's."""
    nw, b = ctx.p.nw, int(acc.shape[-1])
    pa_rows, pb_rows = int(pa_ext.shape[0]), int(pbx.shape[0])
    _check("replay_resident", "acc", acc, (nw, b), ctx)
    _check("replay_resident", "pa_ext", pa_ext, (pa_rows, nw, b), ctx)
    _check("replay_resident", "pbx", pbx, (pb_rows, nw, b), ctx)
    entries = check_pairs("replay_resident", entries, e, pa_rows, cap + 1)
    slabs = check_slabs("replay_resident", slabs, entries, e, cap, pb_rows)
    if _on_cpu("replay_resident", ctx):
        return replay_resident_plain(acc, pa_ext, pbx, entries, slabs, cap,
                                     e, ctx)
    if cap > resident_smem(nw, acc.device).max_rows:
        raise ValueError(f"replay_resident: a slab of {cap} rows does not "
                         f"fit the shared memory of a block at nw={nw}")
    lanes, digits, _per_block, _blocks = tape_geometry(nw, b)
    out = torch.empty_like(acc)
    dev_e = torch.from_numpy(entries).to(acc.device)
    dev_s = torch.from_numpy(slabs).to(acc.device)
    _launch("replay_resident", ctx, "tpuecm_replay_resident", acc.data_ptr(),
            out.data_ptr(), pa_ext.data_ptr(), pbx.data_ptr(), pb_rows,
            dev_e.data_ptr(), dev_s.data_ptr(), slabs.shape[0], cap, e,
            *_mod(ctx), b, lanes, digits)
    return out


# ---------------------------------------------------------------------------
# plain versions of K2-K8 (the twins of tpu_ecm/stage2/exec.py:104-173 and
# of the Pallas replay kernels' steps)
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


def replay_gather_plain(acc: torch.Tensor, pa_ext: torch.Tensor,
                        pbx: torch.Tensor, idx: np.ndarray, e: int,
                        ctx: DeviceCtx) -> torch.Tensor:
    """K6 in the kernel's association: each difference gets one lazy pass,
    each step's e differences multiply in the pairwise tree (one batched
    product per level over a block of steps), the roots into acc in
    order."""
    mul = lambda x, y: torch_ops.mulmod(x, y, ctx, pre=True)
    ent = torch.from_numpy(idx.astype(np.int64)).to(acc.device)
    for lo in range(0, ent.shape[0], PLAIN_REPLAY_BLOCK):
        blk = ent[lo:lo + PLAIN_REPLAY_BLOCK]
        d = torch_ops._norm_out(pa_ext[blk[:, 0]] - pbx[blk[:, 1]], ctx)
        for root in step_roots(d, e, mul):
            acc = mul(acc, root)
    return acc


def replay_parow_plain(acc: torch.Tensor, pa_ext: torch.Tensor,
                       pbx: torch.Tensor, steps: np.ndarray,
                       one: torch.Tensor, ctx: DeviceCtx) -> torch.Tensor:
    """K7 in the kernel's association: per step, the values
    pa_ext[pa] - pbx[pb_k] with one lazy pass each, `one` where pb_k == 0,
    multiplied in the pairwise tree, the roots into acc in order."""
    e = steps.shape[1] - 1
    mul = lambda x, y: torch_ops.mulmod(x, y, ctx, pre=True)
    st = torch.from_numpy(steps.astype(np.int64)).to(acc.device)
    for lo in range(0, st.shape[0], PLAIN_REPLAY_BLOCK // e):
        blk = st[lo:lo + PLAIN_REPLAY_BLOCK // e]
        pb = blk[:, 1:].reshape(-1)
        d = torch_ops._norm_out(
            pa_ext[blk[:, 0].repeat_interleave(e)] - pbx[pb], ctx)
        d = torch.where((pb == 0)[:, None, None], one, d)
        for root in step_roots(d, e, mul):
            acc = mul(acc, root)
    return acc


def replay_resident_plain(acc: torch.Tensor, pa_ext: torch.Tensor,
                          pbx: torch.Tensor, entries: np.ndarray,
                          slabs: np.ndarray, cap: int, e: int,
                          ctx: DeviceCtx) -> torch.Tensor:
    """K8 in the kernel's association: each local row mapped back to its
    pbx row (pbx_rows; a pad takes zeros, not pbx[0]), then K6's: one lazy
    pass per difference, each step's e differences in the pairwise tree,
    the roots into acc in order.  cap only bounds u (checked by the
    wrapper)."""
    mul = lambda x, y: torch_ops.mulmod(x, y, ctx, pre=True)
    dev = acc.device
    rows = torch.from_numpy(pbx_rows(entries, slabs, e)).to(dev)
    pa = torch.from_numpy(entries[:, 0].astype(np.int64)).to(dev)
    keep = torch.from_numpy(entries[:, 1] > 0).to(dev)[:, None, None]
    for a in range(0, entries.shape[0], PLAIN_REPLAY_BLOCK):
        z = slice(a, a + PLAIN_REPLAY_BLOCK)
        pb = torch.where(keep[z], pbx[rows[z]], 0)
        d = torch_ops._norm_out(pa_ext[pa[z]] - pb, ctx)
        for root in step_roots(d, e, mul):
            acc = mul(acc, root)
    return acc
