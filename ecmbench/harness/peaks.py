"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), the card of every
cell: the rates a kernel's roofline share is taken against.

int32 multiply-adds: 64 per SM per clock (CUDA C++ Programming Guide,
throughput of native arithmetic instructions, compute capability 9.0) x
132 SMs x 1.98 GHz, the boost clock behind the data sheet's 67 TFLOP/s of
float32 (132 x 128 x 2 x 1.98e9).  HBM3: 3.35 TB/s.  int8 tensor-core
operations, dense: 1,979 TOPS (two a multiply-add).  All assume the card's
full 700 W; a run writes the card's power limit beside its numbers.
"""

IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
TENSOR_INT8_OPS_PER_S = 1.979e15


def bound_s(ops_s: float, nbytes: float) -> float:
    """The least seconds of work that takes ops_s seconds at its compute
    peak and moves nbytes: the larger of the two."""
    return max(ops_s, nbytes / HBM_BYTES_PER_S)
