// K2, stage 2: the differential-add chain out[i] = out[i-1] + Pd with
// difference out[i-2], seeded by (out[-1], out[-2]) = (p1, p2), from points
// [2, NW, B] to [count, 2, NW, B].  It builds the baby-step (Pb) table and
// the giant-step (Pa) groups.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:make_chain_executor, whose
// sequential grid carried the running pair in VMEM scratch and wrote one
// point per grid step.  A row is the xadd of pallas_ops._point_ops and
// curve/ops.xadd, so the digits are equal.
//
// Bound on the H100: integer multiply-adds.  A row is 6 dependent modular
// products (4M+2S) per curve against 2*nw*4 bytes of output per curve; the
// inputs are read once per launch.
//
// Design (csrc/arith_lanes.cuh, as K1, K5 and K9): a group of L lanes works
// on one curve, each lane owning D digits of every value, the products'
// columns in registers; limbs/kernels.py:tape_geometry picks L and D.  The
// blocks' sequential grid becomes a loop over rows inside the group.  The
// running pair and Pd stay in the curve's shared-memory slots for the
// whole launch: p1 (cur) in X, Z and p2 (prev) in XD, ZD, loaded once;
// Pd's sum and difference, the same in every row, are formed once into X2,
// Z2.  A row is three paired product steps, (U, V), ((U+V)^2, (U-V)^2)
// and (X+, Z+), with four sums and differences between them.  The last
// pair writes X+ and Z+ over prev's own slots (mul_slots lets a
// destination be an operand), so prev and cur swap roles each row instead
// of being copied: program K2_A runs on cur in X, Z, K2_B on cur in XD,
// ZD, from one macro.  Each row ends in one store of the new point's two
// planes from the slots its program wrote.  One call site of run_steps, so
// the kernel holds one copy of the product.  A lane past the batch
// computes on the last curve and stores nothing, so every lane reaches
// every shuffle and barrier.
#include "arith_lanes.cuh"

// One chain row on cur in (cx, cz) and prev in (px, pz), with Pd's sum and
// difference in (X2, Z2): U = (cx-cz)(X2+Z2), V = (cx+cz)(X2-Z2),
// X+ = pz*(U+V)^2 and Z+ = px*(U-V)^2 into (px, pz).
#define K2_ROW(cx, cz, px, pz)                                               \
    TPUECM_STEP(STEP_ADD, T0, cx, cz),                                       \
    TPUECM_STEP(STEP_SUB, T1, cx, cz),                                       \
    TPUECM_MUL2(T1, T1, X2, T0, T0, Z2),                                     \
    TPUECM_STEP(STEP_ADD, T2, T1, T0),                                       \
    TPUECM_STEP(STEP_SUB, T3, T1, T0),                                       \
    TPUECM_MUL2(T2, T2, T2, T3, T3, T3),                                     \
    TPUECM_MUL2(px, T2, pz, pz, T3, px)

__device__ const int K2_A[] = {K2_ROW(X, Z, XD, ZD)};
__device__ const int K2_B[] = {K2_ROW(XD, ZD, X, Z)};
#define K2_STEPS 7

// The kernel body for one thread (a __global__ wrapper below; tools/
// lane_shim runs it on the CPU).  m and smem are the block's shared Mod
// and dynamic shared memory.
template <int D>
__device__ __forceinline__ void chain_lanes(
    Mod& m, int* smem, const int* __restrict__ p1,
    const int* __restrict__ p2, const int* __restrict__ pd,
    int* __restrict__ out, int count, TPUECM_MOD_PARAMS, int B, int L) {
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D>(smem, L, m);
    const int curve = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
    const bool live = curve < B;
    const int col = live ? curve : B - 1;
    const size_t sB = (size_t)B;
    const size_t plane = (size_t)nw * sB;     // X -> Z within a point
    load_slot<D>(g.slot(SLOT_X), p1 + col, sB, g, nw);
    load_slot<D>(g.slot(SLOT_Z), p1 + plane + col, sB, g, nw);
    load_slot<D>(g.slot(SLOT_XD), p2 + col, sB, g, nw);
    load_slot<D>(g.slot(SLOT_ZD), p2 + plane + col, sB, g, nw);
    load_slot<D>(g.slot(SLOT_T0), pd + col, sB, g, nw);
    load_slot<D>(g.slot(SLOT_T1), pd + plane + col, sB, g, nw);
    // each lane reads only its own digits here, so no barrier is needed
    addsub_slots<D>(g.slot(SLOT_X2), g.slot(SLOT_T0), g.slot(SLOT_T1),
                    false, g);
    addsub_slots<D>(g.slot(SLOT_Z2), g.slot(SLOT_T0), g.slot(SLOT_T1),
                    true, g);
    int* row = out + col;
#pragma unroll 1
    for (int i = 0; i < count; ++i, row += 2 * plane) {
        const bool odd = i & 1;
        run_steps<D>(odd ? K2_B : K2_A, K2_STEPS, g);
        if (live) {
            store_slot<D>(row, g.slot(odd ? SLOT_X : SLOT_XD), sB, g, nw);
            store_slot<D>(row + plane, g.slot(odd ? SLOT_Z : SLOT_ZD), sB,
                          g, nw);
        }
    }
}

#ifdef __CUDACC__
template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
chain_lanes_kernel(const int* __restrict__ p1, const int* __restrict__ p2,
                   const int* __restrict__ pd, int* __restrict__ out,
                   int count, TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    chain_lanes<D>(m, smem, p1, p2, pd, out, count, TPUECM_MOD_ARGS, B, L);
}

extern "C" int tpuecm_chain(const int* p1, const int* p2, const int* pd,
                            int* out, int count, TPUECM_MOD_PARAMS, int B,
                            int lanes, int digits, void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits) || count < 1)
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes<D>(chain_lanes_kernel<D>, lanes, B,
                               (cudaStream_t)stream, p1, p2, pd, out, count,
                               TPUECM_MOD_ARGS, B, lanes);
    });
}

TPUECM_LANES_OCCUPANCY(tpuecm_chain_occupancy, chain_lanes_kernel)
#endif
