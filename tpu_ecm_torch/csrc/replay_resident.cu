// K8, stage 2: the pairmap replay acc *= prod over entries of
// (Pa_inv[pa] - Pb[pb]) with the Pb rows read from a slab held in shared
// memory.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:make_replay_resident_executor
// (:1231, its kernel at :1152), which copies one slab of Pb rows (up to
// 80 MB) into VMEM per call and indexes it per entry.  A block of this
// card has at most 227 KB of shared memory, so the slab here is per block:
// rows [lo, lo + cap) of pbx for the block's curves.  Local row 0 is the
// zero row and local row u >= 1 is pbx row lo + u - 1.
//
// idx = [T, 2] int32 (pa, local slab row) pairs in steps of E entries;
// slabs = [S, 3] int32 (lo, first step, steps): the call's entries run in
// S slab segments, each over one slab, in order.  A pad entry (G, 0) reads
// pa_ext[G] = the one and the zero row.  Each difference gets one lazy
// pass and each step's E differences multiply in the Pallas kernels'
// pairwise tree before the root goes into acc, so the digits equal the
// plain version's (limbs/kernels.py:replay_resident_plain).
//
// Bound on the H100: integer multiply-adds, one modular product per entry,
// as K6.  The slab replaces K6's Pb row gathers; each block reads its
// slice of a slab's rows once per segment, so a call reads each Pb row of
// the slabs it loads once over all blocks.
//
// Design: K6's body in its RG_RESIDENT form (replay_gather_lanes<D,
// RG_RESIDENT> of csrc/replay_passes.cuh, on the lane core
// csrc/arith_lanes.cuh at tape_geometry's lanes and digits): the same
// table of paired passes, the Pa row in a slot reloaded when pa changes,
// a leaf group's differences formed from slab rows into one buffer of four
// slots (RR_SLOTS = 12 a curve, K6's 16 less its second buffer: each slot
// given up is slab room).  The slab follows the slots in dynamic shared
// memory, [cap + 1][curves a block][L*D], each row in the slots' digit
// order with digits nw.. zero.  At each segment every thread of the block
// passes a barrier (the last segment's reads are done), cp.asyncs its
// share of rows lo .. lo + cap - 1, waits, and passes a second; a lane
// past the batch computes on the last curve and stores nothing, so it
// reaches both.  Row offsets are size_t (lo * nw * B overflows int at the
// flagship).
#include "replay_passes.cuh"

// Dynamic shared-memory bytes of one slab row: the block's curves, L*D
// digits each.
__host__ __device__ inline size_t resident_row_bytes(int L, int D) {
    return sizeof(int) * (size_t)(TPUECM_TAPE_BLOCK / L) * L * D;
}

// K8's dynamic shared memory at L lanes of D digits and a slab of cap
// rows: the slots, then cap + 1 slab rows.
__host__ inline size_t resident_smem_bytes(int L, int D, int cap) {
    return lanes_smem_bytes(L, D, RR_SLOTS)
           + (size_t)(cap + 1) * resident_row_bytes(L, D);
}

// The kernel body of K8 for one thread (the __global__ wrapper below;
// tools/lane_shim runs it on the CPU): the call's steps are its
// segments' steps.
template <int D>
__device__ __forceinline__ void replay_resident_lanes(
    Mod& m, int* smem, const int* __restrict__ acc_in,
    int* __restrict__ acc_out, const int* __restrict__ pa_ext,
    const int* __restrict__ pbx, int pb_rows, const int* __restrict__ idx,
    const int* __restrict__ slabs, int nslabs, int cap, int E,
    TPUECM_MOD_PARAMS, int B, int L) {
    const int nsteps =
        nslabs > 0 ? slabs[3 * nslabs - 2] + slabs[3 * nslabs - 1] : 0;
    replay_gather_lanes<D, RG_RESIDENT>(
        m, smem, acc_in, acc_out, pa_ext, pbx, idx, nullptr, nsteps, E,
        TPUECM_MOD_ARGS, B, L, RgSlabs{slabs, nslabs, cap, pb_rows});
}

#ifdef __CUDACC__
template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
replay_resident_lanes_kernel(const int* __restrict__ acc_in,
                             int* __restrict__ acc_out,
                             const int* __restrict__ pa_ext,
                             const int* __restrict__ pbx, int pb_rows,
                             const int* __restrict__ idx,
                             const int* __restrict__ slabs, int nslabs,
                             int cap, int E, TPUECM_MOD_PARAMS, int B,
                             int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    replay_resident_lanes<D>(m, smem, acc_in, acc_out, pa_ext, pbx, pb_rows,
                             idx, slabs, nslabs, cap, E, TPUECM_MOD_ARGS, B,
                             L);
}

// What the slab height rule needs at `lanes` lanes of `digits` digits
// (limbs/kernels.py:resident_smem): the kernel's static shared memory, its
// slots' dynamic bytes, one slab row's bytes and the device's opt-in limit
// of shared memory a block; leaves no error for the next launch.
extern "C" int tpuecm_replay_resident_smem(int lanes, int digits,
                                           int* static_bytes,
                                           int* slots_bytes, int* row_bytes,
                                           int* optin_bytes) {
    if (!lanes_ok(lanes)) return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        cudaFuncAttributes attr;
        int dev = 0;
        cudaError_t err = cudaFuncGetAttributes(
            &attr, replay_resident_lanes_kernel<D>);
        if (err == cudaSuccess) err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                optin_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err != cudaSuccess) {
            (void)cudaGetLastError();
            return (int)err;
        }
        *static_bytes = (int)attr.sharedSizeBytes;
        *slots_bytes = (int)lanes_smem_bytes(lanes, D, RR_SLOTS);
        *row_bytes = (int)resident_row_bytes(lanes, D);
        return 0;
    });
}

// Resident blocks per SM of K8 at `lanes` lanes of `digits` digits with a
// slab of cap rows (its shared memory allowed first).
extern "C" int tpuecm_replay_resident_occupancy(int lanes, int digits,
                                                int cap,
                                                int* blocks_per_sm) {
    if (!lanes_ok(lanes) || cap < 1) return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        const size_t smem = resident_smem_bytes(lanes, D, cap);
        cudaError_t err = cudaFuncSetAttribute(
            replay_resident_lanes_kernel<D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) {
            (void)cudaGetLastError();
            return (int)err;
        }
        return lanes_occupancy<D, RR_SLOTS>(
            replay_resident_lanes_kernel<D>, lanes, blocks_per_sm,
            smem - lanes_smem_bytes(lanes, D, RR_SLOTS));
    });
}

// cudaErrorInvalidValue for a geometry no instantiation takes, a step
// shape K6 refuses, a slab below one row and a slab taller than a block's
// shared memory holds (the last from the launcher, cleared)
extern "C" int tpuecm_replay_resident(const int* acc_in, int* acc_out,
                                      const int* pa_ext, const int* pbx,
                                      int pb_rows, const int* idx,
                                      const int* slabs, int nslabs, int cap,
                                      int E, TPUECM_MOD_PARAMS, int B,
                                      int lanes, int digits, void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits)
        || !step_args_ok(nslabs, E) || cap < 1 || pb_rows < 1)
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes_smem(
            replay_resident_lanes_kernel<D>, lanes, B,
            resident_smem_bytes(lanes, D, cap), (cudaStream_t)stream,
            acc_in, acc_out, pa_ext, pbx, pb_rows, idx, slabs, nslabs, cap,
            E, TPUECM_MOD_ARGS, B, lanes);
    });
}
#endif
