// K6 and K7, stage 2: the pairmap replay acc *= prod over entries of
// (Pa_inv[pa] - Pb[pb]) in the two step forms of the Pallas gather kernels.
//
//  * K6, replay_gather, replaces tpu_ecm/limbs/pallas_ops.py:
//    make_replay_executor (:735, its kernel at :664).  idx = [T, 2] int32
//    (pa, pb) pairs, T a multiple of E; each step takes E entries.  A pad
//    entry (G, 0) reads pa_ext[G] = the one (R mod n in REDC mode, 1 in
//    fold mode) and pbx[0] = 0.
//  * K7, replay_parow, replaces pallas_ops.py:make_replay_parow_executor
//    (:834, its kernel at :761).  steps = [S, 1 + E] int32 rows [pa, pb_0
//    .. pb_{E-1}]: the E entries of a step share one Pa row, which is read
//    once per step.  An entry with pb == 0 takes the `one` plane itself
//    (no lazy pass) instead of pa - pbx[0] (a pad inside a step would
//    otherwise multiply by pa); a whole pad step has pa = G.
//
// Bound on the H100: integer multiply-adds, (E-1)/E + 1/E = 1 modular
// product per entry, against two nw*4-byte row gathers per entry and curve
// in K6 and 1 + 1/E in K7 (a v-sorted call's Pa rows repeat, so they mostly
// stay in L2; the Pb rows come from device memory).
//
// Design: one kernel body with K8, replay_gather_lanes<D, MODE> of
// csrc/replay_passes.cuh (its tree of paired passes, the lane core
// csrc/arith_lanes.cuh), in its RG_GATHER and RG_PAROW forms: each leaf
// group's Pb rows are copied with cp.async a group ahead into one of two
// buffers of four slots and the differences formed over them.
#include "replay_passes.cuh"

#ifdef __CUDACC__
template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
replay_gather_lanes_kernel(const int* __restrict__ acc_in,
                           int* __restrict__ acc_out,
                           const int* __restrict__ pa_ext,
                           const int* __restrict__ pbx,
                           const int* __restrict__ idx, int nsteps, int E,
                           TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    replay_gather_lanes<D, RG_GATHER>(m, smem, acc_in, acc_out, pa_ext, pbx,
                                      idx, nullptr, nsteps, E,
                                      TPUECM_MOD_ARGS, B, L);
}

template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
replay_parow_lanes_kernel(const int* __restrict__ acc_in,
                          int* __restrict__ acc_out,
                          const int* __restrict__ pa_ext,
                          const int* __restrict__ pbx,
                          const int* __restrict__ steps,
                          const int* __restrict__ one, int nsteps, int E,
                          TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    replay_gather_lanes<D, RG_PAROW>(m, smem, acc_in, acc_out, pa_ext, pbx,
                                     steps, one, nsteps, E, TPUECM_MOD_ARGS,
                                     B, L);
}

extern "C" int tpuecm_replay_gather(const int* acc_in, int* acc_out,
                                    const int* pa_ext, const int* pbx,
                                    const int* idx, int nsteps, int E,
                                    TPUECM_MOD_PARAMS, int B, int lanes,
                                    int digits, void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits)
        || !step_args_ok(nsteps, E))
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes<D, RG_SLOTS>(
            replay_gather_lanes_kernel<D>, lanes, B, (cudaStream_t)stream,
            acc_in, acc_out, pa_ext, pbx, idx, nsteps, E, TPUECM_MOD_ARGS, B,
            lanes);
    });
}

extern "C" int tpuecm_replay_parow(const int* acc_in, int* acc_out,
                                   const int* pa_ext, const int* pbx,
                                   const int* steps, const int* one,
                                   int nsteps, int E, TPUECM_MOD_PARAMS,
                                   int B, int lanes, int digits,
                                   void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits)
        || !step_args_ok(nsteps, E))
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes<D, RG_SLOTS>(
            replay_parow_lanes_kernel<D>, lanes, B, (cudaStream_t)stream,
            acc_in, acc_out, pa_ext, pbx, steps, one, nsteps, E,
            TPUECM_MOD_ARGS, B, lanes);
    });
}

TPUECM_LANES_OCCUPANCY_SLOTS(tpuecm_replay_gather_occupancy,
                             replay_gather_lanes_kernel, RG_SLOTS)
TPUECM_LANES_OCCUPANCY_SLOTS(tpuecm_replay_parow_occupancy,
                             replay_parow_lanes_kernel, RG_SLOTS)
#endif
