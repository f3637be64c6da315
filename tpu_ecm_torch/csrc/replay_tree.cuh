// The pairwise tree of the one-thread gather-form replay, K8
// (replay_resident.cu): the E differences of a step multiply as
// ((d0 d1)(d2 d3))..., the Pallas kernels' tree (pallas_ops.py:703-708,
// 807-810), before the root goes into acc once.  K6 and K7 on the lane
// core (replay_gather.cu) walk the same tree in paired passes and take
// step_args_ok from here.
//
// The tree is reduced with a stack of log2(E)+1 partial products: a new
// difference is pushed, and while the two on top have equal height they
// merge, the earlier one on the left.  For E a power of two this is the
// Pallas tree exactly, so the digits equal the plain versions'.
#pragma once

#include "arith.cuh"

#define TPUECM_E_MAX 16
#define TPUECM_STACK 5     // log2(TPUECM_E_MAX) + 1 partial products

__host__ inline bool step_args_ok(int nsteps, int E) {
    return nsteps >= 0 && E >= 1 && E <= TPUECM_E_MAX && (E & (E - 1)) == 0;
}

// After pushing difference k (0-based) of a step: merge equal heights.
__device__ __forceinline__ void merge_tree(int (*part)[TPUECM_NW_MAX],
                                           int& top, int k, const Mod& m) {
    for (int h = k + 1; (h & 1) == 0; h >>= 1) {
        mulmod(part[top - 2], part[top - 2], part[top - 1], m);
        --top;
    }
}
