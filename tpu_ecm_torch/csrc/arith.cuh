// The modulus context of the digit kernels (K1-K9), which run on the lane
// core arith_lanes.cuh: one build serves both reductions, chosen at run
// time by Mod.e (limbs/kernels.py:_mod passes the arguments):
//
//  * REDC (e == 0), a generic odd n: Montgomery reduction by digit-serial
//    quotients q = t*nprime mod 2^w (jnp_ops._redc);
//  * fold (e > 0), a special form M = 2^e - c (pallas_ops.py:271-308,
//    jnp_ops._mersenne_reduce): lo + sign*|c|*(t >> e), e = k0*w + s.
//
// nw is a run-time value bounded by TPUECM_NW_MAX, and the digit count of
// |c| by TPUECM_CL_MAX (both set by limbs/build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#if !defined(TPUECM_NW_MAX) || !defined(TPUECM_CL_MAX)
#error "TPUECM_NW_MAX and TPUECM_CL_MAX must be set by limbs/build.py"
#endif

// Modulus context of one launch, loaded into shared memory by every block.
struct Mod {
    int nw, w, mask, norm;   // norm: params.ArithParams.norm_inputs
    uint32_t nprime;         // REDC: -n^-1 mod 2^w
    int e, k0, s;            // fold: M = 2^e - c, e = k0*w + s (0: REDC)
    int cl, csign;           // fold: digits of |c| and the sign of c
    int c[TPUECM_CL_MAX];    // fold: digits of |c|
    int n[TPUECM_NW_MAX];    // digits of n
};

// The modulus arguments every kernel and entry point takes, in this order
// (limbs/kernels.py:_mod passes them).
#define TPUECM_MOD_PARAMS                                                    \
    const int *__restrict__ ndig, const int *__restrict__ cdig, int cl,     \
        int e, int csign, int nw, int w, int nprime, int norm
#define TPUECM_MOD_ARGS ndig, cdig, cl, e, csign, nw, w, nprime, norm

// Call with every thread of the block, before any thread returns.
__device__ __forceinline__ void load_mod(Mod& m, TPUECM_MOD_PARAMS) {
    for (int j = threadIdx.x; j < nw; j += blockDim.x) m.n[j] = ndig[j];
    for (int j = threadIdx.x; j < cl; j += blockDim.x) m.c[j] = cdig[j];
    if (threadIdx.x == 0) {
        m.nw = nw;
        m.w = w;
        m.mask = (1 << w) - 1;
        m.norm = norm;
        m.nprime = (uint32_t)nprime;
        m.e = e;
        m.k0 = e / w;
        m.s = e % w;
        m.cl = cl;
        m.csign = csign;
    }
    __syncthreads();
}

// The host-side checks of an entry point's arguments.
__host__ inline bool mod_args_ok(int nw, int e, int cl, int w) {
    if (nw < 2 || nw > TPUECM_NW_MAX || w < 1 || w > 13) return false;
    return e == 0 || (cl >= 1 && cl <= TPUECM_CL_MAX && cl <= e / w
                      && e / w < nw);
}
