// K14, stage 2 of the RNS engine: the pairmap replay acc *= prod over
// entries of (Pa_inv[pa] - Pb[pb]) in gather form, on [2K+1, B] residue
// planes.
//
// Replaces tpu_ecm/limbs/rns_exec.py:make_rns_replay_executor, the RNS
// twin of the digit engine's gather kernel (K6, csrc/replay_gather.cu).
//
// idx = [T, 2] int32 (pa, pb) pairs, T a multiple of E; each step takes E
// entries.  Each difference is sub(pa_ext[pa], pbx[pb]) (rns_arith.cuh:
// rns_sub, x - y + F); the step's E differences multiply in the pairwise
// tree of the Pallas kernel (rns_exec.py:452-457) and the root goes into
// acc once, so the residues equal that kernel's and the plain version's
// exactly.  The tree is reduced with a stack of log2(E)+1 partial
// products, merging equal heights with the earlier one on the left: for E a
// power of two, the Pallas tree.  A pad entry (G, 0) multiplies by
// sub(one, 0) = one + F, which is one mod n.
//
// Bound on the H100: integer multiply-adds, one RNS product per entry
// (about 2*K*(K+1) multiply-adds per curve) with the extension matrices in
// shared memory, against two row gathers of (2K+1)*4 bytes per entry and
// curve.  The tree leaves one product per step on acc's dependent chain.
//
// Design: the launch geometry and lanes of K15 (csrc/rns_replay.cu): every
// lane reads the same index entry (uniform across the block, as rns_mul's
// barriers require) and keeps acc and the stack for the whole call.
#include "rns_arith.cuh"

#define RNS_E_MAX 16
#define RNS_STACK 5        // log2(RNS_E_MAX) + 1 partial products

__global__ void __launch_bounds__(RNS_MAX_THREADS)
rns_replay_gather_kernel(const int* __restrict__ acc_in,
                         int* __restrict__ acc_out,
                         const int* __restrict__ pa_ext,
                         const int* __restrict__ pbx,
                         const int* __restrict__ idx, int nsteps, int E,
                         const int* __restrict__ tab,
                         const int* __restrict__ wpk, int K, int B,
                         int resident) {
    RnsLane L;
    rns_setup(L, tab, wpk, K, B, resident);
    const size_t row = (size_t)(2 * K + 1) * B;
    RV acc, a, part[RNS_STACK];
    load_rv(acc, acc_in, L);
    for (int s = 0; s < nsteps; ++s) {
        const int* ent = idx + 2 * (size_t)s * E;
        int top = 0;
        for (int k = 0; k < E; ++k) {
            RV& d = part[top++];
            load_rv(a, pa_ext + (uint32_t)ent[2 * k] * row, L);
            load_rv(d, pbx + (uint32_t)ent[2 * k + 1] * row, L);
            rns_sub(d, a, d, L);
            for (int h = k + 1; (h & 1) == 0; h >>= 1) {
                rns_mul(part[top - 2], part[top - 2], part[top - 1], L);
                --top;
            }
        }
        rns_mul(acc, acc, part[0], L);
    }
    store_rv(acc_out, acc, L);
}

extern "C" int tpuecm_rns_replay_gather(const int* acc_in, int* acc_out,
                                        const int* pa_ext, const int* pbx,
                                        const int* idx, int nsteps, int E,
                                        const int* tab, const int* wpk,
                                        int K, int B, void* stream) {
    if (nsteps < 0 || E < 1 || E > RNS_E_MAX || (E & (E - 1)))
        return (int)cudaErrorInvalidValue;
    RnsLaunch c;
    const int rc = rns_launch_config(rns_replay_gather_kernel, K, B, c);
    if (rc != (int)cudaSuccess) return rc;
    rns_replay_gather_kernel<<<c.grid, c.block, c.smem, (cudaStream_t)stream>>>(acc_in, acc_out, pa_ext, pbx, idx, nsteps, E, tab, wpk, K, B, c.resident);
    return (int)cudaGetLastError();
}
