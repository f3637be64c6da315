// K6 and K7, stage 2: the pairmap replay acc *= prod over entries of
// (Pa_inv[pa] - Pb[pb]) in the two step forms of the Pallas gather kernels.
//
//  * K6, replay_gather, replaces tpu_ecm/limbs/pallas_ops.py:
//    make_replay_executor.  idx = [T, 2] int32 (pa, pb) pairs, T a multiple
//    of E; each step takes E entries.  A pad entry (G, 0) reads
//    pa_ext[G] = the one (R mod n in REDC mode, 1 in fold mode) and
//    pbx[0] = 0.
//  * K7, replay_parow, replaces pallas_ops.py:make_replay_parow_executor.
//    steps = [S, 1 + E] int32 rows [pa, pb_0 .. pb_{E-1}]: the E entries of
//    a step share one Pa row, which is read once per step.  An entry with
//    pb == 0 takes the `one` plane instead of pa - pbx[0] (a pad inside a
//    step would otherwise multiply by pa); a whole pad step has pa = G.
//
// In both, each difference gets one lazy pass and the step's E differences
// multiply in the pairwise tree of the Pallas kernels (replay_tree.cuh),
// then the root goes into acc once, so the digits equal the plain
// versions'.
//
// Bound on the H100: integer multiply-adds, (E-1)/E + 1/E = 1 modular
// product per entry on one thread per curve, against two nw*4-byte row
// gathers per entry and curve in K6 and 1 + 1/E in K7 (coalesced across the
// warp; a v-sorted step's Pa row is mostly an L1/L2 hit).  The tree leaves
// one product per step on acc's dependent chain, but every product of a
// thread still runs in sequence.
//
// Design: as K5 (csrc/replay.cu), every thread reads the same index entry
// (uniform, no divergence) and keeps acc, the stack and (K7) the Pa row in
// local arrays for the whole call.
#include "replay_tree.cuh"

__global__ void __launch_bounds__(TPUECM_THREADS)
replay_gather_kernel(const int* __restrict__ acc_in, int* __restrict__ acc_out,
                     const int* __restrict__ pa_ext,
                     const int* __restrict__ pbx, const int* __restrict__ idx,
                     int nsteps, int E, TPUECM_MOD_PARAMS, int B) {
    __shared__ Mod m;
    load_mod(m, TPUECM_MOD_ARGS);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const size_t sB = (size_t)B;
    const size_t row = (size_t)nw * sB;
    pa_ext += b;
    pbx += b;
    int acc[TPUECM_NW_MAX], part[TPUECM_STACK][TPUECM_NW_MAX];
    load_row(acc, acc_in + b, sB, nw);
    for (int s = 0; s < nsteps; ++s) {
        const int* ent = idx + 2 * (size_t)s * E;
        int top = 0;
        for (int k = 0; k < E; ++k) {
            const int* pa = pa_ext + (uint32_t)ent[2 * k] * row;
            const int* pb = pbx + (uint32_t)ent[2 * k + 1] * row;
            int* d = part[top++];
            for (int j = 0; j < nw; ++j)
                d[j] = (int)((uint32_t)pa[(size_t)j * sB]
                             - (uint32_t)pb[(size_t)j * sB]);
            norm1(d, m);
            merge_tree(part, top, k, m);
        }
        mulmod(acc, acc, part[0], m);
    }
    store_row(acc_out + b, acc, sB, nw);
}

__global__ void __launch_bounds__(TPUECM_THREADS)
replay_parow_kernel(const int* __restrict__ acc_in, int* __restrict__ acc_out,
                    const int* __restrict__ pa_ext,
                    const int* __restrict__ pbx,
                    const int* __restrict__ steps,
                    const int* __restrict__ one, int nsteps, int E,
                    TPUECM_MOD_PARAMS, int B) {
    __shared__ Mod m;
    load_mod(m, TPUECM_MOD_ARGS);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const size_t sB = (size_t)B;
    const size_t row = (size_t)nw * sB;
    pa_ext += b;
    pbx += b;
    int acc[TPUECM_NW_MAX], pa[TPUECM_NW_MAX],
        part[TPUECM_STACK][TPUECM_NW_MAX];
    load_row(acc, acc_in + b, sB, nw);
    for (int s = 0; s < nsteps; ++s) {
        const int* st = steps + (size_t)s * (1 + E);
        load_row(pa, pa_ext + (uint32_t)st[0] * row, sB, nw);
        int top = 0;
        for (int k = 0; k < E; ++k) {
            const uint32_t u = (uint32_t)st[1 + k];
            int* d = part[top++];
            if (u == 0) {
                load_row(d, one + b, sB, nw);
            } else {
                const int* pb = pbx + u * row;
                for (int j = 0; j < nw; ++j)
                    d[j] = (int)((uint32_t)pa[j]
                                 - (uint32_t)pb[(size_t)j * sB]);
                norm1(d, m);
            }
            merge_tree(part, top, k, m);
        }
        mulmod(acc, acc, part[0], m);
    }
    store_row(acc_out + b, acc, sB, nw);
}

extern "C" int tpuecm_replay_gather(const int* acc_in, int* acc_out,
                                    const int* pa_ext, const int* pbx,
                                    const int* idx, int nsteps, int E,
                                    TPUECM_MOD_PARAMS, int B, void* stream) {
    if (!mod_args_ok(nw, e, cl, w) || !step_args_ok(nsteps, E) || B < 1)
        return (int)cudaErrorInvalidValue;
    const int blocks = (B + TPUECM_THREADS - 1) / TPUECM_THREADS;
    replay_gather_kernel<<<blocks, TPUECM_THREADS, 0, (cudaStream_t)stream>>>(acc_in, acc_out, pa_ext, pbx, idx, nsteps, E, TPUECM_MOD_ARGS, B);
    return (int)cudaGetLastError();
}

extern "C" int tpuecm_replay_parow(const int* acc_in, int* acc_out,
                                   const int* pa_ext, const int* pbx,
                                   const int* steps, const int* one,
                                   int nsteps, int E, TPUECM_MOD_PARAMS,
                                   int B, void* stream) {
    if (!mod_args_ok(nw, e, cl, w) || !step_args_ok(nsteps, E) || B < 1)
        return (int)cudaErrorInvalidValue;
    const int blocks = (B + TPUECM_THREADS - 1) / TPUECM_THREADS;
    replay_parow_kernel<<<blocks, TPUECM_THREADS, 0, (cudaStream_t)stream>>>(acc_in, acc_out, pa_ext, pbx, steps, one, nsteps, E, TPUECM_MOD_ARGS, B);
    return (int)cudaGetLastError();
}
