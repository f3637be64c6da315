// K8, stage 2: the pairmap replay acc *= prod over entries of
// (Pa_inv[pa] - Pb[pb]) with the Pb rows read from a slab held in shared
// memory.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:make_replay_resident_executor, which
// copies one slab of Pb rows (up to 80 MB) into VMEM per call and indexes
// it per entry.  A block of this card has at most 227 KB of shared memory,
// so the slab here is per 32-curve tile: rows [lo, lo + cap) of pbx for the
// block's 32 curves, laid out [row][digit][lane] (a warp's load of one
// digit coalesces, and its reads of one row hit 32 distinct banks).  Local
// row 0 is the zero row and local row r >= 1 is pbx row lo + r - 1.
//
// idx = [T, 2] int32 (pa, local slab row) pairs in steps of E entries;
// slabs = [S, 3] int32 (lo, first step, steps): the call's entries run in
// S slab segments, each over one slab, in order.  A pad entry (G, 0) reads
// pa_ext[G] = the one and the zero row.  Each difference gets one lazy
// pass and each step's E differences multiply in the Pallas kernels'
// pairwise tree (replay_tree.cuh) before the root goes into acc, so the
// digits equal the plain version's (limbs/kernels.py:
// replay_resident_plain).
//
// Bound on the H100: integer multiply-adds, one modular product per entry
// on one thread per curve, as K6.  The slab replaces K6's Pb row gathers
// from L2 and HBM, which were never the limit; each block reads its slice
// of the slab's rows once per segment, so a call reads each Pb row it
// loads once over all blocks.
//
// Design: one-warp blocks of 32 curves, one thread per curve, as K5-K7.
// Every thread of a block reaches both barriers of every segment: a thread
// past the batch (b >= B) loads and stores nothing but does not return.
// The slab is dynamic shared memory, (cap + 1) * nw * 32 * 4 bytes; above
// 48 KB the entry point raises the kernel's limit once before a launch
// needs it.  Row offsets are size_t (lo * nw * B overflows int at the
// flagship).
#include "replay_tree.cuh"

__global__ void __launch_bounds__(TPUECM_THREADS)
replay_resident_kernel(const int* __restrict__ acc_in,
                       int* __restrict__ acc_out,
                       const int* __restrict__ pa_ext,
                       const int* __restrict__ pbx, int pb_rows,
                       const int* __restrict__ idx,
                       const int* __restrict__ slabs, int nslabs, int cap,
                       int E, TPUECM_MOD_PARAMS, int B) {
    extern __shared__ int slab[];   // [cap + 1][nw][TPUECM_THREADS]
    __shared__ Mod m;
    load_mod(m, TPUECM_MOD_ARGS);
    const int lane = threadIdx.x;
    const int b = blockIdx.x * blockDim.x + lane;
    const bool live = b < B;

    const size_t sB = (size_t)B;
    const size_t row = (size_t)nw * sB;
    const int srow = nw * TPUECM_THREADS;   // ints per slab row
    int acc[TPUECM_NW_MAX], part[TPUECM_STACK][TPUECM_NW_MAX];
    if (live) load_row(acc, acc_in + b, sB, nw);
    for (int h = 0; h < nslabs; ++h) {
        const int lo = slabs[3 * h], s0 = slabs[3 * h + 1],
                  ns = slabs[3 * h + 2];
        __syncthreads();   // the previous segment's reads are done
        for (int r = 0; r <= cap; ++r) {
            const int g = lo + r - 1;   // the pbx row of local row r
            int* dst = slab + r * srow + lane;
            if (live && r > 0 && g < pb_rows) {
                const int* src = pbx + (size_t)g * row + b;
                for (int j = 0; j < nw; ++j)
                    dst[j * TPUECM_THREADS] = src[(size_t)j * sB];
            } else {
                for (int j = 0; j < nw; ++j) dst[j * TPUECM_THREADS] = 0;
            }
        }
        __syncthreads();
        if (!live) continue;
        for (int s = s0; s < s0 + ns; ++s) {
            const int* ent = idx + 2 * (size_t)s * E;
            int top = 0;
            for (int k = 0; k < E; ++k) {
                const int* pa = pa_ext + (uint32_t)ent[2 * k] * row + b;
                const int* pb = slab + ent[2 * k + 1] * srow + lane;
                int* d = part[top++];
                for (int j = 0; j < nw; ++j)
                    d[j] = (int)((uint32_t)pa[(size_t)j * sB]
                                 - (uint32_t)pb[j * TPUECM_THREADS]);
                norm1(d, m);
                merge_tree(part, top, k, m);
            }
            mulmod(acc, acc, part[0], m);
        }
    }
    if (live) store_row(acc_out + b, acc, sB, nw);
}

// The kernel's static shared memory and the device's opt-in limit of
// shared memory per block: the slab height follows from them
// (limbs/kernels.py:resident_slab_rows).
extern "C" int tpuecm_replay_resident_smem(int* static_bytes,
                                           int* optin_bytes) {
    cudaFuncAttributes attr;
    int dev = 0;
    cudaError_t err = cudaFuncGetAttributes(&attr, replay_resident_kernel);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            optin_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) {
        (void)cudaGetLastError();   // leave no error for the next launch
        return (int)err;
    }
    *static_bytes = (int)attr.sharedSizeBytes;
    return 0;
}

// K8's preferred split of the SM's L1/shared array, in percent of the
// largest shared carveout (-1: no preference, the default).  Without one
// the driver may keep the largest carveout, so a low slab alone need not
// return L1 to the kernel's local memory; chip_smoke.py's phase 2 probes
// it.
extern "C" int tpuecm_replay_resident_carveout(int percent) {
    const cudaError_t err = cudaFuncSetAttribute(
        replay_resident_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        percent);
    if (err != cudaSuccess) (void)cudaGetLastError();
    return (int)err;
}

extern "C" int tpuecm_replay_resident(const int* acc_in, int* acc_out,
                                      const int* pa_ext, const int* pbx,
                                      int pb_rows, const int* idx,
                                      const int* slabs, int nslabs, int cap,
                                      int E, TPUECM_MOD_PARAMS, int B,
                                      void* stream) {
    if (!mod_args_ok(nw, e, cl, w) || !step_args_ok(nslabs, E) || cap < 1
        || pb_rows < 1 || B < 1)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = (size_t)(cap + 1) * nw * TPUECM_THREADS * sizeof(int);
    // the dynamic shared memory the kernel may take: 48 KB unless raised
    static size_t allowed = 48 * 1024;
    if (bytes > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            replay_resident_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) {
            (void)cudaGetLastError();
            return (int)err;
        }
        allowed = bytes;
    }
    const int blocks = (B + TPUECM_THREADS - 1) / TPUECM_THREADS;
    replay_resident_kernel<<<blocks, TPUECM_THREADS, bytes, (cudaStream_t)stream>>>(acc_in, acc_out, pa_ext, pbx, pb_rows, idx, slabs, nslabs, cap, E, TPUECM_MOD_ARGS, B);
    return (int)cudaGetLastError();
}
