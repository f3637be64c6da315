// K2, stage 2: the differential-add chain out[i] = out[i-1] + Pd with
// difference out[i-2], seeded by (out[-1], out[-2]) = (p1, p2).  It builds
// the baby-step (Pb) table and the giant-step (Pa) groups.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:make_chain_executor, whose
// sequential grid carried the running pair in VMEM scratch and wrote one
// point per grid step.
//
// Bound on the H100: integer multiply-adds, 6 dependent Montgomery products
// per row on one thread per curve; each row writes 2*nw*4 bytes per curve,
// coalesced across the warp.
//
// Design: blocks run in parallel and in no order, so the sequential grid
// becomes a loop inside the thread, with the running pair and Pd in local
// arrays instead of scratch memory.
#include "arith.cuh"

__global__ void __launch_bounds__(TPUECM_THREADS)
chain_kernel(const int* __restrict__ p1, const int* __restrict__ p2,
             const int* __restrict__ pd, int* __restrict__ out, int count,
             const int* __restrict__ ndig, int nw, int w, int nprime,
             int norm, int B) {
    __shared__ Mod m;
    load_mod(m, ndig, nw, w, nprime, norm);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const size_t sB = (size_t)B;
    const size_t coord = (size_t)nw * sB;
    int cx[TPUECM_NW_MAX], cz[TPUECM_NW_MAX], px[TPUECM_NW_MAX],
        pz[TPUECM_NW_MAX], dx[TPUECM_NW_MAX], dz[TPUECM_NW_MAX],
        ox[TPUECM_NW_MAX], oz[TPUECM_NW_MAX];
    load_row(cx, p1 + b, sB, nw);
    load_row(cz, p1 + b + coord, sB, nw);
    load_row(px, p2 + b, sB, nw);
    load_row(pz, p2 + b + coord, sB, nw);
    load_row(dx, pd + b, sB, nw);
    load_row(dz, pd + b + coord, sB, nw);
    for (int i = 0; i < count; ++i) {
        xadd(ox, oz, cx, cz, dx, dz, px, pz, m);
        int* row = out + (size_t)i * 2 * coord + b;
        store_row(row, ox, sB, nw);
        store_row(row + coord, oz, sB, nw);
        copy_digits(px, cx, nw);
        copy_digits(pz, cz, nw);
        copy_digits(cx, ox, nw);
        copy_digits(cz, oz, nw);
    }
}

extern "C" int tpuecm_chain(const int* p1, const int* p2, const int* pd,
                            int* out, int count, const int* ndig, int nw,
                            int w, int nprime, int norm, int B, void* stream) {
    if (nw < 2 || nw > TPUECM_NW_MAX || B < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + TPUECM_THREADS - 1) / TPUECM_THREADS;
    chain_kernel<<<blocks, TPUECM_THREADS, 0, (cudaStream_t)stream>>>(p1, p2, pd, out, count, ndig, nw, w, nprime, norm, B);
    return (int)cudaGetLastError();
}
