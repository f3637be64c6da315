// K1, stage 1: replay an (op, dst, a, b, c) DUP/ADD/NOP tape over the
// [6, 2, NW, B] point register file, in place.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:_tape_kernel (via
// make_tape_executor), whose grid-less call kept the register file in VMEM
// for an 8192-step chunk.
//
// Bound on the H100: integer multiply-adds.  A tape step is 5 (DUP) or 6
// (ADD) dependent Montgomery products of ~2*nw^2 multiply-adds each, on one
// thread per curve, against about 6*nw*4 bytes of point traffic per curve
// that stays in L2 (the file is 6*2*nw*B*4 bytes, 3.5 MB at the flagship).
// So the loop is latency-bound per thread: with one warp per block, 2048
// curves occupy 64 warps on 64 SMs.
//
// Design: every thread walks the same tape entry (a uniform load, no
// divergence) and keeps its curve's operands and s = (A+2)/4 in local
// arrays; the tape length is a run-time value, so no NOP padding is needed.
// Inputs are read before dst is written, so dst may alias any input.
#include "arith.cuh"

__global__ void __launch_bounds__(TPUECM_THREADS)
tape_kernel(const int* __restrict__ tape, long long nsteps, int* pts,
            const int* __restrict__ s_const, const int* __restrict__ ndig,
            int nw, int w, int nprime, int norm, int B) {
    __shared__ Mod m;
    load_mod(m, ndig, nw, w, nprime, norm);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const size_t sB = (size_t)B;
    const size_t coord = (size_t)nw * sB;     // X -> Z within a point
    const size_t slot = 2 * coord;            // point -> point
    int* file = pts + b;
    int s[TPUECM_NW_MAX];
    load_row(s, s_const + b, sB, nw);

    int ax[TPUECM_NW_MAX], az[TPUECM_NW_MAX], bx[TPUECM_NW_MAX],
        bz[TPUECM_NW_MAX], dx[TPUECM_NW_MAX], dz[TPUECM_NW_MAX],
        ox[TPUECM_NW_MAX], oz[TPUECM_NW_MAX];
    for (long long k = 0; k < nsteps; ++k) {
        const int* e = tape + 5 * k;
        const int op = e[0], dst = e[1];
        const int* pa = file + e[2] * slot;
        load_row(ax, pa, sB, nw);
        load_row(az, pa + coord, sB, nw);
        if (op == 0) {                        // DUP
            xdbl(ox, oz, ax, az, s, m);
        } else if (op == 1) {                 // ADD
            const int* pb = file + e[3] * slot;
            const int* pd = file + e[4] * slot;
            load_row(bx, pb, sB, nw);
            load_row(bz, pb + coord, sB, nw);
            load_row(dx, pd, sB, nw);
            load_row(dz, pd + coord, sB, nw);
            xadd(ox, oz, ax, az, bx, bz, dx, dz, m);
        } else {                              // NOP: dst := pts[a]
            copy_digits(ox, ax, nw);
            copy_digits(oz, az, nw);
        }
        store_row(file + dst * slot, ox, sB, nw);
        store_row(file + dst * slot + coord, oz, sB, nw);
    }
}

extern "C" int tpuecm_tape(const int* tape, long long nsteps, int* pts,
                           const int* s_const, const int* ndig, int nw, int w,
                           int nprime, int norm, int B, void* stream) {
    if (nw < 2 || nw > TPUECM_NW_MAX || B < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + TPUECM_THREADS - 1) / TPUECM_THREADS;
    tape_kernel<<<blocks, TPUECM_THREADS, 0, (cudaStream_t)stream>>>(tape, nsteps, pts, s_const, ndig, nw, w, nprime, norm, B);
    return (int)cudaGetLastError();
}
