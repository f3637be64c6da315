// K10, stage 1 of the RNS engine: replay an (op, dst, a, b, c) DUP/ADD/NOP
// tape over the [6, 2, 2K+1, B] residue register file, in place.
//
// Replaces tpu_ecm/limbs/rns_exec.py:_rns_tape_kernel (via
// make_rns_tape_executor), whose grid-less call kept the register file in
// VMEM for a 4096-step chunk and ran both base extensions of every product
// as bf16 matmuls on the MXU.
//
// Bound on the H100: integer multiply-adds in the two extension dots, about
// 2*K*(K+1) per product and curve (80,400 at K=200), 5 (DUP) or 6 (ADD)
// dependent products per tape op.  The dots multiply by matrices every
// curve shares, so the design keeps them in shared memory (csrc/
// rns_arith.cuh: 160 KB at K=200, packed 16-bit pairs), reads each weight
// once for the block's 4 curves, and accumulates 32 terms in uint32 before
// a 64-bit fold.  Point traffic (8 planes of (2K+1)*4 bytes per curve and
// op) stays in L2: the file is 19.7 MB at K=200, B=1024.
//
// Design: one block per 4 curves; every lane walks the same tape entry (a
// uniform load, the same barriers) with its channels of the 4 curves in
// registers.  Inputs are read before dst is written, and every lane writes
// only the rows it read, so dst may alias any input.
#include "rns_arith.cuh"

__global__ void __launch_bounds__(RNS_MAX_THREADS)
rns_tape_kernel(const int* __restrict__ tape, long long nsteps, int* pts,
                const int* __restrict__ s_const, const int* __restrict__ tab,
                const int* __restrict__ wpk, int K, int B, int resident) {
    RnsLane L;
    rns_setup(L, tab, wpk, K, B, resident);
    const size_t coord = (size_t)(2 * K + 1) * B;   // X -> Z within a point
    const size_t slot = 2 * coord;                  // point -> point
    for (long long k = 0; k < nsteps; ++k) {
        const int* e = tape + 5 * k;
        const int op = e[0], dst = e[1];
        const int* pa = pts + e[2] * slot;
        RV ax, az, ox, oz;
        load_rv(ax, pa, L);
        load_rv(az, pa + coord, L);
        if (op == 0) {                                  // DUP
            RV s;
            load_rv(s, s_const, L);
            rns_xdbl(ox, oz, ax, az, s, L);
        } else if (op == 1) {                           // ADD
            const int* pb = pts + e[3] * slot;
            const int* pd = pts + e[4] * slot;
            RV bx, bz, t1, t2, dx, dz;
            load_rv(bx, pb, L);
            load_rv(bz, pb + coord, L);
            rns_xadd_head(t1, t2, ax, az, bx, bz, L);
            load_rv(dx, pd, L);
            load_rv(dz, pd + coord, L);
            rns_mul(ox, t1, dz, L);
            rns_mul(oz, t2, dx, L);
        } else {                                        // NOP: dst := pts[a]
            ox = ax;
            oz = az;
        }
        store_rv(pts + dst * slot, ox, L);
        store_rv(pts + dst * slot + coord, oz, L);
    }
}

extern "C" int tpuecm_rns_tape(const int* tape, long long nsteps, int* pts,
                               const int* s_const, const int* tab,
                               const int* wpk, int K, int B, void* stream) {
    RnsLaunch c;
    const int rc = rns_launch_config(rns_tape_kernel, K, B, c);
    if (rc != (int)cudaSuccess) return rc;
    rns_tape_kernel<<<c.grid, c.block, c.smem, (cudaStream_t)stream>>>(tape, nsteps, pts, s_const, tab, wpk, K, B, c.resident);
    return (int)cudaGetLastError();
}
