// K11, stage 2 of the RNS engine: the differential-add chain out[i] =
// out[i-1] + Pd with difference out[i-2], seeded by (out[-1], out[-2]) =
// (p1, p2), over [2, 2K+1, B] residue points.  It builds the baby-step
// (Pb) table and the giant-step (Pa) groups.
//
// Replaces tpu_ecm/limbs/rns_exec.py:make_rns_chain_executor, whose
// sequential grid carried the running pair in VMEM scratch and wrote one
// point per grid step.
//
// Bound on the H100: integer multiply-adds, 6 dependent RNS products per
// row (about 2*K*(K+1) multiply-adds each, per curve), with the extension
// matrices in shared memory (csrc/rns_arith.cuh); each row writes
// 2*(2K+1)*4 bytes per curve.
//
// Design: blocks run in parallel and in no order, so the sequential grid
// becomes a loop inside the block, with the running pair in registers; Pd
// is read from L1/L2 at each row, which keeps fewer values live.
#include "rns_arith.cuh"

__global__ void __launch_bounds__(RNS_MAX_THREADS)
rns_chain_kernel(const int* __restrict__ p1, const int* __restrict__ p2,
                 const int* __restrict__ pd, int* __restrict__ out,
                 int count, const int* __restrict__ tab,
                 const int* __restrict__ wpk, int K, int B, int resident) {
    RnsLane L;
    rns_setup(L, tab, wpk, K, B, resident);
    const size_t coord = (size_t)(2 * K + 1) * B;
    RV cx, cz, px, pz;
    load_rv(cx, p1, L);
    load_rv(cz, p1 + coord, L);
    load_rv(px, p2, L);
    load_rv(pz, p2 + coord, L);
    for (int i = 0; i < count; ++i) {
        RV dx, dz, t1, t2;
        load_rv(dx, pd, L);
        load_rv(dz, pd + coord, L);
        rns_xadd_head(t1, t2, cx, cz, dx, dz, L);
        rns_mul(t1, t1, pz, L);  // X+ = t1 * Z(out[i-2])
        rns_mul(t2, t2, px, L);  // Z+ = t2 * X(out[i-2])
        px = cx;
        pz = cz;
        cx = t1;
        cz = t2;
        int* row = out + (size_t)i * 2 * coord;
        store_rv(row, cx, L);
        store_rv(row + coord, cz, L);
    }
}

extern "C" int tpuecm_rns_chain(const int* p1, const int* p2, const int* pd,
                                int* out, int count, const int* tab,
                                const int* wpk, int K, int B, void* stream) {
    RnsLaunch c;
    const int rc = rns_launch_config(rns_chain_kernel, K, B, c);
    if (rc != (int)cudaSuccess) return rc;
    rns_chain_kernel<<<c.grid, c.block, c.smem, (cudaStream_t)stream>>>(p1, p2, pd, out, count, tab, wpk, K, B, c.resident);
    return (int)cudaGetLastError();
}
