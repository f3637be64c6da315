// K12 and K13, stage 2 of the RNS engine: the device halves of
// Montgomery's batch-inversion trick over a stack of `count` residue
// planes [count, 2K+1, B].
//   K12 prefix:        out[i] = one * z[0] * ... * z[i]
//   K13 apply-inverse: out[i] = x[i] * z[i]^-1, walking i from count-1 down
//                      with the running suffix, from pres[i] (the prefix up
//                      to i-1) and total_inv = (z[0]...z[count-1])^-1, which
//                      the host inverts once for the whole batch.
//
// Replaces tpu_ecm/limbs/rns_exec.py:make_rns_prefix_executor and
// make_rns_apply_inverse_executor, whose sequential grids (the second in
// reverse) carried the running product in VMEM scratch.
//
// Bound on the H100: integer multiply-adds, 1 (K12) or 3 (K13) dependent
// RNS products per row, with the extension matrices in shared memory
// (csrc/rns_arith.cuh); each row moves 2 (K12) or 4 (K13) planes of
// (2K+1)*4 bytes per curve.
//
// Design: the running product lives in registers through a loop over the
// rows inside the block (blocks have no order to carry it across).
#include "rns_arith.cuh"

__global__ void __launch_bounds__(RNS_MAX_THREADS)
rns_prefix_kernel(const int* __restrict__ zs, const int* __restrict__ one,
                  int* __restrict__ out, int count,
                  const int* __restrict__ tab, const int* __restrict__ wpk,
                  int K, int B, int resident) {
    RnsLane L;
    rns_setup(L, tab, wpk, K, B, resident);
    const size_t row = (size_t)(2 * K + 1) * B;
    RV acc, z;
    load_rv(acc, one, L);
    for (int i = 0; i < count; ++i) {
        load_rv(z, zs + i * row, L);
        rns_mul(acc, acc, z, L);
        store_rv(out + i * row, acc, L);
    }
}

__global__ void __launch_bounds__(RNS_MAX_THREADS)
rns_apply_inverse_kernel(const int* __restrict__ xs,
                         const int* __restrict__ zs,
                         const int* __restrict__ pres,
                         const int* __restrict__ total_inv,
                         int* __restrict__ out, int count,
                         const int* __restrict__ tab,
                         const int* __restrict__ wpk, int K, int B,
                         int resident) {
    RnsLane L;
    rns_setup(L, tab, wpk, K, B, resident);
    const size_t row = (size_t)(2 * K + 1) * B;
    RV suf, inv, t;
    load_rv(suf, total_inv, L);
    for (int i = count - 1; i >= 0; --i) {
        load_rv(t, pres + i * row, L);
        rns_mul(inv, suf, t, L);                 // z[i]^-1
        load_rv(t, xs + i * row, L);
        rns_mul(t, t, inv, L);
        store_rv(out + i * row, t, L);
        load_rv(t, zs + i * row, L);
        rns_mul(suf, suf, t, L);
    }
}

extern "C" int tpuecm_rns_prefix(const int* zs, const int* one, int* out,
                                 int count, const int* tab, const int* wpk,
                                 int K, int B, void* stream) {
    RnsLaunch c;
    const int rc = rns_launch_config(rns_prefix_kernel, K, B, c);
    if (rc != (int)cudaSuccess) return rc;
    rns_prefix_kernel<<<c.grid, c.block, c.smem, (cudaStream_t)stream>>>(zs, one, out, count, tab, wpk, K, B, c.resident);
    return (int)cudaGetLastError();
}

extern "C" int tpuecm_rns_apply_inverse(const int* xs, const int* zs,
                                        const int* pres, const int* total_inv,
                                        int* out, int count, const int* tab,
                                        const int* wpk, int K, int B,
                                        void* stream) {
    RnsLaunch c;
    const int rc = rns_launch_config(rns_apply_inverse_kernel, K, B, c);
    if (rc != (int)cudaSuccess) return rc;
    rns_apply_inverse_kernel<<<c.grid, c.block, c.smem, (cudaStream_t)stream>>>(xs, zs, pres, total_inv, out, count, tab, wpk, K, B, c.resident);
    return (int)cudaGetLastError();
}
