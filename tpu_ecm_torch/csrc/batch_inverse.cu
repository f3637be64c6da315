// K3 and K4, stage 2: the device halves of Montgomery's batch-inversion
// trick over a stack of `count` planes.
//   K3 prefix:        out[i] = one * z[0] * ... * z[i]
//   K4 apply-inverse: out[i] = x[i] * z[i]^-1, walking i from count-1 down
//                     with the running suffix, from pres[i] (the prefix up
//                     to i-1) and total_inv = (z[0]...z[count-1])^-1, which
//                     the host inverts once for the whole batch.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:make_prefix_executor and
// make_apply_inverse_executor, whose sequential grids (the second in
// reverse) carried the running product in VMEM scratch.
//
// Bound on the H100: integer multiply-adds, 1 (K3) or 3 (K4) dependent
// Montgomery products per row on one thread per curve; each row moves
// 2 (K3) or 4 (K4) nw*4-byte digit rows per curve, coalesced.
//
// Design: the running product lives in a local array through a loop over
// the rows inside the thread (blocks have no order to carry it across).
// Every operand is a mulmod output or a host-packed value, so all products
// skip the norm_inputs entry passes, as in the Pallas kernels.
#include "arith.cuh"

__global__ void __launch_bounds__(TPUECM_THREADS)
prefix_kernel(const int* __restrict__ zs, const int* __restrict__ one,
              int* __restrict__ out, int count, const int* __restrict__ ndig,
              int nw, int w, int nprime, int norm, int B) {
    __shared__ Mod m;
    load_mod(m, ndig, nw, w, nprime, norm);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const size_t sB = (size_t)B;
    const size_t row = (size_t)nw * sB;
    int acc[TPUECM_NW_MAX], z[TPUECM_NW_MAX];
    load_row(acc, one + b, sB, nw);
    for (int i = 0; i < count; ++i) {
        load_row(z, zs + i * row + b, sB, nw);
        mulmod(acc, acc, z, m);
        store_row(out + i * row + b, acc, sB, nw);
    }
}

__global__ void __launch_bounds__(TPUECM_THREADS)
apply_inverse_kernel(const int* __restrict__ xs, const int* __restrict__ zs,
                     const int* __restrict__ pres,
                     const int* __restrict__ total_inv, int* __restrict__ out,
                     int count, const int* __restrict__ ndig, int nw, int w,
                     int nprime, int norm, int B) {
    __shared__ Mod m;
    load_mod(m, ndig, nw, w, nprime, norm);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const size_t sB = (size_t)B;
    const size_t row = (size_t)nw * sB;
    int suf[TPUECM_NW_MAX], inv[TPUECM_NW_MAX], t[TPUECM_NW_MAX];
    load_row(suf, total_inv + b, sB, nw);
    for (int i = count - 1; i >= 0; --i) {
        load_row(t, pres + i * row + b, sB, nw);
        mulmod(inv, suf, t, m);                  // z[i]^-1
        load_row(t, xs + i * row + b, sB, nw);
        mulmod(t, t, inv, m);
        store_row(out + i * row + b, t, sB, nw);
        load_row(t, zs + i * row + b, sB, nw);
        mulmod(suf, suf, t, m);
    }
}

extern "C" int tpuecm_prefix(const int* zs, const int* one, int* out,
                             int count, const int* ndig, int nw, int w,
                             int nprime, int norm, int B, void* stream) {
    if (nw < 2 || nw > TPUECM_NW_MAX || B < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + TPUECM_THREADS - 1) / TPUECM_THREADS;
    prefix_kernel<<<blocks, TPUECM_THREADS, 0, (cudaStream_t)stream>>>(zs, one, out, count, ndig, nw, w, nprime, norm, B);
    return (int)cudaGetLastError();
}

extern "C" int tpuecm_apply_inverse(const int* xs, const int* zs,
                                    const int* pres, const int* total_inv,
                                    int* out, int count, const int* ndig,
                                    int nw, int w, int nprime, int norm,
                                    int B, void* stream) {
    if (nw < 2 || nw > TPUECM_NW_MAX || B < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + TPUECM_THREADS - 1) / TPUECM_THREADS;
    apply_inverse_kernel<<<blocks, TPUECM_THREADS, 0, (cudaStream_t)stream>>>(xs, zs, pres, total_inv, out, count, ndig, nw, w, nprime, norm, B);
    return (int)cudaGetLastError();
}
