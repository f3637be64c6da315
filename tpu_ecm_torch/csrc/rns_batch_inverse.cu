// K12 and K13, stage 2 of the RNS engine: the device halves of
// Montgomery's batch-inversion trick over a stack of `count` residue
// planes [count, 2K+1, B].
//   K12 prefix:        out[i] = one * z[0] * ... * z[i]
//   K13 apply-inverse: out[i] = x[i] * z[i]^-1, walking i from count-1 down
//                      with the running suffix, from pres[i] (the prefix up
//                      to i-1) and total_inv = (z[0]...z[count-1])^-1, which
//                      the host inverts once for the whole batch:
//                        inv_i = suf * pres[i]; out[i] = x[i] * inv_i;
//                        suf = suf * z[i]
//
// Replaces tpu_ecm/limbs/rns_exec.py:make_rns_prefix_executor (:330, its
// pallas_call at :350) and make_rns_apply_inverse_executor (:376, :399),
// whose sequential grids (the second in reverse) carried the running
// product in VMEM scratch.
//
// Bound on the H100 (chip_smoke._rns_bound): 1 (K12) or 3 (K13) RNS
// products a row and curve, each two extension dots as exact u8 splits at
// the int8 tensor peak or the channel work at the int32 rate, against the
// bytes: each row moves 2 (K12) or 4 (K13) planes of (2K+1)*4 bytes a
// curve.  At row 21 (K=200, B=1024, 4,096 rows) the bytes bound both
// (4.02 and 8.03 ms).
//
// Design (csrc/rns_mma.cuh, K10's, K11's and K14's core): blocks run in
// parallel and in no order, so the sequential grid becomes a loop over
// the rows inside the block.  One block per tile of T curves holds all
// 2K+1 channels of them for the whole call: T = 8 with the u8 weight
// planes in shared memory (128 blocks of 448 threads at row 21), T = 4
// with the fragments from the global table past K = 222.  Every product
// keeps the reference's operands in its order, and nothing is
// re-associated (a parallel scan would change the residues), so they
// equal prefix_plain's and apply_inverse_plain's bit for bit.
//   K12: one running product, one product a pass (rns_tape_config's
//   launch): a prefix is one dependent chain, and a pass with a spent
//   partner costs more than it gains (as in K3).
//   K13: inv_i and the new suffix both multiply the old suffix by a row
//   and are independent: one paired pass (mma_mul_pair, at
//   rns_paired_config's launch as K11), then x[i] * inv_i one single
//   pass.  With H = 1 the pair runs as two products in turn, inv_i first,
//   so the suffix is overwritten only after both have read it.
// A block's share of a row is small (T * (2K+1) * 4 bytes a plane), but
// the stacks are far past L2 (6.7 GB a plane stack at row 21), so each
// row costs an HBM round trip unless its loads are in flight before it is
// needed.  At T = 8 they are issued a pass ahead (no room for a
// shared-memory ring beside the resident weights): K12's z[i+1] into
// registers before row i's pass; K13's pres[i-1], z[i-1] and x[i-1] into
// L2 (prefetch_mv) when row i starts and into registers after row i's
// single pass (loaded into registers between the pair and the single
// pass, they kept five planes live there, and nvcc 12.9 spilled 8 bytes
// at H = 2; loaded after it without the prefetch, each row waited on
// HBM: PERF.md section 6).
// At T = 4 (96 registers a thread at 17 warps) K13's early loads spilled
// and both kernels ran faster with each row's loads at its start.
// load_mv and store_mv share the thread map.  Every thread walks the same
// rows, as mma_mul's barriers require.
#include "rns_mma.cuh"

// K12's launch at `tile` (0: rns_mma_tile's): one half
inline int rns_prefix_config(int K, int B, int tile, RnsMmaLaunch& c) {
    return rns_tape_config(K, B, tile, c);
}

// K13's launch at `tile` (0: rns_mma_tile's): two halves where they fit
// (K <= 208), one at T = 8 past that, two at T = 4 (K > 222)
inline int rns_apply_inverse_config(int K, int B, int tile,
                                    RnsMmaLaunch& c) {
    return rns_paired_config(K, B, tile, 0, c);
}

// K12's body on one block (smem: rns_mma_bytes(K, T == 8, 1) bytes).
// At T = 8 row i + 1's z is loaded before row i's pass, into the other of
// two registers sets (rows in pairs: a copy between them spilled); at
// T = 4 each row's z at the row's start.
template <int T>
__device__ __forceinline__ void rns_prefix_body(
        unsigned char* smem, const int* zs, const int* one, int* out,
        int count, const int* tab, const unsigned char* wmma, int K, int B) {
    constexpr bool ahead = T == 8;
    MmaCtx L;
    mma_setup<T, 1>(L, smem, tab, wmma, K, B);
    const size_t row = (size_t)(2 * K + 1) * B;
    MV acc, z0, z1;
    load_mv(acc, one, L);
    if (ahead) load_mv(z0, zs, L);
    for (int i = 0; i < count; i += 2) {
        const int* z = zs + (size_t)i * row;
        if (!ahead) load_mv(z0, z, L);
        if (ahead && i + 1 < count) load_mv(z1, z + row, L);
        mma_mul<T>(acc, acc, z0, L);
        store_mv(out + (size_t)i * row, acc, L);
        if (i + 1 == count) break;
        if (!ahead) load_mv(z1, z + row, L);
        if (ahead && i + 2 < count) load_mv(z0, z + 2 * row, L);
        mma_mul<T>(acc, acc, z1, L);
        store_mv(out + (size_t)(i + 1) * row, acc, L);
    }
}

// K13's body on one block (smem: rns_mma_bytes(K, T == 8, H) bytes).  At
// T = 8 row i - 1's three planes are prefetched into L2 when row i starts
// and loaded after row i's single pass; at T = 4 (96 registers a thread)
// each row's three planes at the row's start.
template <int T, int H>
__device__ __forceinline__ void rns_apply_inverse_body(
        unsigned char* smem, const int* xs, const int* zs, const int* pres,
        const int* total_inv, int* out, int count, const int* tab,
        const unsigned char* wmma, int K, int B) {
    constexpr bool ahead = T == 8;
    MmaCtx L;
    mma_setup<T, H>(L, smem, tab, wmma, K, B);
    const size_t row = (size_t)(2 * K + 1) * B;
    MV suf, inv, p, z, x;
    load_mv(suf, total_inv, L);
    size_t at = (size_t)(count - 1) * row;
    if (ahead) {
        load_mv(p, pres + at, L);
        load_mv(z, zs + at, L);
        load_mv(x, xs + at, L);
    }
    for (int i = count - 1; i >= 0; --i, at -= row) {
        if (ahead && i > 0) {
            prefetch_mv(pres + at - row, L);
            prefetch_mv(zs + at - row, L);
            prefetch_mv(xs + at - row, L);
        }
        if (!ahead) {
            load_mv(p, pres + at, L);
            load_mv(z, zs + at, L);
            load_mv(x, xs + at, L);
        }
        mma_mul_pair<T, H>(inv, suf, p, suf, suf, z, L);
        mma_mul<T>(x, x, inv, L);
        store_mv(out + at, x, L);
        if (ahead && i > 0) {
            load_mv(p, pres + at - row, L);
            load_mv(z, zs + at - row, L);
            load_mv(x, xs + at - row, L);
        }
    }
}

#ifdef __CUDACC__
template <int T>
__global__ void __launch_bounds__(rns_tape_max_threads(T))
rns_prefix_kernel(const int* __restrict__ zs, const int* __restrict__ one,
                  int* __restrict__ out, int count,
                  const int* __restrict__ tab,
                  const unsigned char* __restrict__ wmma, int K, int B) {
    extern __shared__ __align__(128) unsigned char rns_mma_smem[];
    rns_prefix_body<T>(rns_mma_smem, zs, one, out, count, tab, wmma, K, B);
}

template <int T, int H>
__global__ void __launch_bounds__(rns_tape_max_threads(T))
rns_apply_inverse_kernel(const int* __restrict__ xs,
                         const int* __restrict__ zs,
                         const int* __restrict__ pres,
                         const int* __restrict__ total_inv,
                         int* __restrict__ out, int count,
                         const int* __restrict__ tab,
                         const unsigned char* __restrict__ wmma, int K,
                         int B) {
    extern __shared__ __align__(128) unsigned char rns_mma_smem[];
    rns_apply_inverse_body<T, H>(rns_mma_smem, xs, zs, pres, total_inv, out,
                                 count, tab, wmma, K, B);
}

// Opts the kernel in to c.smem bytes of dynamic shared memory.
template <typename Kernel>
static int allow_smem(Kernel kernel, const RnsMmaLaunch& c) {
    if (c.smem <= 48 * 1024) return (int)cudaSuccess;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
}

template <int T>
static int launch_prefix(const RnsMmaLaunch& c, const int* zs,
                         const int* one, int* out, int count, const int* tab,
                         const unsigned char* wmma, int K, int B,
                         cudaStream_t stream) {
    const int rc = allow_smem(rns_prefix_kernel<T>, c);
    if (rc != (int)cudaSuccess) return rc;
    rns_prefix_kernel<T><<<c.blocks, c.threads, c.smem, stream>>>(
        zs, one, out, count, tab, wmma, K, B);
    return (int)cudaGetLastError();
}

template <int T, int H>
static int launch_apply_inverse(const RnsMmaLaunch& c, const int* xs,
                                const int* zs, const int* pres,
                                const int* total_inv, int* out, int count,
                                const int* tab, const unsigned char* wmma,
                                int K, int B, cudaStream_t stream) {
    const int rc = allow_smem(rns_apply_inverse_kernel<T, H>, c);
    if (rc != (int)cudaSuccess) return rc;
    rns_apply_inverse_kernel<T, H><<<c.blocks, c.threads, c.smem, stream>>>(
        xs, zs, pres, total_inv, out, count, tab, wmma, K, B);
    return (int)cudaGetLastError();
}

// tile: rns_kernels.prefix_geometry's (0: rns_prefix_config's);
// cudaErrorInvalidValue for count < 1 and for what rns_prefix_config
// refuses
extern "C" int tpuecm_rns_prefix(const int* zs, const int* one, int* out,
                                 int count, const int* tab,
                                 const unsigned char* wmma, int K, int B,
                                 int tile, void* stream) {
    if (count < 1) return (int)cudaErrorInvalidValue;
    RnsMmaLaunch c;
    const int rc = rns_prefix_config(K, B, tile, c);
    if (rc != (int)cudaSuccess) return rc;
    const cudaStream_t s = (cudaStream_t)stream;
    return c.tile == 4
        ? launch_prefix<4>(c, zs, one, out, count, tab, wmma, K, B, s)
        : launch_prefix<8>(c, zs, one, out, count, tab, wmma, K, B, s);
}

// tile: rns_kernels.apply_inverse_geometry's (0:
// rns_apply_inverse_config's); cudaErrorInvalidValue for count < 1 and for
// what rns_apply_inverse_config refuses
extern "C" int tpuecm_rns_apply_inverse(const int* xs, const int* zs,
                                        const int* pres,
                                        const int* total_inv, int* out,
                                        int count, const int* tab,
                                        const unsigned char* wmma, int K,
                                        int B, int tile, void* stream) {
    if (count < 1) return (int)cudaErrorInvalidValue;
    RnsMmaLaunch c;
    const int rc = rns_apply_inverse_config(K, B, tile, c);
    if (rc != (int)cudaSuccess) return rc;
    const cudaStream_t s = (cudaStream_t)stream;
    if (c.tile == 4)
        return launch_apply_inverse<4, 2>(c, xs, zs, pres, total_inv, out,
                                          count, tab, wmma, K, B, s);
    return c.halves == 2
        ? launch_apply_inverse<8, 2>(c, xs, zs, pres, total_inv, out, count,
                                     tab, wmma, K, B, s)
        : launch_apply_inverse<8, 1>(c, xs, zs, pres, total_inv, out, count,
                                     tab, wmma, K, B, s);
}
#endif

// K12's and K13's geometry at K, B and `tile` (0: their own) into out[6]:
// {tile, halves, threads, blocks, smem bytes, resident}, as
// rns_kernels.prefix_geometry and apply_inverse_geometry read it;
// cudaErrorInvalidValue where the kernel's config refuses
extern "C" int tpuecm_rns_prefix_geometry(int K, int B, int tile,
                                          long long* out) {
    RnsMmaLaunch c;
    const int rc = rns_prefix_config(K, B, tile, c);
    if (rc == (int)cudaSuccess) rns_mma_geometry(c, true, out);
    return rc;
}

extern "C" int tpuecm_rns_apply_inverse_geometry(int K, int B, int tile,
                                                 long long* out) {
    RnsMmaLaunch c;
    const int rc = rns_apply_inverse_config(K, B, tile, c);
    if (rc == (int)cudaSuccess) rns_mma_geometry(c, true, out);
    return rc;
}
