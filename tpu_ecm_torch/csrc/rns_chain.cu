// K11, stage 2 of the RNS engine: the differential-add chain out[i] =
// out[i-1] + Pd with difference out[i-2], seeded by (out[-1], out[-2]) =
// (p1, p2), over [2, 2K+1, B] residue points.  It builds the baby-step
// (Pb) table and the giant-step (Pa) groups.
//
// Replaces tpu_ecm/limbs/rns_exec.py:make_rns_chain_executor (:276, its
// pallas_call at :303), whose sequential grid carried the running pair in
// VMEM scratch and wrote one point per grid step (xadd, rns_exec.py:64).
//
// Bound on the H100 (chip_smoke._rns_bound): 6 dependent RNS products a
// row and curve, each two extension dots (K x (K+1) multiply-adds a curve)
// as exact u8 splits at the int8 tensor peak, or the channel work beside
// them (the 7K+4 modular products of a mont_mul) at the int32 rate,
// whichever is larger, against the bytes: the seeds and Pd read once, each
// row's point, 2*(2K+1)*4 bytes a curve, written once.  At row 21 (K=200,
// B=1024, 4,096 rows) the dots bound it: 8.18 ms.
//
// Design (csrc/rns_mma.cuh, K10's and K14's core): blocks run in parallel
// and in no order, so the sequential grid becomes a loop inside the block.
// One block per tile of T curves holds all 2K+1 channels of them for the
// whole call: T = 8 with the u8 weight planes in shared memory (128
// blocks of 448 threads at row 21), T = 4 with the fragments from the
// global table past K = 222.  A row's six products are three independent
// pairs, each one pass of mma_mul2 (a weight fragment loaded once serves
// both, four accumulator chains a warp, the four barriers shared):
//   (U = (X1-Z1)(Xd+Zd) | V = (X1+Z1)(Xd-Zd))
//   (t1 = (U+V)^2       | t2 = (U-V)^2)
//   (X+ = t1 Z(out[i-2]) | Z+ = t2 X(out[i-2]))
// with P1 = out[i-1] and Pd the added point, the adds and subs on the
// operands, in the order, of rns_exec.xadd, so the residues equal the
// Pallas kernel's and chain_plain's bit for bit.  Where two halves do not
// fit beside the resident weights (208 < K <= 222) H = 1 runs the same
// passes one product at a time (rns_chain_config); T = 4 always pairs.
// Registers hold out[i-1] across rows and nothing else: Pd is read at
// each row from L1/L2, and out[i-2] back from `out`, the row the block
// wrote one row earlier (p2 and p1 at rows 0 and 1).  load_mv and store_mv
// share the thread map, so each thread reads back only elements it wrote
// itself.  Every thread walks the same rows, as mma_mul's barriers
// require.
#include "rns_mma.cuh"

// K11's launch at `tile` (0: rns_mma_tile's): two halves where they fit
// (K <= 208), one at T = 8 past that, two at T = 4 (K > 222)
inline int rns_chain_config(int K, int B, int tile, RnsMmaLaunch& c) {
    return rns_paired_config(K, B, tile, 0, c);
}

// The kernel body on one block (smem: rns_mma_bytes(K, T == 8, H) bytes).
template <int T, int H>
__device__ __forceinline__ void rns_chain_body(
        unsigned char* smem, const int* p1, const int* p2, const int* pd,
        int* out, int count, const int* tab, const unsigned char* wmma,
        int K, int B) {
    MmaCtx L;
    mma_setup<T, H>(L, smem, tab, wmma, K, B);
    const size_t coord = (size_t)(2 * K + 1) * B;   // X -> Z within a point
    MV cx, cz;                                      // out[i-1]
    load_mv(cx, p1, L);
    load_mv(cz, p1 + coord, L);
    for (int i = 0; i < count; ++i) {
        MV s1, d1, s2, d2, u, v;
        mma_add(s1, cx, cz, L);
        mma_sub(d1, cx, cz, L);
        load_mv(u, pd, L);
        load_mv(v, pd + coord, L);
        mma_add(s2, u, v, L);
        mma_sub(d2, u, v, L);
        mma_mul_pair<T, H>(u, d1, s2, v, s1, d2, L);
        mma_add(s1, u, v, L);
        mma_sub(d1, u, v, L);
        mma_mul_pair<T, H>(u, s1, s1, v, d1, d1, L);     // t1 | t2
        const int* diff = i == 0 ? p2
                          : i == 1 ? p1 : out + (size_t)(i - 2) * 2 * coord;
        load_mv(s2, diff + coord, L);                     // Z(out[i-2])
        load_mv(d2, diff, L);                             // X(out[i-2])
        mma_mul_pair<T, H>(cx, u, s2, cz, v, d2, L);
        int* row = out + (size_t)i * 2 * coord;
        store_mv(row, cx, L);
        store_mv(row + coord, cz, L);
    }
}

#ifdef __CUDACC__
template <int T, int H>
__global__ void __launch_bounds__(rns_tape_max_threads(T))
rns_chain_kernel(const int* __restrict__ p1, const int* __restrict__ p2,
                 const int* __restrict__ pd, int* __restrict__ out,
                 int count, const int* __restrict__ tab,
                 const unsigned char* __restrict__ wmma, int K, int B) {
    extern __shared__ __align__(128) unsigned char rns_mma_smem[];
    rns_chain_body<T, H>(rns_mma_smem, p1, p2, pd, out, count, tab, wmma, K,
                         B);
}

template <int T, int H>
static int launch_chain(const RnsMmaLaunch& c, const int* p1, const int* p2,
                        const int* pd, int* out, int count, const int* tab,
                        const unsigned char* wmma, int K, int B,
                        cudaStream_t stream) {
    if (c.smem > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            rns_chain_kernel<T, H>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    rns_chain_kernel<T, H><<<c.blocks, c.threads, c.smem, stream>>>(
        p1, p2, pd, out, count, tab, wmma, K, B);
    return (int)cudaGetLastError();
}

// tile: rns_kernels.chain_geometry's (0: rns_chain_config's);
// cudaErrorInvalidValue for count < 1 and for what rns_chain_config
// refuses
extern "C" int tpuecm_rns_chain(const int* p1, const int* p2, const int* pd,
                                int* out, int count, const int* tab,
                                const unsigned char* wmma, int K, int B,
                                int tile, void* stream) {
    if (count < 1) return (int)cudaErrorInvalidValue;
    RnsMmaLaunch c;
    const int rc = rns_chain_config(K, B, tile, c);
    if (rc != (int)cudaSuccess) return rc;
    const cudaStream_t s = (cudaStream_t)stream;
    if (c.tile == 4)
        return launch_chain<4, 2>(c, p1, p2, pd, out, count, tab, wmma, K, B,
                                  s);
    return c.halves == 2
        ? launch_chain<8, 2>(c, p1, p2, pd, out, count, tab, wmma, K, B, s)
        : launch_chain<8, 1>(c, p1, p2, pd, out, count, tab, wmma, K, B, s);
}
#endif

// K11's geometry at K, B and `tile` (0: its own) into out[6]: {tile,
// halves, threads, blocks, smem bytes, resident}, as
// rns_kernels.chain_geometry reads it; cudaErrorInvalidValue where
// rns_chain_config refuses
extern "C" int tpuecm_rns_chain_geometry(int K, int B, int tile,
                                         long long* out) {
    RnsMmaLaunch c;
    const int rc = rns_chain_config(K, B, tile, c);
    if (rc == (int)cudaSuccess) rns_mma_geometry(c, true, out);
    return rc;
}
