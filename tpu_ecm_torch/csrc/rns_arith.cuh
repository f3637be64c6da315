// RNS Montgomery arithmetic for a tile of curves per block: the CUDA twin
// of tpu_ecm/limbs/rns.py:mont_mul/add/sub (and of limbs/rns.py, its plain
// version in this package).  It serves K15 alone (csrc/rns_replay.cu);
// K10-K14 run on the tensor-core core csrc/rns_mma.cuh.
//
// A value is 2K+1 canonical residues: rows [0, K) base A, [K, 2K) base B,
// row 2K the r channel m_r = 2^14.  Device planes are [2K+1, B], curve axis
// last.  A block works on RNS_TILE consecutive curves b0..b0+3 with
// max(32, ceil32(K+1)) threads; thread t ("lane") owns A channel t (t < K)
// and B/r channel row K+t (t <= K), for all curves of the tile, in
// registers (struct RV).  Lanes t > K own no channel and only join the
// barriers.
//
// mont_mul (rns.py:10-29), per curve:
//   1. s = x*y per channel;  2. sigma = s_A * c1 -> smem xs
//   3. M0 = W1^T sigma (lane t: column t, the B/r channel K+t)
//   4. t = s*P^-1 + M0*(N P^-1);  5. tau = t_B * qdivinv -> smem xt,
//      t_r -> smem tr
//   6. S2 = W2^T tau (lane t: column t, A channel t or, for t = K, the r
//      channel); lane K forms beta from S2's exact low 14 bits -> smem;
//      t_A = S2 - beta*|Q|_p mod p (JAX adds comp = p*(K+1), a multiple
//      of p, to stay nonnegative; the canonical result is the same)
// The extension dots are summed exactly: every term w*x is below
// 16383 * 8190 < 2^27, so 32 terms fit a uint32 partial that is folded into
// a uint64 (K <= 520 terms stay below 2^37).  W1 and W2 are packed as pairs
// of 16-bit weights per word (limbs/rns.py:kernel_tables) and live in
// shared memory when both fit (K <= 232); otherwise lanes read them through
// L1/L2 from the global copy.  Every other step is one `%` per value, so
// all residues are canonical and equal JAX's bit for bit.  The kernels
// equal the plain versions for any canonical residues, consistent or not.
//
// Three __syncthreads per product: every lane of the block must call
// rns_mul, so a kernel keeps its control flow uniform across the block.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#define RNS_TILE 4             // curves per block (uint4 smem rows below)
#define RNS_K_MAX 520          // limbs/rns.py:K_MAX
#define RNS_MAX_THREADS 544    // ceil32(RNS_K_MAX + 1)
#define RNS_SMEM_MAX 232448    // dynamic shared memory a block may use

// offsets into the flat table `tab` (limbs/rns.py:kernel_tables)
#define RNS_P(K) 0
#define RNS_C1(K) (2 * (K) + 1)
#define RNS_PINV(K) (3 * (K) + 1)
#define RNS_NPINV(K) (4 * (K) + 2)
#define RNS_QDI(K) (5 * (K) + 3)
#define RNS_QMOD(K) (6 * (K) + 3)
#define RNS_FSUB(K) (7 * (K) + 3)
#define RNS_QINV(K) (9 * (K) + 4)

// A value of the tile: lane t's A residue and B/r residue of each curve.
struct RV {
    uint32_t a[RNS_TILE], r[RNS_TILE];
};

// Per-lane constants and the block's shared buffers.
struct RnsLane {
    int K, t, b0, B;
    bool hasA, hasBr;          // t < K, t <= K
    uint32_t pA, pBr;          // channel moduli (1 where the lane has none)
    uint32_t pA32, pBr32;      // 2^32 mod p, for the 64-bit reductions
    uint32_t c1, pinv, npinv, qdi, qmod, fA, fBr, qinv, mask;
    const uint32_t* w1;        // packed [K/2][K+1] (shared or global)
    const uint32_t* w2;
    uint32_t* xs;              // sigma [K][RNS_TILE]
    uint32_t* xt;              // tau   [K][RNS_TILE]
    uint32_t* tr;              // t_r   [RNS_TILE]
    uint32_t* beta;            // beta  [RNS_TILE]
};

// Call with every thread of the block, before any other RNS function.
__device__ __forceinline__ void rns_setup(RnsLane& L, const int* tab,
                                          const int* wpk, int K, int B,
                                          int resident) {
    extern __shared__ __align__(16) uint32_t rns_smem[];
    const int t = threadIdx.x;
    L.K = K;
    L.t = t;
    L.B = B;
    L.b0 = blockIdx.x * RNS_TILE;
    L.hasA = t < K;
    L.hasBr = t <= K;
    L.pA = L.hasA ? (uint32_t)tab[RNS_P(K) + t] : 1u;
    L.pBr = L.hasBr ? (uint32_t)tab[RNS_P(K) + K + t] : 1u;
    L.pA32 = (uint32_t)((1ull << 32) % L.pA);
    L.pBr32 = (uint32_t)((1ull << 32) % L.pBr);
    L.c1 = L.hasA ? (uint32_t)tab[RNS_C1(K) + t] : 0u;
    L.qmod = L.hasA ? (uint32_t)tab[RNS_QMOD(K) + t] : 0u;
    L.fA = L.hasA ? (uint32_t)tab[RNS_FSUB(K) + t] : 0u;
    L.qdi = L.hasA ? (uint32_t)tab[RNS_QDI(K) + t] : 0u;
    L.pinv = L.hasBr ? (uint32_t)tab[RNS_PINV(K) + t] : 0u;
    L.npinv = L.hasBr ? (uint32_t)tab[RNS_NPINV(K) + t] : 0u;
    L.fBr = L.hasBr ? (uint32_t)tab[RNS_FSUB(K) + K + t] : 0u;
    L.qinv = (uint32_t)tab[RNS_QINV(K)];
    L.mask = (uint32_t)tab[RNS_P(K) + 2 * K] - 1u;
    L.xs = rns_smem;
    L.xt = L.xs + (size_t)K * RNS_TILE;
    L.tr = L.xt + (size_t)K * RNS_TILE;
    L.beta = L.tr + RNS_TILE;
    const size_t half = (size_t)(K / 2) * (K + 1);
    if (resident) {
        uint32_t* w = L.beta + RNS_TILE;
        for (size_t i = t; i < 2 * half; i += blockDim.x)
            w[i] = (uint32_t)wpk[i];
        L.w1 = w;
    } else {
        L.w1 = (const uint32_t*)wpk;
    }
    L.w2 = L.w1 + half;
    __syncthreads();
}

// ---------------------------------------------------------------------------
// plane rows <-> lane registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load_rv(RV& v, const int* plane,
                                        const RnsLane& L) {
    const int* ra = plane + (size_t)L.t * L.B;
    const int* rr = plane + (size_t)(L.K + L.t) * L.B;
#pragma unroll
    for (int b = 0; b < RNS_TILE; ++b) {
        const int cb = L.b0 + b;
        const bool ok = cb < L.B;
        v.a[b] = (L.hasA && ok) ? (uint32_t)ra[cb] : 0u;
        v.r[b] = (L.hasBr && ok) ? (uint32_t)rr[cb] : 0u;
    }
}

__device__ __forceinline__ void store_rv(int* plane, const RV& v,
                                         const RnsLane& L) {
    int* ra = plane + (size_t)L.t * L.B;
    int* rr = plane + (size_t)(L.K + L.t) * L.B;
#pragma unroll
    for (int b = 0; b < RNS_TILE; ++b) {
        const int cb = L.b0 + b;
        if (cb >= L.B) continue;
        if (L.hasA) ra[cb] = (int)v.a[b];
        if (L.hasBr) rr[cb] = (int)v.r[b];
    }
}

// ---------------------------------------------------------------------------
// channel arithmetic
// ---------------------------------------------------------------------------

// x mod p for x < 2^37: x = hi * 2^32 + lo with hi < 2^5
__device__ __forceinline__ uint32_t mod64(uint64_t x, uint32_t p,
                                          uint32_t p32) {
    const uint32_t hi = (uint32_t)(x >> 32), lo = (uint32_t)x;
    return (hi * p32 + lo % p) % p;
}

// acc[b] = sum_{i < K} W[i][t] * X[i][b], exact; W packed in 16-bit pairs
__device__ __forceinline__ void ext_dot(uint64_t acc[RNS_TILE],
                                        const uint32_t* W, const uint32_t* X,
                                        const RnsLane& L) {
    const int half = L.K >> 1, cols = L.K + 1;
    const uint32_t* w = W + L.t;
    const uint4* x4 = reinterpret_cast<const uint4*>(X);
#pragma unroll
    for (int b = 0; b < RNS_TILE; ++b) acc[b] = 0;
    for (int i0 = 0; i0 < half; i0 += 16) {
        const int i1 = i0 + 16 < half ? i0 + 16 : half;
        uint32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll 4
        for (int i = i0; i < i1; ++i) {
            const uint32_t wv = w[(size_t)i * cols];
            const uint32_t lo = wv & 0xFFFFu, hi = wv >> 16;
            const uint4 u = x4[2 * i], v = x4[2 * i + 1];
            s0 += lo * u.x + hi * v.x;
            s1 += lo * u.y + hi * v.y;
            s2 += lo * u.z + hi * v.z;
            s3 += lo * u.w + hi * v.w;
        }
        acc[0] += s0;
        acc[1] += s1;
        acc[2] += s2;
        acc[3] += s3;
    }
}

// o = x*y/P (rns.mont_mul); o may alias x or y.  Every lane must call it.
__device__ __forceinline__ void rns_mul(RV& o, const RV& x, const RV& y,
                                        const RnsLane& L) {
    uint32_t sR[RNS_TILE], s2a[RNS_TILE];
    if (L.hasA) {
#pragma unroll
        for (int b = 0; b < RNS_TILE; ++b) {
            const uint32_t s = (x.a[b] * y.a[b]) % L.pA;
            L.xs[L.t * RNS_TILE + b] = (s * L.c1) % L.pA;
        }
    }
#pragma unroll
    for (int b = 0; b < RNS_TILE; ++b) sR[b] = (x.r[b] * y.r[b]) % L.pBr;
    __syncthreads();
    if (!L.hasBr) {                            // a lane past row 2K
#pragma unroll
        for (int b = 0; b < RNS_TILE; ++b) o.r[b] = 0;
    } else {
        uint64_t m[RNS_TILE];
        ext_dot(m, L.w1, L.xs, L);
#pragma unroll
        for (int b = 0; b < RNS_TILE; ++b) {
            const uint32_t m0 = mod64(m[b], L.pBr, L.pBr32);
            const uint32_t tb = (sR[b] * L.pinv + m0 * L.npinv) % L.pBr;
            o.r[b] = tb;
            if (L.hasA)
                L.xt[L.t * RNS_TILE + b] = (tb * L.qdi) % L.pBr;
            else
                L.tr[b] = tb;                   // lane K: the r channel
        }
    }
    __syncthreads();
    if (L.hasBr) {
        uint64_t s2[RNS_TILE];
        ext_dot(s2, L.w2, L.xt, L);
#pragma unroll
        for (int b = 0; b < RNS_TILE; ++b) {
            if (L.hasA)
                s2a[b] = mod64(s2[b], L.pA, L.pA32);
            else                                // beta needs S2's low bits
                L.beta[b] = ((((uint32_t)s2[b] - L.tr[b]) & L.mask) * L.qinv)
                            & L.mask;
        }
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < RNS_TILE; ++b)      // beta * |Q|_p < 2^27
        o.a[b] = L.hasA
            ? (s2a[b] + L.pA - (L.beta[b] * L.qmod) % L.pA) % L.pA : 0u;
}

// x - y + f mod p for canonical x, y, f: x + f + p - y lies in [0, 3p)
__device__ __forceinline__ uint32_t sub_ch(uint32_t x, uint32_t y,
                                           uint32_t f, uint32_t p) {
    uint32_t z = x + f + p - y;
    z = z >= p ? z - p : z;
    return z >= p ? z - p : z;
}

// x - y + F (rns.sub; F = 2KN keeps the value nonnegative)
__device__ __forceinline__ void rns_sub(RV& o, const RV& x, const RV& y,
                                        const RnsLane& L) {
#pragma unroll
    for (int b = 0; b < RNS_TILE; ++b) {
        o.a[b] = sub_ch(x.a[b], y.a[b], L.fA, L.pA);
        o.r[b] = sub_ch(x.r[b], y.r[b], L.fBr, L.pBr);
    }
}

// ---------------------------------------------------------------------------
// launch geometry
// ---------------------------------------------------------------------------

struct RnsLaunch {
    dim3 grid, block;
    size_t smem;
    int resident;
};

// cudaSuccess, or cudaErrorInvalidValue for a K or B the kernels do not
// take; sets the dynamic shared memory limit of `kernel` when needed.
template <typename Kernel>
inline int rns_launch_config(Kernel kernel, int K, int B, RnsLaunch& c) {
    if (K < 2 || K % 2 || K > RNS_K_MAX || B < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = (K + 1 + 31) / 32 * 32;
    const size_t base = (2 * (size_t)K * RNS_TILE + 2 * RNS_TILE) * 4;
    const size_t wbytes = (size_t)K * (K + 1) * 4;
    c.resident = base + wbytes <= RNS_SMEM_MAX;
    c.smem = base + (c.resident ? wbytes : 0);
    c.block = dim3(threads < 32 ? 32 : threads);
    c.grid = dim3((B + RNS_TILE - 1) / RNS_TILE);
    if (c.smem > 48 * 1024)
        return (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)c.smem);
    return (int)cudaSuccess;
}
