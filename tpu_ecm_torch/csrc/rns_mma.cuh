// RNS Montgomery arithmetic on the tensor cores for a tile of T curves a
// block: the CUDA twin of limbs/rns.py:mont_mul/add/sub (the plain
// version), the RNS engine's one arithmetic core, which K10
// (csrc/rns_tape.cu), K11 (csrc/rns_chain.cu), K12 and K13
// (csrc/rns_batch_inverse.cu), K14 (csrc/rns_replay_gather.cu) and K15
// (csrc/rns_replay.cu) run.
//
// A value is 2K+1 canonical residues: rows [0, K) base A, [K, 2K) base B,
// row 2K the r channel m_r = 2^14; device planes are [2K+1, B], curve axis
// last.
//
// Thread map.  A block owns T consecutive curves b0..b0+T-1 (T = 8 when
// the weights fit in shared memory, else 4: rns_tape_config) and G = T/4
// threads per channel pair: thread t owns pair c = t / G, that is A
// channel c (c < K) and B/r channel row K + c (c <= K), for the four
// curves b0 + 4 (t % G) + i, i < 4, in registers (struct MV).  Threads
// past pair K own nothing and only join the barriers.  A warp covers 32/G
// pairs, so it reads and writes each plane row's T curves as contiguous
// bytes (16-byte vectors when B % 4 == 0).
//
// mont_mul (rns.py:mont_mul), per curve, four block barriers:
//   A. s = x*y per channel; sigma = s_A * c1 -> shared X, split into u8
//      planes lo = sigma & 255, hi = sigma >> 8
//   1. M0 = W1^T sigma on the tensor cores (ext_dot)
//   C. t = s*P^-1 + M0*(N P^-1) per B/r channel; tau = t_B * qdivinv -> X
//      (split), t_r -> shared tr
//   2. S2 = W2^T tau on the tensor cores
//   E. beta = ((S2_r - t_r) mod m_r) * |Q^-1|_{m_r} mod m_r from S2's exact
//      low 14 bits (each thread forms its curves' beta itself);
//      t_A = S2_A - beta*|Q|_p mod p
// The extension dots are exact u8 products.  A dot input v < 2^13 splits
// into lo (8 bits) and hi (<= 5 bits), a weight w < 2^14 (W's r column is
// mod 2^14) into lo and hi (<= 6 bits).  nvcuda::wmma m32n8k16 (M = output
// channels, N = 8 curve columns, K = input channels, u8 x u8 -> s32) takes
// them in 16-channel steps.  Two warps share each 32-row M tile: the
// weight-lo warp sums P = sum wlo*vlo + 256 sum wlo*vhi, the weight-hi warp
// Q = sum whi*vlo + 256 sum whi*vhi, so S = P + 256 Q exactly.  At K <= 520
// every partial sum fits: P <= 520*255*255 + 256*520*255*31 < 2^31, Q <=
// 520*63*255 + 256*520*63*31 < 2^29; S < 2^37.  The r row keeps S's exact
// low 14 bits: (P + (Q << 8)) mod 2^32, masked.
//
// No `%` by a runtime modulus on the per-product path: each reduction is a
// multiply-high one with constants that setup computes once per block
// (its only 64-bit divisions), and every result is canonical, so the
// residues equal the plain version's `%` bit for bit:
//   red(x)     x mod p for any x < 2^32: Barrett, m = floor(2^32 / p),
//              q = umulhi(x, m) is floor(x/p) or one less (exact for
//              p = 2^14); r = x - q*p < 2p; r = min(r, r - p)
//   mulc(x, w) x*w mod p for a constant w < p, any x < 2^32: Shoup,
//              w' = floor(w * 2^32 / p), r = x*w - umulhi(x, w')*p < 2p
//   chan(P, Q) S mod p = red(P + 256*red(Q)): Q < 2^29, P + 256 p < 2^32
// Instructions per channel pair and curve per product, beside the dots
// and shared-memory traffic, counted from the source: phase A about 16
// (A: product, red, mulc, split; B/r: product, red), phase C about 22
// (chan, two products and red, mulc, split), phase E about 21 (chan,
// beta, mulc, subtraction): about 60, 10 of them multiply-highs.
//
// The weights sit in a padded u8 table (limbs/rns.py:mma_weights): four
// planes W1 lo, W1 hi, W2 lo, W2 hi of W^T, Mpad = ceil32(K+1) output
// rows by Kpad = ceil16(K) input columns, zero padded, in 32 x 16
// row-major tiles [Mpad/32][Kpad/16][32][16]: the A operand of every
// tile.  When the four planes, X, the P/Q tiles and the pairs' constants
// fit in the block's shared memory (K <= 222; T = 8) the planes are copied
// there once per block; otherwise (T = 4) the fragments load from the
// global table through L1/L2.
//
// Two independent products of the same T curves (mma_mul2) run as one:
// the block holds H = 2 halves of X, P, Q and tr, each dot's warp loads a
// weight fragment once and multiplies both halves' inputs by it (N = 16
// columns as two n8 fragments, four accumulator chains a warp), and the
// four barriers serve both.  Half j's buffers follow half 0's at a fixed
// stride (xhalf, phalf), so mma_mul, which uses half 0 only, runs
// unchanged in a block set up with two halves.
//
// Every thread of the block must call every mma_mul, so the kernel keeps
// its control flow uniform across the block.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

#define RNS_MMA_K_MAX 520           // limbs/rns.py:K_MAX
#define RNS_MMA_MAX_WARPS 17        // ceil32(RNS_MMA_K_MAX + 1) / 32
#define RNS_MMA_MAX_THREADS (32 * RNS_MMA_MAX_WARPS)
#define RNS_MMA_SMEM_MAX 232448     // dynamic shared memory a block may use

// offsets into the flat table `tab` (limbs/rns.py:kernel_tables)
#define RNS_TAB_P(K) 0
#define RNS_TAB_C1(K) (2 * (K) + 1)
#define RNS_TAB_PINV(K) (3 * (K) + 1)
#define RNS_TAB_NPINV(K) (4 * (K) + 2)
#define RNS_TAB_QDI(K) (5 * (K) + 3)
#define RNS_TAB_QMOD(K) (6 * (K) + 3)
#define RNS_TAB_FSUB(K) (7 * (K) + 3)
#define RNS_TAB_QINV(K) (9 * (K) + 4)

// ---------------------------------------------------------------------------
// geometry (host and device)
// ---------------------------------------------------------------------------

__host__ __device__ inline int rns_kpad(int K) { return (K + 15) / 16 * 16; }
__host__ __device__ inline int rns_mpad(int K) { return (K + 32) / 32 * 32; }

// X [H][2][Kpad/16][8][16] u8, P and Q [H][Mpad][8] s32, tr [H][8] u32,
// the channel pairs' constants (kA, kB [Mpad] uint4, kF [Mpad] uint2),
// then the weight planes [4][Mpad/32][Kpad/16][32][16] u8 when resident;
// H halves (1, or 2 for mma_mul2)
__host__ __device__ inline size_t rns_mma_bytes(int K, bool resident,
                                               int halves) {
    const size_t kp = rns_kpad(K), mp = rns_mpad(K);
    return halves * (16 * kp + 64 * mp + 32) + 40 * mp
           + (resident ? 4 * kp * mp : 0);
}

// Threads a block may have: T = 8 runs at K <= 222, at most 14 warps, and
// is bounded there so that ptxas may give each thread 128 registers;
// T = 4 needs 17 warps at K = 520 (96 registers a thread).
__host__ __device__ constexpr int rns_tape_max_threads(int T) {
    return T == 8 ? 448 : RNS_MMA_MAX_THREADS;
}

struct RnsMmaLaunch {
    int tile, halves, threads, blocks, resident;
    size_t smem;
};

// cudaSuccess, or cudaErrorInvalidValue for a K, B, tile or number of
// halves the kernels do not take: T = 8 keeps the weights in shared
// memory and is refused where they do not fit beside `halves` sets of X,
// P, Q and tr and `extra` bytes of the kernel's own (K10, K12: one half,
// K <= 222; K11, K13, K14: two halves up to K = 208); T = 4 reads them
// from the global table.  Warps: enough for every channel pair, and two a 32-row M
// tile up to RNS_MMA_MAX_WARPS.
inline int rns_mma_config(int K, int B, int tile, int halves, size_t extra,
                          RnsMmaLaunch& c) {
    if (K < 2 || K % 2 || K > RNS_MMA_K_MAX || B < 1
        || (tile != 4 && tile != 8) || (halves != 1 && halves != 2))
        return (int)cudaErrorInvalidValue;
    const int G = tile / 4, mt = rns_mpad(K) / 32;
    const int chans = (G * (K + 1) + 31) / 32;
    const int dots = 2 * mt < RNS_MMA_MAX_WARPS ? 2 * mt : RNS_MMA_MAX_WARPS;
    c.tile = tile;
    c.halves = halves;
    c.resident = tile == 8;
    c.smem = rns_mma_bytes(K, c.resident, halves) + extra;
    c.threads = 32 * (chans > dots ? chans : dots);
    c.blocks = (B + tile - 1) / tile;
    if (c.smem > RNS_MMA_SMEM_MAX || c.threads > rns_tape_max_threads(tile))
        return (int)cudaErrorInvalidValue;
    return (int)cudaSuccess;
}

// The tile a kernel with `extra` bytes of its own takes at K unless told
// otherwise: 8 where the weights fit in shared memory beside one half
// (K <= 222 for K10-K14), else 4
inline int rns_mma_tile(int K, size_t extra) {
    return rns_mma_bytes(K, true, 1) + extra <= RNS_MMA_SMEM_MAX ? 8 : 4;
}

// K10's (and K12's) launch: one half, at `tile` (0: rns_mma_tile's)
inline int rns_tape_config(int K, int B, int tile, RnsMmaLaunch& c) {
    return rns_mma_config(K, B, tile ? tile : rns_mma_tile(K, 0), 1, 0, c);
}

// The launch of a kernel that pairs its products (K11, K13, K14) with
// `extra` bytes of its own, at `tile` (0: rns_mma_tile's): two halves where they
// fit beside the resident weights, else one at T = 8 (208 < K <= 222 at
// extra <= 384); T = 4 always takes two
inline int rns_paired_config(int K, int B, int tile, size_t extra,
                             RnsMmaLaunch& c) {
    if (!tile) tile = rns_mma_tile(K, extra);
    const int rc = rns_mma_config(K, B, tile, 2, extra, c);
    if (rc == (int)cudaSuccess || tile != 8) return rc;
    return rns_mma_config(K, B, tile, 1, extra, c);
}

// Fills out[n] from a launch for a geometry entry point (the caller's
// layout: rns_kernels.TapeGeometry's fields, or ChainGeometry's and
// GatherGeometry's)
inline void rns_mma_geometry(const RnsMmaLaunch& c, bool halves,
                             long long* out) {
    int i = 0;
    out[i++] = c.tile;
    if (halves) out[i++] = c.halves;
    out[i++] = c.threads;
    out[i++] = c.blocks;
    out[i++] = (long long)c.smem;
    out[i++] = c.resident;
}

// ---------------------------------------------------------------------------
// multiply-high reductions
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t umin32(uint32_t a, uint32_t b) {
    return a < b ? a : b;
}

// floor(2^32 / p), p >= 2 (setup only)
__host__ __device__ inline uint32_t barrett_m(uint32_t p) {
    return (uint32_t)(0x100000000ull / p);
}

// floor(w * 2^32 / p), w < p (setup only)
__host__ __device__ inline uint32_t shoup_w(uint32_t w, uint32_t p) {
    return (uint32_t)(((uint64_t)w << 32) / p);
}

// x mod p for any x < 2^32
__device__ __forceinline__ uint32_t red(uint32_t x, uint32_t p, uint32_t m) {
    const uint32_t r = x - __umulhi(x, m) * p;
    return umin32(r, r - p);
}

// x * w mod p for a constant w < p (ws = shoup_w(w, p)), any x < 2^32
__device__ __forceinline__ uint32_t mulc(uint32_t x, uint32_t w, uint32_t ws,
                                         uint32_t p) {
    const uint32_t r = x * w - __umulhi(x, ws) * p;
    return umin32(r, r - p);
}

// (P + 256 Q) mod p for a dot's two partial sums (P < 2^31, Q < 2^29)
__device__ __forceinline__ uint32_t chan(uint32_t P, uint32_t Q, uint32_t p,
                                         uint32_t m) {
    return red(P + (red(Q, p, m) << 8), p, m);
}

// ---------------------------------------------------------------------------
// the block's constants and buffers
// ---------------------------------------------------------------------------

// A value of the tile: the thread's A and B/r residues of its 4 curves.
struct MV {
    uint32_t a[4], r[4];
};

// The block's constants and buffers.  Each thread keeps its channels'
// moduli and Barrett constants in registers; the pair's other constants
// sit in shared memory and are loaded where a product uses them, and the
// shared buffers are reached by 32-bit offsets from x, which keeps the
// register count inside the launch bounds (96 a thread at 17 warps).
struct MmaCtx {
    int K, B, c, cb, col;      // channel pair, the thread's first curve
                               // and its column in X, P, Q and tr
    bool hasA, hasBr;          // c < K, c <= K
    int kt, mt;                // k tiles, M tiles
    uint32_t pA, mA, pBr, mBr, qinv, mask;
    const unsigned char* w;    // four weight planes (shared or global)
    unsigned char* x;          // dot input [H][2][Kpad/16][8][16]: lo, hi
    int oP, oQ, otr, okA, okB, okF;   // byte offsets from x of P, Q, tr,
                                      // kA, kB and kF
    __device__ int* Pp() const { return reinterpret_cast<int*>(x + oP); }
    __device__ int* Qp() const { return reinterpret_cast<int*>(x + oQ); }
    __device__ uint32_t* trp() const {
        return reinterpret_cast<uint32_t*>(x + otr);
    }
    __device__ const uint4* kAp() const {
        return reinterpret_cast<const uint4*>(x + okA);
    }
    __device__ const uint4* kBp() const {
        return reinterpret_cast<const uint4*>(x + okB);
    }
    __device__ const uint2* kFp() const {
        return reinterpret_cast<const uint2*>(x + okF);
    }
};

// Half j's X, P/Q and tr sit j * xhalf bytes, j * phalf ints and 8 j
// words past half 0's.
__device__ __forceinline__ int xhalf(const MmaCtx& L) { return 256 * L.kt; }
__device__ __forceinline__ int phalf(const MmaCtx& L) { return 256 * L.mt; }

// Call with every thread of the block before any other function here;
// smem is the block's rns_mma_bytes(K, T == 8, H) bytes, 128-byte aligned.
template <int T, int H = 1>
__device__ __forceinline__ void mma_setup(MmaCtx& L, unsigned char* smem,
                                          const int* tab,
                                          const unsigned char* wmma, int K,
                                          int B) {
    constexpr int G = T / 4;
    const int t = threadIdx.x;
    L.K = K;
    L.B = B;
    L.c = t / G;
    L.col = 4 * (t % G);
    L.cb = blockIdx.x * T + L.col;
    L.hasA = L.c < K;
    L.hasBr = L.c <= K;
    const int kp = rns_kpad(K), mp = rns_mpad(K);
    L.kt = kp / 16;
    L.mt = mp / 32;
    L.pA = L.hasA ? (uint32_t)tab[RNS_TAB_P(K) + L.c] : 3u;
    L.pBr = L.hasBr ? (uint32_t)tab[RNS_TAB_P(K) + K + L.c] : 3u;
    L.mA = barrett_m(L.pA);
    L.mBr = barrett_m(L.pBr);
    L.qinv = (uint32_t)tab[RNS_TAB_QINV(K)];
    L.mask = (uint32_t)tab[RNS_TAB_P(K) + 2 * K] - 1u;
    L.x = smem;
    L.oP = 16 * kp * H;
    L.oQ = L.oP + 32 * mp * H;
    L.otr = L.oQ + 32 * mp * H;
    L.okA = L.otr + 32 * H;
    L.okB = L.okA + 16 * mp;
    L.okF = L.okB + 16 * mp;
    uint4* kA = reinterpret_cast<uint4*>(smem + L.okA);
    uint4* kB = kA + mp;
    uint2* kF = reinterpret_cast<uint2*>(kB + mp);
    for (int c = t; c <= K; c += blockDim.x) {     // pair K: the r channel
        const bool a = c < K;
        const uint32_t pa = a ? (uint32_t)tab[RNS_TAB_P(K) + c] : 3u;
        const uint32_t pb = (uint32_t)tab[RNS_TAB_P(K) + K + c];
        const uint32_t c1 = a ? (uint32_t)tab[RNS_TAB_C1(K) + c] : 0u;
        const uint32_t qm = a ? (uint32_t)tab[RNS_TAB_QMOD(K) + c] : 0u;
        const uint32_t qdi = a ? (uint32_t)tab[RNS_TAB_QDI(K) + c] : 0u;
        kA[c] = uint4{c1, shoup_w(c1, pa), qm, shoup_w(qm, pa)};
        kB[c] = uint4{(uint32_t)tab[RNS_TAB_PINV(K) + c],
                      (uint32_t)tab[RNS_TAB_NPINV(K) + c], qdi,
                      shoup_w(qdi, pb)};
        kF[c] = uint2{a ? (uint32_t)tab[RNS_TAB_FSUB(K) + c] : 0u,
                      (uint32_t)tab[RNS_TAB_FSUB(K) + K + c]};
    }
    // X's padding rows and unused curve columns stay zero (the weights of
    // padding rows are zero too)
    uint4* x4 = reinterpret_cast<uint4*>(L.x);
    for (int i = t; i < kp * H; i += blockDim.x) x4[i] = uint4{0, 0, 0, 0};
    if (T == 8) {                                   // resident weights
        uint4* w4 = reinterpret_cast<uint4*>(kF + mp);
        const uint4* g4 = reinterpret_cast<const uint4*>(wmma);
        const size_t n = (size_t)kp * mp / 4;   // 4 planes / 16 bytes
        for (size_t i = t; i < n; i += blockDim.x) w4[i] = g4[i];
        L.w = reinterpret_cast<const unsigned char*>(w4);
    } else {
        L.w = wmma;
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// plane rows <-> registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load4(uint32_t v[4], const int* row,
                                      bool has, const MmaCtx& L) {
    const int* p = row + L.cb;
    if (has && (L.B & 3) == 0 && L.cb < L.B) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        v[0] = u.x;
        v[1] = u.y;
        v[2] = u.z;
        v[3] = u.w;
        return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
        v[i] = (has && L.cb + i < L.B) ? (uint32_t)p[i] : 0u;
}

__device__ __forceinline__ void store4(int* row, const uint32_t v[4],
                                       bool has, const MmaCtx& L) {
    int* p = row + L.cb;
    if (has && (L.B & 3) == 0 && L.cb < L.B) {
        *reinterpret_cast<uint4*>(p) = uint4{v[0], v[1], v[2], v[3]};
        return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (has && L.cb + i < L.B) p[i] = (int)v[i];
}

__device__ __forceinline__ void load_mv(MV& v, const int* plane,
                                        const MmaCtx& L) {
    load4(v.a, plane + (size_t)L.c * L.B, L.hasA, L);
    load4(v.r, plane + (size_t)(L.K + L.c) * L.B, L.hasBr, L);
}

// Asks L2 for the rows load_mv(plane, L) reads, so that a later load_mv
// finds them there without holding registers meanwhile (no-op on the
// CPU).
__device__ __forceinline__ void prefetch_mv(const int* plane,
                                            const MmaCtx& L) {
#ifdef __CUDA_ARCH__
    if (L.cb < L.B) {
        if (L.hasA)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(
                plane + (size_t)L.c * L.B + L.cb));
        if (L.hasBr)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(
                plane + (size_t)(L.K + L.c) * L.B + L.cb));
    }
#endif
}

__device__ __forceinline__ void store_mv(int* plane, const MV& v,
                                         const MmaCtx& L) {
    store4(plane + (size_t)L.c * L.B, v.a, L.hasA, L);
    store4(plane + (size_t)(L.K + L.c) * L.B, v.r, L.hasBr, L);
}

// ---------------------------------------------------------------------------
// the extension dots
// ---------------------------------------------------------------------------

// The thread's four dot inputs of channel c (< K) into half j of X's two
// planes: tile c / 16, curve columns col .. col + 3, row c % 16 of each.
__device__ __forceinline__ void put_x(const MmaCtx& L, const uint32_t v[4],
                                      int j = 0) {
    unsigned char* x = L.x + j * xhalf(L) + (L.c >> 4) * 128 + 16 * L.col
                       + (L.c & 15);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        x[16 * i] = (unsigned char)v[i];
        x[16 * i + 128 * L.kt] = (unsigned char)(v[i] >> 8);
    }
}

// P and Q of output rows [0, K] and the 8 curve columns of each of the H
// halves from the dot input in X and weight planes `plane` (lo) and
// plane + 1 (hi): item 2m + h is M tile m with the weights' lo (h = 0,
// into P) or hi (h = 1, into Q) byte.  The operands are stored as the
// integer mma takes them, A row-major and B column-major, each tile 16
// bytes a row and contiguous (A: 32 x 16, 512 bytes; B: 8 curves x 16
// channels, 128 bytes), so a fragment is a few whole-row loads; the other
// layouts cost a byte load per element.  A weight fragment, loaded once,
// multiplies every half's inputs (2H accumulator chains a warp).  With
// the weights in global memory (T = 4) the k loop is not unrolled:
// fragments fetched ahead would not fit the registers of 17 warps.
template <int T, int H = 1>
__device__ __forceinline__ void ext_dot(const MmaCtx& L, int plane) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
    const size_t wsz = (size_t)L.mt * L.kt * 512;
    const unsigned char* xlo = L.x;
    const unsigned char* xhi = L.x + 128 * L.kt;
    for (int item = warp; item < 2 * L.mt; item += warps) {
        const int m = item >> 1, h = item & 1;
        const unsigned char* w = L.w + (plane + h) * wsz
                                 + (size_t)m * L.kt * 512;
        wmma::fragment<wmma::accumulator, 32, 8, 16, int> lo[H], hi[H];
#pragma unroll
        for (int j = 0; j < H; ++j) {
            wmma::fill_fragment(lo[j], 0);
            wmma::fill_fragment(hi[j], 0);
        }
        auto step = [&](int k) {
            wmma::fragment<wmma::matrix_a, 32, 8, 16, unsigned char,
                           wmma::row_major> a;
            wmma::load_matrix_sync(a, w + 512 * k, 16);
#pragma unroll
            for (int j = 0; j < H; ++j) {
                wmma::fragment<wmma::matrix_b, 32, 8, 16, unsigned char,
                               wmma::col_major> vl, vh;
                wmma::load_matrix_sync(vl, xlo + j * xhalf(L) + 128 * k, 16);
                wmma::load_matrix_sync(vh, xhi + j * xhalf(L) + 128 * k, 16);
                wmma::mma_sync(lo[j], a, vl, lo[j]);
                wmma::mma_sync(hi[j], a, vh, hi[j]);
            }
        };
        if constexpr (T == 8) {
            for (int k = 0; k < L.kt; ++k) step(k);
        } else {
#pragma unroll 1
            for (int k = 0; k < L.kt; ++k) step(k);
        }
        // the same element of two accumulators of one type is the same
        // (row, column)
#pragma unroll
        for (int j = 0; j < H; ++j) {
            for (int i = 0; i < lo[j].num_elements; ++i)
                lo[j].x[i] += hi[j].x[i] << 8;
            int* out = (h ? L.Qp() : L.Pp()) + j * phalf(L) + 256 * m;
            wmma::store_matrix_sync(out, lo[j], 8, wmma::mem_row_major);
        }
    }
}

// ---------------------------------------------------------------------------
// channel arithmetic
// ---------------------------------------------------------------------------

// Phase A of a product: s = x*y per channel; sigma = s_A * c1 into X's
// half j; the B/r channel's s into sR.
__device__ __forceinline__ void mul_head(uint32_t sR[4], const MV& x,
                                         const MV& y, const MmaCtx& L,
                                         int j = 0) {
    if (L.hasA) {
        const uint4 k = L.kAp()[L.c];
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            v[i] = mulc(red(x.a[i] * y.a[i], L.pA, L.mA), k.x, k.y, L.pA);
        put_x(L, v, j);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sR[i] = red(x.r[i] * y.r[i], L.pBr, L.mBr);
}

// Phase C, after the first dot: t = s*P^-1 + M0*(N P^-1) into o.r; tau =
// t_B * qdivinv into X, t_r into tr (half j of each).
__device__ __forceinline__ void mul_mid(MV& o, const uint32_t sR[4],
                                        const MmaCtx& L, int j = 0) {
    const int col = L.col;
    if (!L.hasBr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o.r[i] = 0;
        return;
    }
    const uint4 k = L.kBp()[L.c];
    const int ph = j * phalf(L);
    const int4 P = *reinterpret_cast<const int4*>(L.Pp() + ph + 8 * L.c + col);
    const int4 Q = *reinterpret_cast<const int4*>(L.Qp() + ph + 8 * L.c + col);
    const uint32_t Ps[4] = {(uint32_t)P.x, (uint32_t)P.y, (uint32_t)P.z,
                            (uint32_t)P.w};
    const uint32_t Qs[4] = {(uint32_t)Q.x, (uint32_t)Q.y, (uint32_t)Q.z,
                            (uint32_t)Q.w};
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t m0 = chan(Ps[i], Qs[i], L.pBr, L.mBr);
        o.r[i] = red(sR[i] * k.x + m0 * k.y, L.pBr, L.mBr);
        v[i] = mulc(o.r[i], k.z, k.w, L.pBr);
    }
    if (L.hasA) {
        put_x(L, v, j);
    } else {                                    // pair K: the r channel
#pragma unroll
        for (int i = 0; i < 4; ++i) L.trp()[8 * j + col + i] = o.r[i];
    }
}

// Phase E, after the second dot: beta from S2's r row and t_r, then t_A =
// S2_A - beta*|Q|_p into o.a (half j).
__device__ __forceinline__ void mul_tail(MV& o, const MmaCtx& L,
                                         int j = 0) {
    const int col = L.col;
    if (!L.hasA) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o.a[i] = 0;
        return;
    }
    const uint4 k = L.kAp()[L.c];
    const uint32_t* P = reinterpret_cast<const uint32_t*>(L.Pp())
                        + j * phalf(L) + col;
    const uint32_t* Q = reinterpret_cast<const uint32_t*>(L.Qp())
                        + j * phalf(L) + col;
    const uint32_t* tr = L.trp() + 8 * j + col;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        // S2's exact low 14 bits on the r row
        const uint32_t s2r = P[8 * L.K + i] + (Q[8 * L.K + i] << 8);
        const uint32_t beta = ((s2r - tr[i]) & L.mask) * L.qinv & L.mask;
        const uint32_t d = chan(P[8 * L.c + i], Q[8 * L.c + i], L.pA, L.mA)
                           - mulc(beta, k.z, k.w, L.pA);
        o.a[i] = umin32(d, d + L.pA);
    }
}

// o = x*y/P (rns.mont_mul); o may alias x or y.  Every thread must call it.
template <int T>
__device__ __forceinline__ void mma_mul(MV& o, const MV& x, const MV& y,
                                        const MmaCtx& L) {
    uint32_t sR[4];
    mul_head(sR, x, y, L);
    __syncthreads();
    ext_dot<T>(L, 0);
    __syncthreads();
    mul_mid(o, sR, L);
    __syncthreads();
    ext_dot<T>(L, 2);
    __syncthreads();
    mul_tail(o, L);
}

// o0 = x0*y0/P and o1 = x1*y1/P, independent products of the same curves
// through halves 0 and 1 (a block set up with H = 2), their dots as one;
// any of o0, o1 may alias any input.  Every thread must call it.
template <int T>
__device__ __forceinline__ void mma_mul2(MV& o0, const MV& x0, const MV& y0,
                                         MV& o1, const MV& x1, const MV& y1,
                                         const MmaCtx& L) {
    uint32_t s0[4], s1[4];
    mul_head(s0, x0, y0, L, 0);
    mul_head(s1, x1, y1, L, 1);
    __syncthreads();
    ext_dot<T, 2>(L, 0);
    __syncthreads();
    mul_mid(o0, s0, L, 0);
    mul_mid(o1, s1, L, 1);
    __syncthreads();
    ext_dot<T, 2>(L, 2);
    __syncthreads();
    mul_tail(o0, L, 0);
    mul_tail(o1, L, 1);
}

// o0 = x0*y0 and o1 = x1*y1: one paired pass (H = 2) or two products in
// turn (H = 1; o0 must not alias x1 or y1)
template <int T, int H>
__device__ __forceinline__ void mma_mul_pair(MV& o0, const MV& x0,
                                             const MV& y0, MV& o1,
                                             const MV& x1, const MV& y1,
                                             const MmaCtx& L) {
    if constexpr (H == 2) {
        mma_mul2<T>(o0, x0, y0, o1, x1, y1, L);
    } else {
        mma_mul<T>(o0, x0, y0, L);
        mma_mul<T>(o1, x1, y1, L);
    }
}

__device__ __forceinline__ uint32_t add_ch(uint32_t x, uint32_t y,
                                           uint32_t p) {
    const uint32_t z = x + y;
    return umin32(z, z - p);
}

// x - y + f mod p for canonical x, y, f: x + f + p - y lies in (0, 3p)
__device__ __forceinline__ uint32_t sub_ch(uint32_t x, uint32_t y,
                                           uint32_t f, uint32_t p) {
    uint32_t z = x + f + p - y;
    z = umin32(z, z - p);
    return umin32(z, z - p);
}

__device__ __forceinline__ void mma_add(MV& o, const MV& x, const MV& y,
                                        const MmaCtx& L) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        o.a[i] = add_ch(x.a[i], y.a[i], L.pA);
        o.r[i] = add_ch(x.r[i], y.r[i], L.pBr);
    }
}

// x - y + F (rns.sub; F = 2KN keeps the value nonnegative)
__device__ __forceinline__ void mma_sub(MV& o, const MV& x, const MV& y,
                                        const MmaCtx& L) {
    const uint2 f = L.kFp()[L.hasBr ? L.c : L.K];     // pairs past K: unused
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        o.a[i] = sub_ch(x.a[i], y.a[i], f.x, L.pA);
        o.r[i] = sub_ch(x.r[i], y.r[i], f.y, L.pBr);
    }
}
