// K14, stage 2 of the RNS engine: the pairmap replay acc *= prod over
// entries of (Pa_inv[pa] - Pb[pb]) in gather form, on [2K+1, B] residue
// planes.
//
// Replaces tpu_ecm/limbs/rns_exec.py:make_rns_replay_executor (:483, its
// kernel at :426), the RNS twin of the digit engine's gather kernel (K6,
// csrc/replay_gather.cu).
//
// idx = [S*E, 2] int32 (pa, pb) pairs, E a power of two <= 16; each step
// takes E entries.  Each difference is sub(pa_ext[pa], pbx[pb]) (x - y +
// F); the step's E differences multiply in the pairwise tree of the
// Pallas kernel (rns_exec.py:452-457, kernels.step_roots) and the root
// goes into acc once, in step order, so the residues equal that kernel's
// and the plain version's exactly (residues are not canonical mod n: the
// association is part of the result).  A pad entry (G, 0) multiplies by
// sub(one, 0) = one + F, which is one mod n.
//
// Bound on the H100: one RNS product per entry, its two extension dots
// (K x (K+1) multiply-adds each a curve) as exact u8 tensor-core products
// and about 60 integer instructions per channel pair beside them, against
// two row gathers of (2K+1)*4 bytes per entry and curve.  Entries are
// v-sorted, so Pa rows repeat and mostly stay in L2; the Pb rows do not
// (963 rows of 1.64 MB at row 21, K=200, B=1024): a call of 65,536
// entries gathers up to 107 GB of them from HBM, ~32 ms at 3.35 TB/s.
// The dots' wmma u8 m32n8k16 products keep the tensor pipe near its
// mma.sync rate (PERF.md), so a product costs what K10's does.
//
// Design (csrc/rns_mma.cuh, K10's core): one block per tile of T curves,
// all 2K+1 channels of them, for the whole call: T = 8 with the u8 weight
// planes in shared memory (128 blocks of 448 threads at row 21), T = 4
// with the fragments from the global table past K = 222.  Products of one
// tree level are independent, so they run two a pass (mma_mul2: a weight
// fragment loaded once serves both, four accumulator chains a warp, the
// four barriers shared).  The tree is walked depth first in pairs of
// subtrees of equal height (pair_trees); at E = 16 a step's passes are
//   (d0 d1 | d2 d3) (d4 d5 | d6 d7) (L1_0 L1_1 | L1_2 L1_3)
//   (d8 d9 | ..) (d12 d13 | ..) (L1_4 L1_5 | L1_6 L1_7)
//   (L2_0 L2_1 | L2_2 L2_3) (L3_0 L3_1 | acc * root of the step before)
// so the root's pass also carries the previous step's acc *= root, which
// does not depend on it: 8 full passes for 16 products.  Only the first
// step's root and the last acc *= root run alone.  E = 1 is a chain (acc
// *= d), one product a pass.  Where two halves do not fit beside the
// resident weights (208 < K <= 222) H = 1 runs the same schedule one
// product at a time (rns_gather_config); T = 4 always pairs.  Registers
// hold the tree's partial products (at most four, E = 16) beside a pass's
// inputs; acc and the pending root, used once a step, wait in global
// memory between root passes (acc_out, scratch plane 0), and so at T = 4
// (96 registers a thread at 17 warps) does a subtree pair while its
// sibling pair is formed (planes 1-4: rns_gather_scratch).  The index
// entries come through the entry ring of csrc/rns_ring.cuh, two 16-entry
// chunks ahead (cp.async), so a leaf pass's row loads wait on no index
// load.  Every thread reads the same entries and walks the same schedule,
// as the barriers of mma_mul require.
#include "rns_mma.cuh"
#include "rns_ring.cuh"

#define RNS_E_MAX 16
#define RNS_CHUNK 16            // entries staged together (RNS_E_MAX)

// (pa, pb) pairs in chunks of one largest step: 384 bytes
using GatherRing = EntryRing<2, RNS_CHUNK>;

// Scratch planes of (2K+1)*B int32 a call takes at tile T: the pending
// root, and at T = 4 the stash of two subtree pairs
__host__ __device__ constexpr int rns_gather_scratch(int T) {
    return T == 8 ? 1 : 5;
}

struct GatherArgs {
    const int* pa;              // pa_ext [G + 1][2K + 1][B]
    const int* pb;              // pbx [Pb][2K + 1][B]
    GatherRing ring;            // the call's entries [total][2]
    int* scratch;               // [rns_gather_scratch(T)][2K + 1][B]
    uint32_t row;               // (2K + 1) * B
};

// Plane r of a table
__device__ __forceinline__ const int* plane_at(const int* t, int r,
                                               const GatherArgs& g) {
    return t + (size_t)(uint32_t)r * g.row;
}

// d = sub(pa_ext[e[0]], pbx[e[1]])
__device__ __forceinline__ void gather_diff(MV& d, const int* e,
                                            const GatherArgs& g,
                                            const MmaCtx& L) {
    MV a;
    load_mv(a, plane_at(g.pa, e[0], g), L);
    load_mv(d, plane_at(g.pb, e[1], g), L);
    mma_sub(d, a, d, L);
}

// o0, o1 = the tree products of entries [0, 2^h) and [2^h, 2^(h+1)) from
// e (in the ring): two subtrees of height h, their own subtrees paired
// depth first.  At T = 4 the first pair waits for the second in scratch
// planes 2h - 3 and 2h - 2 (each thread its own elements).
template <int T, int H, int h>
__device__ __forceinline__ void pair_trees(MV& o0, MV& o1, const int* e,
                                           const GatherArgs& g,
                                           const MmaCtx& L) {
    if constexpr (h == 1) {
        MV d0, d1, d2, d3;
        gather_diff(d0, e, g, L);
        gather_diff(d1, e + 2, g, L);
        gather_diff(d2, e + 4, g, L);
        gather_diff(d3, e + 6, g, L);
        mma_mul_pair<T, H>(o0, d0, d1, o1, d2, d3, L);
    } else {
        MV a0, a1, b0, b1;
        [[maybe_unused]] int* stash =
            g.scratch + (size_t)(2 * h - 3) * g.row;
        pair_trees<T, H, h - 1>(a0, a1, e, g, L);
        if constexpr (T == 4) {         // 17 warps: 96 registers a thread
            store_mv(stash, a0, L);
            store_mv(stash + g.row, a1, L);
        }
        pair_trees<T, H, h - 1>(b0, b1, e + (2 << h), g, L);
        if constexpr (T == 4) {
            load_mv(a0, stash, L);
            load_mv(a1, stash + g.row, L);
        }
        mma_mul_pair<T, H>(o0, a0, a1, o1, b0, b1, L);
    }
}

// The two halves t0, t1 of a step of E = 2^lg entries (lg >= 1; e: its
// first entry in the ring): its root is t0 * t1
template <int T, int H>
__device__ __forceinline__ void step_halves(MV& t0, MV& t1, const int* e,
                                            int lg, const GatherArgs& g,
                                            const MmaCtx& L) {
    switch (lg) {
    case 1:
        gather_diff(t0, e, g, L);
        gather_diff(t1, e + 2, g, L);
        break;
    case 2:
        pair_trees<T, H, 1>(t0, t1, e, g, L);
        break;
    case 3:
        pair_trees<T, H, 2>(t0, t1, e, g, L);
        break;
    default:
        pair_trees<T, H, 3>(t0, t1, e, g, L);
    }
}

// The call shape the kernel takes: E a power of two <= 16, 0 <= nsteps * E
// < 2^31
inline bool gather_args_ok(int nsteps, int E) {
    return nsteps >= 0 && E >= 1 && E <= RNS_E_MAX && (E & (E - 1)) == 0
           && nsteps <= 0x7fffffff / RNS_E_MAX;
}

// K14's launch at `tile` (0: rns_mma_tile's beside the entry ring)
inline int rns_gather_config(int K, int B, int tile, RnsMmaLaunch& c) {
    return rns_paired_config(K, B, tile, GatherRing::kBytes, c);
}

// The kernel body on one block (smem: the entry ring, then
// rns_mma_bytes(K, T == 8, H) bytes for the core).  acc waits in acc_out
// and the pending root in scratch plane 0 (each thread its own elements)
// between root passes.
template <int T, int H>
__device__ __forceinline__ void rns_replay_gather_body(
        unsigned char* smem, const int* acc_in, int* acc_out, int* scratch,
        const int* pa_ext, const int* pbx, const int* idx, int nsteps, int E,
        const int* tab, const unsigned char* wmma, int K, int B) {
    MmaCtx L;
    mma_setup<T, H>(L, smem + GatherRing::kBytes, tab, wmma, K, B);
    const GatherArgs g{pa_ext, pbx,
                       {reinterpret_cast<int*>(smem), idx, nsteps * E},
                       scratch, (uint32_t)(2 * K + 1) * B};
    g.ring.stage(0);
    g.ring.stage(1);
    {
        MV acc;
        load_mv(acc, acc_in, L);
        store_mv(acc_out, acc, L);
    }
    g.ring.land();
    int lg = 0;
    while ((1 << lg) < E) ++lg;
    for (int s = 0, c = 0; s < nsteps; ++c) {
        g.ring.stage(c + 2);
        for (int k = 0; k < RNS_CHUNK / E && s < nsteps; ++k, ++s) {
            const int* e = g.ring.entry(s * E);
            MV acc, root;
            if (E == 1) {
                gather_diff(root, e, g, L);
                load_mv(acc, acc_out, L);
                mma_mul<T>(acc, acc, root, L);
                store_mv(acc_out, acc, L);
                continue;
            }
            MV t0, t1;
            step_halves<T, H>(t0, t1, e, lg, g, L);
            if (s == 0) {
                mma_mul<T>(root, t0, t1, L);
            } else {                    // acc *= the step before's root
                load_mv(acc, acc_out, L);
                load_mv(root, scratch, L);
                mma_mul_pair<T, H>(acc, acc, root, root, t0, t1, L);
                store_mv(acc_out, acc, L);
            }
            store_mv(scratch, root, L);
        }
        g.ring.land();                  // chunk c + 2 landed
    }
    if (E > 1 && nsteps > 0) {
        MV acc, root;
        load_mv(acc, acc_out, L);
        load_mv(root, scratch, L);
        mma_mul<T>(acc, acc, root, L);
        store_mv(acc_out, acc, L);
    }
}

#ifdef __CUDACC__
template <int T, int H>
__global__ void __launch_bounds__(rns_tape_max_threads(T))
rns_replay_gather_kernel(const int* __restrict__ acc_in,
                         int* __restrict__ acc_out,
                         int* __restrict__ scratch,
                         const int* __restrict__ pa_ext,
                         const int* __restrict__ pbx,
                         const int* __restrict__ idx, int nsteps, int E,
                         const int* __restrict__ tab,
                         const unsigned char* __restrict__ wmma, int K,
                         int B) {
    extern __shared__ __align__(128) unsigned char rns_mma_smem[];
    rns_replay_gather_body<T, H>(rns_mma_smem, acc_in, acc_out, scratch,
                                 pa_ext, pbx, idx, nsteps, E, tab, wmma, K,
                                 B);
}

template <int T, int H>
static int launch_gather(const RnsMmaLaunch& c, const int* acc_in,
                         int* acc_out, int* scratch, const int* pa_ext,
                         const int* pbx,
                         const int* idx, int nsteps, int E, const int* tab,
                         const unsigned char* wmma, int K, int B,
                         cudaStream_t stream) {
    if (c.smem > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            rns_replay_gather_kernel<T, H>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    rns_replay_gather_kernel<T, H><<<c.blocks, c.threads, c.smem, stream>>>(
        acc_in, acc_out, scratch, pa_ext, pbx, idx, nsteps, E, tab, wmma, K,
        B);
    return (int)cudaGetLastError();
}

// tile: rns_kernels.gather_geometry's (0: rns_gather_config's); scratch:
// [rns_gather_scratch(tile), 2K+1, B]; cudaErrorInvalidValue for E not a
// power of two <= 16 and for what rns_gather_config refuses
extern "C" int tpuecm_rns_replay_gather(const int* acc_in, int* acc_out,
                                        int* scratch, const int* pa_ext,
                                        const int* pbx, const int* idx,
                                        int nsteps, int E,
                                        const int* tab,
                                        const unsigned char* wmma, int K,
                                        int B, int tile, void* stream) {
    if (!gather_args_ok(nsteps, E)) return (int)cudaErrorInvalidValue;
    RnsMmaLaunch c;
    const int rc = rns_gather_config(K, B, tile, c);
    if (rc != (int)cudaSuccess) return rc;
    const cudaStream_t s = (cudaStream_t)stream;
    if (c.tile == 4)
        return launch_gather<4, 2>(c, acc_in, acc_out, scratch, pa_ext, pbx,
                                   idx, nsteps, E, tab, wmma, K, B, s);
    return c.halves == 2
        ? launch_gather<8, 2>(c, acc_in, acc_out, scratch, pa_ext, pbx, idx,
                              nsteps, E, tab, wmma, K, B, s)
        : launch_gather<8, 1>(c, acc_in, acc_out, scratch, pa_ext, pbx, idx,
                              nsteps, E, tab, wmma, K, B, s);
}
#endif

// K14's geometry at K, B and `tile` (0: its own) into out[7]: {tile,
// halves, threads, blocks, smem bytes, resident, scratch planes}, as
// rns_kernels.gather_geometry reads it; cudaErrorInvalidValue where
// rns_gather_config refuses
extern "C" int tpuecm_rns_gather_geometry(int K, int B, int tile,
                                          long long* out) {
    RnsMmaLaunch c;
    const int rc = rns_gather_config(K, B, tile, c);
    if (rc != (int)cudaSuccess) return rc;
    rns_mma_geometry(c, true, out);
    out[6] = rns_gather_scratch(c.tile);
    return rc;
}
