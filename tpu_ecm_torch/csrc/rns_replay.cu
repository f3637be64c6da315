// K15, stage 2 of the RNS engine: the pairmap replay acc *= prod over
// entries of (Pa_inv[pa] - Pb[pb]) in stream form, on [2K+1, B] residue
// planes.
//
// Replaces tpu_ecm/limbs/rns_exec.py:make_rns_replay_stream_executor (:509,
// its pallas_call at :653) at its defaults (unroll=1, n_acc=1), which
// streamed Pb rows through a manual DMA ring of sublane-padded slabs and
// copied the Pa row only when pa changed (:587-594).
//
// The call's entries e = pa << 16 | pb retire one at a time, in entry
// order, as in the Pallas kernel: acc := acc * sub(pa_ext[pa], pbx[pb]).
// Nothing is re-associated (residues are not canonical mod n), so the
// residues equal that kernel's and rns_kernels.replay_plain's exactly.  A
// pad entry G << 16 | 0 multiplies by sub(one, 0) = one + F, which is one
// mod n.  A call of no entries copies acc.
//
// Bound on the H100: one RNS product per entry, its two extension dots
// (K x (K+1) multiply-adds each a curve) as exact u8 tensor-core products
// and about 60 integer instructions per channel pair beside them, against
// the tables read once (chip_smoke._rns_bound).  Entries are v-sorted, so
// pa changes about once in 16 entries and its row mostly stays in L2; the
// Pb rows come from the whole table (963 rows of 1.64 MB at row 21, K=200,
// B=1024).
//
// Design (csrc/rns_mma.cuh, the RNS engine's core): one block per tile of T
// curves, all 2K+1 channels of them, for the whole call, at K12's launch
// (rns_tape_config's: one product a pass) with the entry ring beside the
// core: T = 8 with the u8 weight planes in shared memory (128 blocks of
// 448 threads at row 21), T = 4 with the fragments from the global table
// past K = 222.  An entry's product depends on the one before, so a pass
// holds one product (mma_mul), as in K12.  acc stays in registers for the
// whole call and is stored once.  The Pa row stays in registers too and
// is reloaded only when pa changes (every thread reads the same entry, so
// the branch is uniform).  Entry k + 1's Pb row, and its Pa row where pa
// changes, are loaded before entry k's pass, and the difference is formed
// when the pass ends: the rows have a pass to arrive.  (Loaded at each
// entry's start instead, as K12 does at T = 4, nvcc 12.9 gave T = 4 an
// 8-byte stack frame and spills; loaded ahead, it uses 84 registers of
// 96 and spills nothing: PERF.md section 6.)  The entries come through
// the entry ring of csrc/rns_ring.cuh, in 64-entry chunks (4 bytes an
// entry).  load_mv and store_mv share the thread map (curves past B load
// as zeros and are never stored).  Every thread walks the same entries,
// as mma_mul's barriers require.
#include "rns_mma.cuh"
#include "rns_ring.cuh"

#define RNS_REPLAY_CHUNK 64     // entries staged together

// e = pa << 16 | pb in chunks of 64: 768 bytes
using ReplayRing = EntryRing<1, RNS_REPLAY_CHUNK>;

// K15's launch at `tile` (0: rns_mma_tile's beside the entry ring): one
// half, as K12's
inline int rns_replay_config(int K, int B, int tile, RnsMmaLaunch& c) {
    const size_t extra = ReplayRing::kBytes;
    return rns_mma_config(K, B, tile ? tile : rns_mma_tile(K, extra), 1,
                          extra, c);
}

// The kernel body on one block (smem: the entry ring, then
// rns_mma_bytes(K, T == 8, 1) bytes for the core); idx holds the call's
// `count` entries.
template <int T>
__device__ __forceinline__ void rns_replay_body(
        unsigned char* smem, const int* acc_in, int* acc_out,
        const int* pa_ext, const int* pbx, const int* idx, int count,
        const int* tab, const unsigned char* wmma, int K, int B) {
    MmaCtx L;
    mma_setup<T, 1>(L, smem + ReplayRing::kBytes, tab, wmma, K, B);
    const ReplayRing ring{reinterpret_cast<int*>(smem), idx, count};
    const size_t row = (size_t)(2 * K + 1) * B;
    ring.stage(0);
    ring.stage(1);
    MV acc, pa, pb, d;
    load_mv(acc, acc_in, L);
    ring.land();
    int cur = -1;                       // the Pa row in pa
    // entry k's Pb row into pb, and its Pa row into pa where pa changes
    auto fetch = [&](int k) {
        const uint32_t e = (uint32_t)*ring.entry(k);
        const int a = (int)(e >> 16);
        if (a != cur) {
            load_mv(pa, pa_ext + (size_t)a * row, L);
            cur = a;
        }
        load_mv(pb, pbx + (size_t)(e & 0xFFFFu) * row, L);
    };
    if (count > 0) fetch(0);
    for (int c = 0, k = 0; k < count; ++c) {
        ring.stage(c + 2);
        const int end = count - k < RNS_REPLAY_CHUNK
                        ? count : k + RNS_REPLAY_CHUNK;
        for (; k < end; ++k) {
            mma_sub(d, pa, pb, L);
            if (k + 1 < count) fetch(k + 1);
            mma_mul<T>(acc, acc, d, L);
        }
        ring.land();                    // chunk c + 2 landed
    }
    store_mv(acc_out, acc, L);
}

#ifdef __CUDACC__
template <int T>
__global__ void __launch_bounds__(rns_tape_max_threads(T))
rns_replay_kernel(const int* __restrict__ acc_in, int* __restrict__ acc_out,
                  const int* __restrict__ pa_ext,
                  const int* __restrict__ pbx, const int* __restrict__ idx,
                  int count, const int* __restrict__ tab,
                  const unsigned char* __restrict__ wmma, int K, int B) {
    extern __shared__ __align__(128) unsigned char rns_mma_smem[];
    rns_replay_body<T>(rns_mma_smem, acc_in, acc_out, pa_ext, pbx, idx,
                       count, tab, wmma, K, B);
}

template <int T>
static int launch_replay(const RnsMmaLaunch& c, const int* acc_in,
                         int* acc_out, const int* pa_ext, const int* pbx,
                         const int* idx, int count, const int* tab,
                         const unsigned char* wmma, int K, int B,
                         cudaStream_t stream) {
    if (c.smem > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            rns_replay_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)c.smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    rns_replay_kernel<T><<<c.blocks, c.threads, c.smem, stream>>>(
        acc_in, acc_out, pa_ext, pbx, idx, count, tab, wmma, K, B);
    return (int)cudaGetLastError();
}

// idx: the call's `count` entries e = pa << 16 | pb (rns_kernels.replay's
// idx[1:1 + count]); tile: rns_kernels.replay_geometry's (0:
// rns_replay_config's); cudaErrorInvalidValue for count < 0 and for what
// rns_replay_config refuses
extern "C" int tpuecm_rns_replay(const int* acc_in, int* acc_out,
                                 const int* pa_ext, const int* pbx,
                                 const int* idx, int count, const int* tab,
                                 const unsigned char* wmma, int K, int B,
                                 int tile, void* stream) {
    if (count < 0) return (int)cudaErrorInvalidValue;
    RnsMmaLaunch c;
    const int rc = rns_replay_config(K, B, tile, c);
    if (rc != (int)cudaSuccess) return rc;
    const cudaStream_t s = (cudaStream_t)stream;
    return c.tile == 4
        ? launch_replay<4>(c, acc_in, acc_out, pa_ext, pbx, idx, count, tab,
                           wmma, K, B, s)
        : launch_replay<8>(c, acc_in, acc_out, pa_ext, pbx, idx, count, tab,
                           wmma, K, B, s);
}
#endif

// K15's geometry at K, B and `tile` (0: its own) into out[5]: {tile,
// threads, blocks, smem bytes, resident}, as rns_kernels.replay_geometry
// reads it; cudaErrorInvalidValue where rns_replay_config refuses
extern "C" int tpuecm_rns_replay_geometry(int K, int B, int tile,
                                          long long* out) {
    RnsMmaLaunch c;
    const int rc = rns_replay_config(K, B, tile, c);
    if (rc == (int)cudaSuccess) rns_mma_geometry(c, false, out);
    return rc;
}
