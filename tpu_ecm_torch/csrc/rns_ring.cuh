// The entry ring of the RNS replays K14 (csrc/rns_replay_gather.cu) and
// K15 (csrc/rns_replay.cu): a call's index entries, W ints each, come
// into shared memory by cp.async in chunks of C entries, RNS_RING_CHUNKS
// chunks at a time (the current one, the next one and the one landing),
// so that a pass's row loads wait on no index load.
//
// The kernel stages chunks 0 and 1 and calls land() before its first
// entry; then, for each chunk c, it stages chunk c + 2 when chunk c
// begins and calls land() when chunk c ends.  An entry may be read while
// its chunk is the current or the next one.  Every thread stages, lands
// and reads the same chunks, so the ring's barrier is uniform.
#pragma once

#include <cstddef>
#include <cuda_pipeline_primitives.h>

#define RNS_RING_CHUNKS 3       // chunks staged: current, next, landing

template <int W, int C>
struct EntryRing {
    static constexpr int kBytes = RNS_RING_CHUNKS * C * W * 4;

    int* ring;                  // shared [RNS_RING_CHUNKS][C][W]
    const int* idx;             // the call's entries [total][W]
    int total;                  // entries

    // Entry q of the call (q in the current or the next chunk)
    __device__ __forceinline__ const int* entry(int q) const {
        return ring + W * ((q / C) % RNS_RING_CHUNKS * C + q % C);
    }

    // Chunk k of the entries into the ring, an entry (4 W bytes) a
    // thread, committed as one cp.async group (empty past the call's end);
    // every launch of the RNS kernels has at least 64 threads
    __device__ __forceinline__ void stage(int k) const {
        static_assert(C <= 64, "a chunk takes one entry a thread");
        const int q = k * C + (int)threadIdx.x;
        if ((int)threadIdx.x < C && q < total)
            __pipeline_memcpy_async(
                ring + W * ((q / C) % RNS_RING_CHUNKS * C + q % C),
                idx + (size_t)W * q, 4 * W);
        __pipeline_commit();
    }

    // Waits for this thread's staged chunks, then makes every thread's
    // copies visible to the block
    __device__ __forceinline__ void land() const {
        __pipeline_wait_prior(0);
        __syncthreads();
    }
};
