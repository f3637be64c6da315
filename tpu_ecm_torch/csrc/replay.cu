// K5, stage 2: the pairmap replay acc *= prod over entries of
// (Pa_inv[pa] - Pb[pb]), the cross product of the inverted form.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:make_replay_stream_executor at its
// default tree=4 (stage2/exec.py:1128), which streamed Pb rows through a
// manual DMA ring.
//
// idx = [count, e_0, ..., e_{T-1}] int32 with e = pa << 16 | pb.  The
// association is the Pallas kernel's: each difference gets one lazy pass,
// whole quadruples multiply as ((d0 d1)(d2 d3)) into acc in order, and the
// count % 4 tail entries multiply into acc one by one
// (limbs/kernels.py:replay_plain, which the kernel equals digit for digit).
// A pad entry G << 16 | 0 reads pa_ext[G] = the one (R mod n in REDC mode,
// 1 in fold mode) and pbx[0] = 0.
//
// Bound on the H100: integer multiply-adds, one modular product per entry
// (~2*nw^2 multiply-adds in REDC, ~nw^2 in the fold), against two nw*4-byte
// row reads per entry per curve; the Pb table (425 MB at the flagship) is
// larger than L2, so its rows come from device memory, ~6 ms of a 65,536-
// entry call at the flagship against ~20 ms of multiply-adds at the
// card's peak.
//
// Design (csrc/arith_lanes.cuh, as K1): a group of L lanes works on one
// curve, each lane owning D digits of every value, the products' columns
// in registers; limbs/kernels.py:tape_geometry picks L and D.  Every
// product step is a pair, software-pipelined across quadruples: step a of
// quadruple t forms (d0*d1, d2*d3), step b forms m_t = m01*m23 beside
// acc*m_{t-1}; after the last quadruple acc*m and each tail entry take a
// step with a spent partner.  So a quadruple takes two paired steps and
// the kernel one call site of the product.  Each lane forms its own digits
// of the differences (one lazy pass, a shuffle from the lane below).  The
// current Pa row sits in a slot and is reloaded only when pa changes (the
// v-sorted stream changes it every ~100 entries; every thread reads the
// same entry, so the test is uniform).  The next quadruple's Pb rows are
// copied into spare slots with cp.async while the current products run.
// A lane past the batch computes on the last curve and stores nothing, so
// every lane reaches every shuffle and barrier.
#include "arith_lanes.cuh"

// K5's values in the lane core's slots: acc, m_{t-1}, the current Pa row,
// the four differences of a quadruple (m01 over d0, m23 over d2; d1 is
// spent after step a and takes a step's unused product) and the next
// quadruple's four Pb rows.
enum {
    K5_ACC = SLOT_X, K5_M = SLOT_Z, K5_PA = SLOT_S,
    K5_D0 = SLOT_T0, K5_D1 = SLOT_T1, K5_D2 = SLOT_T2, K5_D3 = SLOT_T3,
    K5_PB0 = SLOT_X2    // K5_PB0 + i, i < 4: SLOT_X2, Z2, XD, ZD
};

// cp.async this lane's digits of the Pb rows of entries ent[0..k) into the
// Pb slots, as one group.
template <int D>
__device__ __forceinline__ void prefetch_pb(const int* ent, int k,
                                            const int* pbx, size_t row,
                                            size_t sB, const Group& g) {
    for (int i = 0; i < k; ++i)
        copy_slot_async<D>(g.slot(K5_PB0 + i),
                           pbx + ((uint32_t)ent[i] & 0xFFFFu) * row, sB, g);
    __pipeline_commit();
}

// The difference pa_ext[pa] - pbx[pb] of entry e = pa << 16 | pb into slot
// d, its Pb row prefetched into slot pb (after __pipeline_wait_prior); the
// Pa row is read into its slot when it changes (pa_row: the row the slot
// holds).
template <int D>
__device__ __forceinline__ void form_diff(int e, int d, int pb,
                                          const int* pa_ext, size_t row,
                                          size_t sB, int& pa_row,
                                          const Group& g) {
    const int pa = (int)((uint32_t)e >> 16);
    if (pa != pa_row) {
        load_slot<D>(g.slot(K5_PA), pa_ext + pa * row, sB, g, g.nw);
        pa_row = pa;
    }
    addsub_slots<D>(g.slot(d), g.slot(K5_PA), g.slot(pb), true, g);
}

// The kernel body for one thread (a __global__ wrapper below; tools/
// lane_shim runs it on the CPU).  m and smem are the block's shared Mod
// and dynamic shared memory.
template <int D>
__device__ __forceinline__ void replay_lanes(
    Mod& m, int* smem, const int* __restrict__ acc_in,
    int* __restrict__ acc_out, const int* __restrict__ pa_ext,
    const int* __restrict__ pbx, const int* __restrict__ idx,
    TPUECM_MOD_PARAMS, int B, int L) {
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D>(smem, L, m);
    const int curve = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
    const bool live = curve < B;
    const int col = live ? curve : B - 1;
    const size_t sB = (size_t)B;
    const size_t row = (size_t)nw * sB;
    pa_ext += col;
    pbx += col;
    const int count = idx[0];
    const int* ent = idx + 1;
    const int quads = count / 4, tail = count % 4;
    load_slot<D>(g.slot(K5_ACC), acc_in + col, sB, g, nw);
    int pa_row = -1;
    prefetch_pb<D>(ent, quads ? 4 : tail, pbx, row, sB, g);
    // steps: a and b of each quadruple, acc*m_last, one per tail entry
    const int steps = 2 * quads + (quads > 0) + tail;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
        int dst0, a0, b0, dst1 = K5_D1, a1 = K5_ACC, b1 = K5_ACC;
        if (s < 2 * quads && !(s & 1)) {        // step a of quadruple s/2
            const int* q = ent + 2 * s;
            __pipeline_wait_prior(0);
            for (int i = 0; i < 4; ++i)
                form_diff<D>(q[i], K5_D0 + i, K5_PB0 + i, pa_ext, row, sB,
                             pa_row, g);
            prefetch_pb<D>(q + 4, s / 2 + 1 < quads ? 4 : tail, pbx, row,
                           sB, g);
            dst0 = K5_D0, a0 = K5_D0, b0 = K5_D1;
            dst1 = K5_D2, a1 = K5_D2, b1 = K5_D3;
        } else if (s < 2 * quads) {             // step b: m_t, acc*m_{t-1}
            dst0 = K5_M, a0 = K5_D0, b0 = K5_D2;
            if (s > 1) dst1 = K5_ACC, a1 = K5_ACC, b1 = K5_M;
        } else if (quads && s == 2 * quads) {   // acc*m_last
            dst0 = K5_ACC, a0 = K5_ACC, b0 = K5_M;
        } else {                                // a tail entry
            const int i = s - 2 * quads - (quads > 0);
            __pipeline_wait_prior(0);
            form_diff<D>(ent[4 * quads + i], K5_D0, K5_PB0 + i, pa_ext, row,
                         sB, pa_row, g);
            dst0 = K5_ACC, a0 = K5_ACC, b0 = K5_D0;
        }
        int* const dst[TPUECM_PAIR] = {g.slot(dst0), g.slot(dst1)};
        const int* const a[TPUECM_PAIR] = {g.slot(a0), g.slot(a1)};
        const int* const b[TPUECM_PAIR] = {g.slot(b0), g.slot(b1)};
        mul_slots<D, TPUECM_PAIR>(dst, a, b, g);
    }
    if (live) store_slot<D>(acc_out + col, g.slot(K5_ACC), sB, g, nw);
}

#ifdef __CUDACC__
template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
replay_lanes_kernel(const int* __restrict__ acc_in, int* __restrict__ acc_out,
                    const int* __restrict__ pa_ext,
                    const int* __restrict__ pbx, const int* __restrict__ idx,
                    TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    replay_lanes<D>(m, smem, acc_in, acc_out, pa_ext, pbx, idx,
                    TPUECM_MOD_ARGS, B, L);
}

extern "C" int tpuecm_replay(const int* acc_in, int* acc_out,
                             const int* pa_ext, const int* pbx,
                             const int* idx, TPUECM_MOD_PARAMS, int B,
                             int lanes, int digits, void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits))
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes<D>(replay_lanes_kernel<D>, lanes, B,
                               (cudaStream_t)stream, acc_in, acc_out, pa_ext,
                               pbx, idx, TPUECM_MOD_ARGS, B, lanes);
    });
}

TPUECM_LANES_OCCUPANCY(tpuecm_replay_occupancy, replay_lanes_kernel)
#endif
