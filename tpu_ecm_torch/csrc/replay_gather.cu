// K6 and K7, stage 2: the pairmap replay acc *= prod over entries of
// (Pa_inv[pa] - Pb[pb]) in the two step forms of the Pallas gather kernels.
//
//  * K6, replay_gather, replaces tpu_ecm/limbs/pallas_ops.py:
//    make_replay_executor (:735, its kernel at :664).  idx = [T, 2] int32
//    (pa, pb) pairs, T a multiple of E; each step takes E entries.  A pad
//    entry (G, 0) reads pa_ext[G] = the one (R mod n in REDC mode, 1 in
//    fold mode) and pbx[0] = 0.
//  * K7, replay_parow, replaces pallas_ops.py:make_replay_parow_executor
//    (:834, its kernel at :761).  steps = [S, 1 + E] int32 rows [pa, pb_0
//    .. pb_{E-1}]: the E entries of a step share one Pa row, which is read
//    once per step.  An entry with pb == 0 takes the `one` plane itself
//    (no lazy pass) instead of pa - pbx[0] (a pad inside a step would
//    otherwise multiply by pa); a whole pad step has pa = G.
//
// In both, each difference gets one lazy pass and the step's E differences
// multiply in the pairwise tree ((d0 d1)(d2 d3))... of the Pallas kernels
// (limbs/kernels.py:step_roots), then the root goes into acc once, in step
// order, so the digits equal the plain versions' (residues are not
// canonical: the association is part of the result).
//
// Bound on the H100: integer multiply-adds, (E-1)/E + 1/E = 1 modular
// product per entry, against two nw*4-byte row gathers per entry and curve
// in K6 and 1 + 1/E in K7 (a v-sorted call's Pa rows repeat, so they mostly
// stay in L2; the Pb rows come from device memory).
//
// Design (csrc/arith_lanes.cuh, as K1-K5 and K9): a group of L lanes works
// on one curve, each lane owning D digits of every value, the products'
// columns in registers; limbs/kernels.py:tape_geometry picks L and D.  The
// products of one tree level are independent, so every product step is a
// pair.  The tree is walked depth first in pairs of subtrees of equal
// height, as K14 (csrc/rns_replay_gather.cu) walks it: at E = 16 a step's
// passes are
//   (d0 d1 | d2 d3) (d4 d5 | d6 d7) (L1_0 L1_1 | L1_2 L1_3)
//   (d8 d9 | ..) (d12 d13 | ..) (L1_4 L1_5 | L1_6 L1_7)
//   (L2_0 L2_1 | L2_2 L2_3) (L3_0 L3_1 | acc * root of the step before)
// so the root's pass also carries the previous step's acc *= root, which
// does not depend on it: E/2 full passes for E products (RG_PROG).  Only
// the first step's root pass (its partner spent) and the last acc *= root
// run alone; E = 1 is a chain acc *= d, its partner spent.  A step's
// differences come in leaf groups of min(E, 4) entries, formed in place
// over their Pb rows in one of two buffers of four slots while the next
// group's Pb rows are copied into the other with cp.async (K5's
// prefetch_pb).  K6 keeps the current Pa row in a slot and reloads it only
// when pa changes (K5's form_diff); K7 copies a step's Pa row with its
// first group, and a pad's `one` plane into the pad's slot, where it stays
// as it is.  Every thread reads the same entry (uniform, no divergence),
// and a lane past the batch computes on the last curve and stores nothing,
// so every lane reaches every shuffle and barrier.  One call site of the
// product.
#include "arith_lanes.cuh"
#include "replay_tree.cuh"

// K6's and K7's values in their RG_SLOTS slots a curve: acc, the pending
// root, the Pa row, two stashed level-1 and two level-2 products, a slot
// for a spent product, and two buffers of a leaf group's four Pb rows
// (their differences formed over them; buffer k % 2 holds group k).
enum {
    RG_ACC, RG_ROOT, RG_PA, RG_S1A, RG_S1B, RG_S2A, RG_S2B, RG_SPENT,
    RG_BUF,
    RG_SLOTS = RG_BUF + 8
};
// In a pass's table, entry i of the step's leaf group j (its buffer slot)
#define RG_LEAF(j, i) (RG_SLOTS + 4 * (j) + (i))

// A product step of the tree: the step's leaf group `leaf` is formed first
// (-1: none), then d0 = a0*b0 beside d1 = a1*b1 (slots or RG_LEAF codes)
struct RgPass {
    signed char leaf, d0, a0, b0, d1, a1, b1;
};

// The passes of a step at E entries from RG_PROG[E / 2] (E = 1: [0]),
// max(E / 2, 1) of them, then the last root into acc, RG_PROG[RG_LAST].
// A pass whose second product reads RG_ROOT (acc *= the previous root)
// spends it at the first step.
__device__ const RgPass RG_PROG[] = {
    // E = 1: acc *= d, the partner spent
    {0, RG_ACC, RG_ACC, RG_LEAF(0, 0), RG_SPENT, RG_ACC, RG_LEAF(0, 0)},
    // E = 2: root = d0 d1 beside acc *= the previous root
    {0, RG_ROOT, RG_LEAF(0, 0), RG_LEAF(0, 1), RG_ACC, RG_ACC, RG_ROOT},
    // E = 4
    {0, RG_LEAF(0, 0), RG_LEAF(0, 0), RG_LEAF(0, 1), RG_LEAF(0, 2),
     RG_LEAF(0, 2), RG_LEAF(0, 3)},
    {-1, RG_ROOT, RG_LEAF(0, 0), RG_LEAF(0, 2), RG_ACC, RG_ACC, RG_ROOT},
    // E = 8
    {0, RG_S1A, RG_LEAF(0, 0), RG_LEAF(0, 1), RG_S1B, RG_LEAF(0, 2),
     RG_LEAF(0, 3)},
    {1, RG_LEAF(1, 0), RG_LEAF(1, 0), RG_LEAF(1, 1), RG_LEAF(1, 2),
     RG_LEAF(1, 2), RG_LEAF(1, 3)},
    {-1, RG_S1A, RG_S1A, RG_S1B, RG_S1B, RG_LEAF(1, 0), RG_LEAF(1, 2)},
    {-1, RG_ROOT, RG_S1A, RG_S1B, RG_ACC, RG_ACC, RG_ROOT},
    // E = 16
    {0, RG_S1A, RG_LEAF(0, 0), RG_LEAF(0, 1), RG_S1B, RG_LEAF(0, 2),
     RG_LEAF(0, 3)},
    {1, RG_LEAF(1, 0), RG_LEAF(1, 0), RG_LEAF(1, 1), RG_LEAF(1, 2),
     RG_LEAF(1, 2), RG_LEAF(1, 3)},
    {-1, RG_S2A, RG_S1A, RG_S1B, RG_S2B, RG_LEAF(1, 0), RG_LEAF(1, 2)},
    {2, RG_S1A, RG_LEAF(2, 0), RG_LEAF(2, 1), RG_S1B, RG_LEAF(2, 2),
     RG_LEAF(2, 3)},
    {3, RG_LEAF(3, 0), RG_LEAF(3, 0), RG_LEAF(3, 1), RG_LEAF(3, 2),
     RG_LEAF(3, 2), RG_LEAF(3, 3)},
    {-1, RG_S1A, RG_S1A, RG_S1B, RG_S1B, RG_LEAF(3, 0), RG_LEAF(3, 2)},
    {-1, RG_S2A, RG_S2A, RG_S2B, RG_S2B, RG_S1A, RG_S1B},
    {-1, RG_ROOT, RG_S2A, RG_S2B, RG_ACC, RG_ACC, RG_ROOT},
    // the last root into acc, the partner spent
    {-1, RG_ACC, RG_ACC, RG_ROOT, RG_SPENT, RG_ACC, RG_ROOT},
};
#define RG_LAST 16

// One call: the tables (curve column applied), the entries, and the
// shape of a step: E entries in G leaf groups of Q.
struct RgCall {
    const int* pa_ext;
    const int* pbx;
    const int* one;     // K7
    const int* idx;     // K6: [T, 2] pairs; K7: [S, 1 + E] steps
    size_t row, sB;     // words of a table row, curves
    int E, Q, G;
};

// The rows of entry i of leaf group k: pa and pb (K7: the step's pa)
template <bool PAROW>
__device__ __forceinline__ void rg_entry(const RgCall& c, int k, int i,
                                         int& pa, int& pb) {
    if (PAROW) {
        const int* st = c.idx + (size_t)(k / c.G) * (1 + c.E);
        pa = st[0];
        pb = st[1 + (k % c.G) * c.Q + i];
    } else {
        const int* ent = c.idx + 2 * ((size_t)k * c.Q + i);
        pa = ent[0];
        pb = ent[1];
    }
}

// cp.async this lane's digits of leaf group k's Pb rows (K7: `one` for
// pb == 0, and the step's Pa row with its first group) into buffer k % 2,
// as one group (empty past the call's last group).
template <int D, bool PAROW>
__device__ __forceinline__ void rg_prefetch(const RgCall& c, int k,
                                            int groups, const Group& g) {
    if (k < groups) {
        int pa = 0, pb = 0;
        for (int i = 0; i < c.Q; ++i) {
            rg_entry<PAROW>(c, k, i, pa, pb);
            const int* src = c.pbx + (uint32_t)pb * c.row;
            if (PAROW && pb == 0) src = c.one;
            copy_slot_async<D>(g.slot(RG_BUF + 4 * (k & 1) + i), src, c.sB,
                               g);
        }
        if (PAROW && k % c.G == 0)
            copy_slot_async<D>(g.slot(RG_PA), c.pa_ext + (uint32_t)pa * c.row,
                               c.sB, g);
    }
    __pipeline_commit();
}

// The differences pa_ext[pa] - pbx[pb] of leaf group k over its Pb rows in
// buffer k % 2 (after __pipeline_wait_prior), one lazy pass each; K6
// reads the Pa row into its slot when it changes (pa_row: the row the slot
// holds), K7 leaves a pad's `one` as it is.
template <int D, bool PAROW>
__device__ __forceinline__ void rg_form(const RgCall& c, int k, int& pa_row,
                                        const Group& g) {
    int pa, pb;
    for (int i = 0; i < c.Q; ++i) {
        rg_entry<PAROW>(c, k, i, pa, pb);
        int* d = g.slot(RG_BUF + 4 * (k & 1) + i);
        if (PAROW) {
            if (pb == 0) continue;
        } else if (pa != pa_row) {
            load_slot<D>(g.slot(RG_PA), c.pa_ext + (uint32_t)pa * c.row,
                         c.sB, g, g.nw);
            pa_row = pa;
        }
        addsub_slots<D>(d, g.slot(RG_PA), d, true, g);
    }
}

// The kernel body of K6 (PAROW false; one unused) and K7 for one thread
// (__global__ wrappers below; tools/lane_shim runs it on the CPU).  m and
// smem are the block's shared Mod and dynamic shared memory.
template <int D, bool PAROW>
__device__ __forceinline__ void replay_gather_lanes(
    Mod& m, int* smem, const int* __restrict__ acc_in,
    int* __restrict__ acc_out, const int* __restrict__ pa_ext,
    const int* __restrict__ pbx, const int* __restrict__ idx,
    const int* __restrict__ one, int nsteps, int E, TPUECM_MOD_PARAMS,
    int B, int L) {
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D, RG_SLOTS>(smem, L, m);
    const int curve = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
    const bool live = curve < B;
    const int col = live ? curve : B - 1;
    const size_t sB = (size_t)B;
    const int Q = E < 4 ? E : 4;
    const RgCall c{pa_ext + col, pbx + col, PAROW ? one + col : one, idx,
                   (size_t)nw * sB, sB, E, Q, E / Q};
    const int passes = E > 1 ? E / 2 : 1;
    const int groups = nsteps * c.G;
    const int total = nsteps * passes + (E > 1 && nsteps > 0);
    load_slot<D>(g.slot(RG_ACC), acc_in + col, sB, g, nw);
    int pa_row = -1;
    rg_prefetch<D, PAROW>(c, 0, groups, g);
#pragma unroll 1
    for (int t = 0, s = 0, p = 0; t < total; ++t) {
        const RgPass st = RG_PROG[s < nsteps ? E / 2 + p : RG_LAST];
        const int k0 = s * c.G;         // the step's first leaf group
        if (st.leaf >= 0) {
            __pipeline_wait_prior(0);
            rg_form<D, PAROW>(c, k0 + st.leaf, pa_row, g);
            rg_prefetch<D, PAROW>(c, k0 + st.leaf + 1, groups, g);
        }
        const auto at = [&](int code) {
            return g.slot(code < RG_SLOTS
                              ? code
                              : RG_BUF + 4 * ((k0 + (code - RG_SLOTS) / 4) & 1)
                                    + (code & 3));
        };
        const bool spent = s == 0 && st.b1 == RG_ROOT;
        int* const dst[TPUECM_PAIR] = {at(st.d0),
                                       spent ? g.slot(RG_SPENT) : at(st.d1)};
        const int* const a[TPUECM_PAIR] = {at(st.a0), at(st.a1)};
        const int* const b[TPUECM_PAIR] = {at(st.b0), at(st.b1)};
        mul_slots<D, TPUECM_PAIR>(dst, a, b, g);
        if (++p == passes) {
            p = 0;
            ++s;
        }
    }
    if (live) store_slot<D>(acc_out + col, g.slot(RG_ACC), sB, g, nw);
}

#ifdef __CUDACC__
template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
replay_gather_lanes_kernel(const int* __restrict__ acc_in,
                           int* __restrict__ acc_out,
                           const int* __restrict__ pa_ext,
                           const int* __restrict__ pbx,
                           const int* __restrict__ idx, int nsteps, int E,
                           TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    replay_gather_lanes<D, false>(m, smem, acc_in, acc_out, pa_ext, pbx, idx,
                                  nullptr, nsteps, E, TPUECM_MOD_ARGS, B, L);
}

template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
replay_parow_lanes_kernel(const int* __restrict__ acc_in,
                          int* __restrict__ acc_out,
                          const int* __restrict__ pa_ext,
                          const int* __restrict__ pbx,
                          const int* __restrict__ steps,
                          const int* __restrict__ one, int nsteps, int E,
                          TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    replay_gather_lanes<D, true>(m, smem, acc_in, acc_out, pa_ext, pbx, steps,
                                 one, nsteps, E, TPUECM_MOD_ARGS, B, L);
}

extern "C" int tpuecm_replay_gather(const int* acc_in, int* acc_out,
                                    const int* pa_ext, const int* pbx,
                                    const int* idx, int nsteps, int E,
                                    TPUECM_MOD_PARAMS, int B, int lanes,
                                    int digits, void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits)
        || !step_args_ok(nsteps, E))
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes<D, RG_SLOTS>(
            replay_gather_lanes_kernel<D>, lanes, B, (cudaStream_t)stream,
            acc_in, acc_out, pa_ext, pbx, idx, nsteps, E, TPUECM_MOD_ARGS, B,
            lanes);
    });
}

extern "C" int tpuecm_replay_parow(const int* acc_in, int* acc_out,
                                   const int* pa_ext, const int* pbx,
                                   const int* steps, const int* one,
                                   int nsteps, int E, TPUECM_MOD_PARAMS,
                                   int B, int lanes, int digits,
                                   void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits)
        || !step_args_ok(nsteps, E))
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes<D, RG_SLOTS>(
            replay_parow_lanes_kernel<D>, lanes, B, (cudaStream_t)stream,
            acc_in, acc_out, pa_ext, pbx, steps, one, nsteps, E,
            TPUECM_MOD_ARGS, B, lanes);
    });
}

TPUECM_LANES_OCCUPANCY_SLOTS(tpuecm_replay_gather_occupancy,
                             replay_gather_lanes_kernel, RG_SLOTS)
TPUECM_LANES_OCCUPANCY_SLOTS(tpuecm_replay_parow_occupancy,
                             replay_parow_lanes_kernel, RG_SLOTS)
#endif
