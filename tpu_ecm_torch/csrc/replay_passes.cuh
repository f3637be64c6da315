// The gather-form replays K6, K7 (csrc/replay_gather.cu) and K8
// (csrc/replay_resident.cu) on the lane core csrc/arith_lanes.cuh: one
// kernel body, replay_gather_lanes<D, MODE>, and its table of paired
// passes.  Each computes acc *= prod over entries of (Pa_inv[pa] - Pb[pb])
// in steps of E entries; the forms differ only in where a step's entries
// and Pb rows come from:
//  * RG_GATHER (K6): idx = [T, 2] (pa, pb) pairs, the Pb rows gathered
//    from pbx;
//  * RG_PAROW (K7): idx = [S, 1 + E] steps [pa, pb_0 .. pb_{E-1}] sharing
//    one Pa row, pb == 0 standing for the `one` plane (no lazy pass);
//  * RG_RESIDENT (K8): idx = [T, 2] (pa, u) pairs whose Pb rows are row u
//    of a slab of Pb rows held in shared memory (RgSlabs).
//
// Each difference gets one lazy pass and a step's E differences multiply
// in the pairwise tree ((d0 d1)(d2 d3))... of the Pallas kernels
// (limbs/kernels.py:step_roots), then the root goes into acc once, in step
// order, so the digits equal the plain versions' (residues are not
// canonical: the association is part of the result).
//
// A group of L lanes works on one curve, each lane owning D digits of
// every value, the products' columns in registers; limbs/kernels.py:
// tape_geometry picks L and D.  The products of one tree level are
// independent, so every product step is a pair.  The tree is walked depth
// first in pairs of subtrees of equal height, as K14
// (csrc/rns_replay_gather.cu) walks it: at E = 16 a step's passes are
//   (d0 d1 | d2 d3) (d4 d5 | d6 d7) (L1_0 L1_1 | L1_2 L1_3)
//   (d8 d9 | ..) (d12 d13 | ..) (L1_4 L1_5 | L1_6 L1_7)
//   (L2_0 L2_1 | L2_2 L2_3) (L3_0 L3_1 | acc * root of the step before)
// so the root's pass also carries the previous step's acc *= root, which
// does not depend on it: E/2 full passes for E products (RG_PROG).  Only
// the first step's root pass (its partner spent) and the last acc *= root
// run alone; E = 1 is a chain acc *= d, its partner spent.  A step's
// differences come in leaf groups of min(E, 4) entries.  K6 and K7 form
// them in place over their Pb rows in one of two buffers of four slots
// while the next group's Pb rows are copied into the other with cp.async
// (K5's prefetch_pb); K8 forms them from its slab rows into one buffer.
// K6 and K8 keep the current Pa row in a slot and reload it only when pa
// changes (K5's form_diff); K7 copies a step's Pa row with its first
// group, and a pad's `one` plane into the pad's slot, where it stays as it
// is.  Every thread reads the same entry (uniform, no divergence), and a
// lane past the batch computes on the last curve and stores nothing, so
// every lane reaches every shuffle and barrier.  One call site of the
// product.
#pragma once

#include "arith_lanes.cuh"

#define TPUECM_E_MAX 16

// The step shapes the gather-form replays take: nsteps >= 0 steps of E
// entries, E a power of two up to TPUECM_E_MAX.
__host__ inline bool step_args_ok(int nsteps, int E) {
    return nsteps >= 0 && E >= 1 && E <= TPUECM_E_MAX && (E & (E - 1)) == 0;
}

// The three forms of the body
enum { RG_GATHER, RG_PAROW, RG_RESIDENT };

// The values in a curve's slots: acc, the pending root, the Pa row, two
// stashed level-1 and two level-2 products, a slot for a spent product,
// and the buffers of a leaf group's four differences: two for K6 and K7
// (RG_SLOTS; buffer k % 2 holds group k, its Pb rows copied in ahead),
// one for K8 (RR_SLOTS: its Pb rows wait in the slab).
enum {
    RG_ACC, RG_ROOT, RG_PA, RG_S1A, RG_S1B, RG_S2A, RG_S2B, RG_SPENT,
    RG_BUF,
    RR_SLOTS = RG_BUF + 4,
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
// spends it at the first step.  No pass reads a leaf group after the next
// group is formed, so one buffer serves K8.
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

// K8's slab segments: seg = [nseg, 3] (lo, first step, steps), in step
// order, each over slab rows 1 .. cap = Pb rows lo .. lo + cap - 1 of a
// table of pb_rows rows (row 0 of the slab is the zero row).
struct RgSlabs {
    const int* seg;
    int nseg, cap, pb_rows;
};

// One call: the tables (curve column applied), the entries, K8's slab
// (its curve applied: row u at slab + u * srow) and the shape of a step:
// E entries in G leaf groups of Q.
struct RgCall {
    const int* pa_ext;
    const int* pbx;
    const int* one;     // K7
    const int* idx;     // K6, K8: [T, 2] pairs; K7: [S, 1 + E] steps
    const int* slab;    // K8
    size_t row, sB;     // words of a table row, curves
    int srow, E, Q, G;
};

// The buffer of leaf group k
template <int MODE>
__device__ __forceinline__ int rg_buf(int k) {
    return MODE == RG_RESIDENT ? RG_BUF : RG_BUF + 4 * (k & 1);
}

// The rows of entry i of leaf group k: pa and pb (K7: the step's pa; K8:
// pb is the slab row)
template <int MODE>
__device__ __forceinline__ void rg_entry(const RgCall& c, int k, int i,
                                         int& pa, int& pb) {
    if (MODE == RG_PAROW) {
        const int* st = c.idx + (size_t)(k / c.G) * (1 + c.E);
        pa = st[0];
        pb = st[1 + (k % c.G) * c.Q + i];
    } else {
        const int* ent = c.idx + 2 * ((size_t)k * c.Q + i);
        pa = ent[0];
        pb = ent[1];
    }
}

// K6, K7: cp.async this lane's digits of leaf group k's Pb rows (K7: `one`
// for pb == 0, and the step's Pa row with its first group) into its
// buffer, as one group (empty past the call's last group).
template <int D, int MODE>
__device__ __forceinline__ void rg_prefetch(const RgCall& c, int k,
                                            int groups, const Group& g) {
    if (k < groups) {
        int pa = 0, pb = 0;
        for (int i = 0; i < c.Q; ++i) {
            rg_entry<MODE>(c, k, i, pa, pb);
            const int* src = c.pbx + (uint32_t)pb * c.row;
            if (MODE == RG_PAROW && pb == 0) src = c.one;
            copy_slot_async<D>(g.slot(rg_buf<MODE>(k) + i), src, c.sB, g);
        }
        if (MODE == RG_PAROW && k % c.G == 0)
            copy_slot_async<D>(g.slot(RG_PA), c.pa_ext + (uint32_t)pa * c.row,
                               c.sB, g);
    }
    __pipeline_commit();
}

// The differences pa_ext[pa] - Pb row of leaf group k into its buffer, one
// lazy pass each: K6's Pb rows are in the buffer (after
// __pipeline_wait_prior), K8's in the slab; K6 and K8 read the Pa row into
// its slot when it changes (pa_row: the row the slot holds), K7 leaves a
// pad's `one` as it is.
template <int D, int MODE>
__device__ __forceinline__ void rg_form(const RgCall& c, int k, int& pa_row,
                                        const Group& g) {
    int pa, pb;
    for (int i = 0; i < c.Q; ++i) {
        rg_entry<MODE>(c, k, i, pa, pb);
        int* d = g.slot(rg_buf<MODE>(k) + i);
        const int* b = d;
        if (MODE == RG_PAROW) {
            if (pb == 0) continue;
        } else {
            if (pa != pa_row) {
                load_slot<D>(g.slot(RG_PA), c.pa_ext + (uint32_t)pa * c.row,
                             c.sB, g, g.nw);
                pa_row = pa;
            }
            if (MODE == RG_RESIDENT) b = c.slab + pb * c.srow;
        }
        addsub_slots<D>(d, g.slot(RG_PA), b, true, g);
    }
}

// K8: cp.async the block's digits below nw of Pb rows lo .. lo + cap - 1
// (those inside the table) into slab rows 1 .. cap, laid out [row][curve
// of the block][L*D digits] as the slots are, so a lane reads its own
// digits of a row as it reads a slot.  cpb threads take one (row, digit)
// pair, one curve each, so a warp's reads coalesce; a curve past the batch
// takes the last curve's rows.  Every thread of the block calls it.
__device__ __forceinline__ void rr_fill(int* slab, int srow, int LD,
                                        const int* pbx, int lo,
                                        const RgSlabs& sl, int nw,
                                        int curve0, int B) {
    const int cpb = srow / LD;
    const int rows = sl.cap < sl.pb_rows - lo ? sl.cap : sl.pb_rows - lo;
    const int c = threadIdx.x % cpb;
    const int col = curve0 + c < B ? curve0 + c : B - 1;
    const size_t sB = (size_t)B;
#pragma unroll 1
    for (int r = threadIdx.x / cpb; r < rows * nw;
         r += blockDim.x / cpb) {
        const int u = r / nw, j = r - u * nw;
        __pipeline_memcpy_async(
            slab + (u + 1) * srow + c * LD + j,
            pbx + ((size_t)(lo + u) * nw + j) * sB + col, sizeof(int));
    }
    __pipeline_commit();
}

// The kernel body of K6, K7 and K8 for one thread (__global__ wrappers in
// replay_gather.cu and replay_resident.cu; tools/lane_shim runs it on the
// CPU).  m and smem are the block's shared Mod and dynamic shared memory:
// the slots, then (K8) the slab of sl.cap + 1 rows.  one: K7's; sl: K8's.
template <int D, int MODE>
__device__ __forceinline__ void replay_gather_lanes(
    Mod& m, int* smem, const int* __restrict__ acc_in,
    int* __restrict__ acc_out, const int* __restrict__ pa_ext,
    const int* __restrict__ pbx, const int* __restrict__ idx,
    const int* __restrict__ one, int nsteps, int E, TPUECM_MOD_PARAMS,
    int B, int L, RgSlabs sl = RgSlabs{}) {
    constexpr int S = MODE == RG_RESIDENT ? RR_SLOTS : RG_SLOTS;
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D, S>(smem, L, m);
    const int cpb = blockDim.x / L, LD = L * D, srow = cpb * LD;
    const int curve0 = blockIdx.x * cpb;
    const int curve = curve0 + threadIdx.x / L;
    const bool live = curve < B;
    const int col = live ? curve : B - 1;
    const size_t sB = (size_t)B;
    int* const slab = smem + lanes_n_words(L, D)
                      + cpb * lanes_curve_words(L, D, S);
    if (MODE == RG_RESIDENT)    // the zero row, and digits past nw
        for (int i = threadIdx.x; i < (sl.cap + 1) * srow; i += blockDim.x)
            slab[i] = 0;
    const int Q = E < 4 ? E : 4;
    const RgCall c{pa_ext + col, pbx + col,
                   MODE == RG_PAROW ? one + col : one, idx,
                   slab + (threadIdx.x / L) * LD, (size_t)nw * sB, sB, srow,
                   E, Q, E / Q};
    const int passes = E > 1 ? E / 2 : 1;
    const int groups = nsteps * c.G;
    const int total = nsteps * passes + (E > 1 && nsteps > 0);
    load_slot<D>(g.slot(RG_ACC), acc_in + col, sB, g, nw);
    int pa_row = -1, seg = 0;
    if (MODE != RG_RESIDENT) rg_prefetch<D, MODE>(c, 0, groups, g);
#pragma unroll 1
    for (int t = 0, s = 0, p = 0; t < total; ++t) {
        if (MODE == RG_RESIDENT && p == 0 && seg < sl.nseg
            && s == sl.seg[3 * seg + 1]) {
            __syncthreads();    // the last segment's reads are done
            rr_fill(slab, srow, LD, pbx, sl.seg[3 * seg], sl, nw, curve0,
                    B);
            __pipeline_wait_prior(0);
            __syncthreads();
            ++seg;
        }
        const RgPass st = RG_PROG[s < nsteps ? E / 2 + p : RG_LAST];
        const int k0 = s * c.G;         // the step's first leaf group
        if (st.leaf >= 0) {
            if (MODE != RG_RESIDENT) __pipeline_wait_prior(0);
            rg_form<D, MODE>(c, k0 + st.leaf, pa_row, g);
            if (MODE != RG_RESIDENT)
                rg_prefetch<D, MODE>(c, k0 + st.leaf + 1, groups, g);
        }
        const auto at = [&](int code) {
            return g.slot(code < RG_SLOTS
                              ? code
                              : rg_buf<MODE>(k0 + (code - RG_SLOTS) / 4)
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
