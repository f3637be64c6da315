// K3 and K4, stage 2: the device halves of Montgomery's batch-inversion
// trick over a stack of `count` planes.
//   K3 prefix:        out[i] = one * z[0] * ... * z[i]
//   K4 apply-inverse: out[i] = x[i] * z[i]^-1, walking i from count-1 down
//                     with the running suffix, from pres[i] (the prefix up
//                     to i-1) and total_inv = (z[0]...z[count-1])^-1, which
//                     the host inverts once for the whole batch.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:make_prefix_executor and
// make_apply_inverse_executor, whose sequential grids (the second in
// reverse) carried the running product in VMEM scratch.  The products keep
// their association and operand order (acc*z; suf*pres, x*inv, suf*z), so
// the digits equal limbs/kernels.py:prefix_plain and apply_inverse_plain.
// Every operand is a product's output or a host-packed value, so no
// product takes norm_inputs' entry passes, as in the Pallas kernels.
//
// Bound on the H100: integer multiply-adds, 1 (K3) or 3 (K4) modular
// products per row and curve against 2 (K3) or 4 (K4) nw*4-byte digit rows
// per row and curve read or written once.
//
// Design (csrc/arith_lanes.cuh, as K1, K2, K5 and K9): a group of L lanes
// works on one curve, each lane owning D digits of every value, the
// products' columns in registers; limbs/kernels.py:tape_geometry picks L
// and D.  The blocks' sequential grid becomes a loop over rows inside the
// group, the running product in a shared-memory slot for the whole launch.
//  * K3 has one dependent product a row, acc*z[i], with no partner in the
//    same curve: a product step of that one product (faster on the H100
//    than a pair beside a spent partner, PERF.md).  The next z row is
//    cp.async'd into the other of two z slots while the row's product runs.
//  * K4's three products a row, inv = suf*pres[i], out = x[i]*inv and
//    suf = suf*z[i], form one stream walked in pairs: (inv_i, suf*z_i),
//    (out_i, inv_{i-1}), (suf*z_{i-1}, out_{i-1}), two rows in three paired
//    steps, no spent product but the last step's at an odd count.  No step
//    pairs a product with one it depends on.  suf and inv have one slot
//    each: a step that reads inv (out_i) and writes it (inv_{i-1}), or
//    reads and writes suf, is safe, since mul_slots reads every operand
//    before any lane writes.  Row k of the walk (i = count-1-k) has its
//    three planes in slot set k % 3, out over x; the next row's planes are
//    cp.async'd into the third set when a row begins, by which time the
//    set's previous row is stored.
// One call site of the product per kernel.  A lane past the batch computes
// on the last curve and stores nothing, so every lane reaches every
// shuffle and barrier.
#include "arith_lanes.cuh"

// K3's values in the lane core's slots: acc and two z slots (row i in
// K3_Z + i % 2).
enum { K3_ACC = SLOT_X, K3_Z = SLOT_X2 };

// K4's values: the running suffix, the current inverse, and three sets of
// a row's planes (pres, x, z; set j at K4_SET + 3*j).
enum { K4_SUF = SLOT_X, K4_INV = SLOT_Z, K4_SET = SLOT_X2 };
enum { K4_PRES, K4_XS, K4_ZS };

// The K3 kernel body for one thread (a __global__ wrapper below; tools/
// lane_shim runs it on the CPU).  m and smem are the block's shared Mod
// and dynamic shared memory.
template <int D>
__device__ __forceinline__ void prefix_lanes(
    Mod& m, int* smem, const int* __restrict__ zs,
    const int* __restrict__ one, int* __restrict__ out, int count,
    TPUECM_MOD_PARAMS, int B, int L) {
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D>(smem, L, m);
    const int curve = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
    const bool live = curve < B;
    const int col = live ? curve : B - 1;
    const size_t sB = (size_t)B;
    const size_t row = (size_t)nw * sB;
    zs += col;
    out += col;
    load_slot<D>(g.slot(K3_ACC), one + col, sB, g, nw);
    copy_slot_async<D>(g.slot(K3_Z), zs, sB, g);
    __pipeline_commit();
#pragma unroll 1
    for (int i = 0; i < count; ++i) {
        __pipeline_wait_prior(0);
        if (i + 1 < count)
            copy_slot_async<D>(g.slot(K3_Z + ((i + 1) & 1)),
                               zs + (i + 1) * row, sB, g);
        __pipeline_commit();
        int* const dst[1] = {g.slot(K3_ACC)};
        const int* const a[1] = {g.slot(K3_ACC)};
        const int* const b[1] = {g.slot(K3_Z + (i & 1))};
        mul_slots<D, 1>(dst, a, b, g);
        if (live) store_slot<D>(out + i * row, g.slot(K3_ACC), sB, g, nw);
    }
}

// cp.async row k of K4's walk (i = count-1-k: pres, x, z) into its slot
// set, as one group; past the last row, an empty group.
template <int D>
__device__ __forceinline__ void copy_row(int k, int count,
                                         const int* xs, const int* zs,
                                         const int* pres, size_t row,
                                         size_t sB, const Group& g) {
    if (k < count) {
        const size_t at = (size_t)(count - 1 - k) * row;
        const int set = K4_SET + 3 * (k % 3);
        copy_slot_async<D>(g.slot(set + K4_PRES), pres + at, sB, g);
        copy_slot_async<D>(g.slot(set + K4_XS), xs + at, sB, g);
        copy_slot_async<D>(g.slot(set + K4_ZS), zs + at, sB, g);
    }
    __pipeline_commit();
}

// The K4 kernel body for one thread, as prefix_lanes.  Product p of the
// stream (p < 3*count) is kind p % 3 of row k = p / 3: 0 inv = suf*pres,
// 1 suf = suf*z, 2 out = x*inv over x, stored after its step.  At an odd
// count the last step's partner is spent on suf, which is dead by then.
template <int D>
__device__ __forceinline__ void apply_inverse_lanes(
    Mod& m, int* smem, const int* __restrict__ xs,
    const int* __restrict__ zs, const int* __restrict__ pres,
    const int* __restrict__ total_inv, int* __restrict__ out, int count,
    TPUECM_MOD_PARAMS, int B, int L) {
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D>(smem, L, m);
    const int curve = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
    const bool live = curve < B;
    const int col = live ? curve : B - 1;
    const size_t sB = (size_t)B;
    const size_t row = (size_t)nw * sB;
    xs += col;
    zs += col;
    pres += col;
    out += col;
    load_slot<D>(g.slot(K4_SUF), total_inv + col, sB, g, nw);
    copy_row<D>(0, count, xs, zs, pres, row, sB, g);
    const int products = 3 * count;
#pragma unroll 1
    for (int p0 = 0; p0 < products; p0 += TPUECM_PAIR) {
        int* dst[TPUECM_PAIR];
        const int* a[TPUECM_PAIR];
        const int* b[TPUECM_PAIR];
#pragma unroll
        for (int h = 0; h < TPUECM_PAIR; ++h) {
            const int p = p0 + h, k = p / 3;
            const int set = K4_SET + 3 * (k % 3);
            int d = K4_SUF, x = K4_SUF, y = K4_SUF;
            if (p < products) {
                const int kind = p % 3;
                if (kind == 0) {            // row k begins: its planes
                    __pipeline_wait_prior(0);
                    copy_row<D>(k + 1, count, xs, zs, pres, row, sB, g);
                    d = K4_INV, y = set + K4_PRES;
                } else if (kind == 1) {
                    y = set + K4_ZS;
                } else {
                    d = x = set + K4_XS, y = K4_INV;
                }
            }
            dst[h] = g.slot(d);
            a[h] = g.slot(x);
            b[h] = g.slot(y);
        }
        mul_slots<D, TPUECM_PAIR>(dst, a, b, g);
#pragma unroll
        for (int h = 0; h < TPUECM_PAIR; ++h) {
            const int p = p0 + h, k = p / 3;
            if (live && p < products && p % 3 == 2)
                store_slot<D>(out + (size_t)(count - 1 - k) * row, dst[h],
                              sB, g, nw);
        }
    }
}

#ifdef __CUDACC__
template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
prefix_lanes_kernel(const int* __restrict__ zs, const int* __restrict__ one,
                    int* __restrict__ out, int count, TPUECM_MOD_PARAMS,
                    int B, int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    prefix_lanes<D>(m, smem, zs, one, out, count, TPUECM_MOD_ARGS, B, L);
}

template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
apply_inverse_lanes_kernel(const int* __restrict__ xs,
                           const int* __restrict__ zs,
                           const int* __restrict__ pres,
                           const int* __restrict__ total_inv,
                           int* __restrict__ out, int count,
                           TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    apply_inverse_lanes<D>(m, smem, xs, zs, pres, total_inv, out, count,
                           TPUECM_MOD_ARGS, B, L);
}

extern "C" int tpuecm_prefix(const int* zs, const int* one, int* out,
                             int count, TPUECM_MOD_PARAMS, int B, int lanes,
                             int digits, void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits) || count < 1)
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes<D>(prefix_lanes_kernel<D>, lanes, B,
                               (cudaStream_t)stream, zs, one, out, count,
                               TPUECM_MOD_ARGS, B, lanes);
    });
}

extern "C" int tpuecm_apply_inverse(const int* xs, const int* zs,
                                    const int* pres, const int* total_inv,
                                    int* out, int count, TPUECM_MOD_PARAMS,
                                    int B, int lanes, int digits,
                                    void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits) || count < 1)
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes<D>(apply_inverse_lanes_kernel<D>, lanes, B,
                               (cudaStream_t)stream, xs, zs, pres, total_inv,
                               out, count, TPUECM_MOD_ARGS, B, lanes);
    });
}

TPUECM_LANES_OCCUPANCY(tpuecm_prefix_occupancy, prefix_lanes_kernel)
TPUECM_LANES_OCCUPANCY(tpuecm_apply_inverse_occupancy,
                       apply_inverse_lanes_kernel)
#endif
