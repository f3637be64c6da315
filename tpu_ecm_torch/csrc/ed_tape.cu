// K9, Edwards stage 1: replay an (op, arg) wNAF tape over the a=-1
// twisted-Edwards accumulator [4, NW, B] (X, Y, Z, T), in place, reading the
// cached window table [Tp, 3, NW, B] (Y-X, Y+X, 2dT of the odd multiples,
// Z = 1) on add steps.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:make_edwards_executor
// (_ed_tape_kernel), whose grid-less call kept the accumulator and the
// table in VMEM for an 8192-step chunk.  The formulas and their lazy
// passes are those of pallas_ops.py:1349-1377 and curve/edops.py, so the
// digits are equal:
//   ED_DBL / ED_DBLT  3M+4S, T3 = E*H only for ED_DBLT (+1M)
//   ED_ADD / ED_SUB   cached mixed add 6M (A, B, C, X3, Y3, Z3; T is not
//                     written); ED_SUB swaps the first two table planes and
//                     negates C (0u - x on every digit, no lazy pass)
//   ED_NOP            nothing (the tape length is a run-time value, so no
//                     padding is needed)
// Both reductions (REDC and the special-form fold) run here.
//
// Bound on the H100: integer multiply-adds.  A doubling is 7-8 modular
// products and an add 6, against 4*nw*4 bytes of accumulator per curve
// read and written once per launch and 3*nw*4 bytes of table per add step
// (the table, 16 points at w=6, is 14 MB at 416 bits and B=2048, so it
// stays in L2).
//
// Design (csrc/arith_lanes.cuh, as K1 and K5): a group of L lanes works on
// one curve, each lane owning D digits of every value, the products'
// columns in registers; limbs/kernels.py:tape_geometry picks L and D.  X,
// Y, Z and T sit in four of the curve's shared-memory slots for the whole
// launch, loaded once and stored once.  Each op is a program of steps
// (run_steps): four paired product steps for every op, the sums,
// differences and negations between them.  A doubling pairs (X^2, Y^2),
// (Z^2, (X+Y)^2), (E*F, G*H) and (F*G, E*H), E*H into T for ED_DBLT and
// into a dead slot for ED_DBL; an add pairs (A, B), (C, a spent product),
// (X3, Y3) and (Z3, a spent product).  An add step first loads its three
// table rows into the k slots (ED_SUB with the first two swapped); the
// doublings use those slots as temporaries.  Every thread walks the same
// tape entry (a uniform load, no divergence), and the kernel has one call
// site of the product.  A lane past the batch computes on the last curve
// and stores nothing, so every lane reaches every shuffle and barrier.
#include "arith_lanes.cuh"

#define ED_DBL 0
#define ED_DBLT 1
#define ED_ADD 2
#define ED_SUB 3

// K9's values in the lane core's slots: the accumulator (four consecutive
// slots), the table row of an add (k_a, k_b, k2) and four temporaries.
enum {
    K9_X = SLOT_X, K9_Y = SLOT_Z, K9_Z = SLOT_X2, K9_T = SLOT_Z2,
    K9_K0 = SLOT_XD, K9_K1 = SLOT_ZD, K9_K2 = SLOT_S,
    K9_T0 = SLOT_T0, K9_T1 = SLOT_T1, K9_T2 = SLOT_T2, K9_T3 = SLOT_T3
};
#define K9_STEP(kind, d, a, b) TPUECM_PACK(kind, K9_##d, K9_##a, K9_##b)
#define K9_MUL2(d, a, b, d2, a2, b2) \
    TPUECM_PACK2(K9_##d, K9_##a, K9_##b, K9_##d2, K9_##a2, K9_##b2)

// Doubling (edops.edbl): A = X^2 (T0), B = Y^2 (T1), C1 = Z^2 (T3),
// E0 = (X+Y)^2 (T2); C = C1 + C1, E = (E0 - A) - B, G = B - A (K0),
// F = G - C (K1), H = -(A + B) (K2); X3 = E*F, Y3 = G*H, Z3 = F*G, and
// E*H into t3: T for ED_DBLT, the spent A for ED_DBL.
#define K9_DBL_PROG(t3)                                                      \
    K9_STEP(STEP_ADD, T2, X, Y),                                             \
    K9_MUL2(T0, X, X, T1, Y, Y),                                             \
    K9_MUL2(T3, Z, Z, T2, T2, T2),                                           \
    K9_STEP(STEP_ADD, T3, T3, T3),                                           \
    K9_STEP(STEP_SUB, T2, T2, T0),                                           \
    K9_STEP(STEP_SUB, T2, T2, T1),                                           \
    K9_STEP(STEP_SUB, K0, T1, T0),                                           \
    K9_STEP(STEP_SUB, K1, K0, T3),                                           \
    K9_STEP(STEP_ADD, K2, T0, T1),                                           \
    K9_STEP(STEP_NEG, K2, K2, K2),                                           \
    K9_MUL2(X, T2, K1, Y, K0, K2),                                           \
    K9_MUL2(Z, K1, K0, t3, T2, K2)

// Cached mixed add (edops.eadd) of the row in (K0, K1, K2): s1 = Y + X
// (T0), d1 = Y - X (T1); A = d1*k_a (T1), B = s1*k_b (T0); C = T*k2 (T2)
// beside a spent product; for ED_SUB C = -C; D = Z + Z (T3), H = B + A
// (K0), E = B - A (K1), G = D + C (T0), F = D - C (T1); X3 = E*F,
// Y3 = G*H; Z3 = F*G beside a spent product into the spent k2.
#define K9_ADD_HEAD                                                          \
    K9_STEP(STEP_ADD, T0, Y, X),                                             \
    K9_STEP(STEP_SUB, T1, Y, X),                                             \
    K9_MUL2(T1, T1, K0, T0, T0, K1),                                         \
    K9_MUL2(T2, T, K2, T3, T, K2)
#define K9_ADD_TAIL                                                          \
    K9_STEP(STEP_ADD, T3, Z, Z),                                             \
    K9_STEP(STEP_ADD, K0, T0, T1),                                           \
    K9_STEP(STEP_SUB, K1, T0, T1),                                           \
    K9_STEP(STEP_ADD, T0, T3, T2),                                           \
    K9_STEP(STEP_SUB, T1, T3, T2),                                           \
    K9_MUL2(X, K1, T1, Y, T0, K0),                                           \
    K9_MUL2(Z, T1, T0, K2, T1, T0)

__device__ const int K9_DBL[] = {K9_DBL_PROG(T0)};
__device__ const int K9_DBLT[] = {K9_DBL_PROG(T)};
__device__ const int K9_ADD[] = {K9_ADD_HEAD, K9_ADD_TAIL};
__device__ const int K9_SUB[] = {K9_ADD_HEAD, K9_STEP(STEP_NEG, T2, T2, T2),
                                 K9_ADD_TAIL};
#define K9_DBL_STEPS 12
#define K9_ADD_STEPS 11

// The kernel body for one thread (a __global__ wrapper below; tools/
// lane_shim runs it on the CPU).  m and smem are the block's shared Mod
// and dynamic shared memory.
template <int D>
__device__ __forceinline__ void ed_tape_lanes(
    Mod& m, int* smem, const int* __restrict__ tape, long long nsteps,
    int* __restrict__ acc, const int* __restrict__ table, TPUECM_MOD_PARAMS,
    int B, int L) {
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D>(smem, L, m);
    const int curve = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
    const bool live = curve < B;
    const int col = live ? curve : B - 1;
    const size_t sB = (size_t)B;
    const size_t plane = (size_t)nw * sB;     // one coordinate plane
    int* a = acc + col;
    const int* tab_c = table + col;
    for (int i = 0; i < 4; ++i)
        load_slot<D>(g.slot(K9_X + i), a + i * plane, sB, g, nw);
#pragma unroll 1
    for (long long k = 0; k < nsteps; ++k) {
        const int op = tape[2 * k];
        const bool add = op == ED_ADD || op == ED_SUB;
        if (add) {
            const int* tab = tab_c + (size_t)tape[2 * k + 1] * 3 * plane;
            const size_t ka = op == ED_SUB ? plane : 0;
            load_slot<D>(g.slot(K9_K0), tab + ka, sB, g, nw);
            load_slot<D>(g.slot(K9_K1), tab + (plane - ka), sB, g, nw);
            load_slot<D>(g.slot(K9_K2), tab + 2 * plane, sB, g, nw);
        }
        // one call site, so the kernel holds one copy of the product;
        // ED_NOP runs no step
        run_steps<D, true>(
            op == ED_DBL ? K9_DBL
                         : (op == ED_DBLT ? K9_DBLT
                                          : (op == ED_ADD ? K9_ADD : K9_SUB)),
            op == ED_DBL || op == ED_DBLT
                ? K9_DBL_STEPS
                : (add ? K9_ADD_STEPS + (op == ED_SUB) : 0),
            g);
    }
    if (live)
        for (int i = 0; i < 4; ++i)
            store_slot<D>(a + i * plane, g.slot(K9_X + i), sB, g, nw);
}

#ifdef __CUDACC__
template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
ed_tape_lanes_kernel(const int* __restrict__ tape, long long nsteps,
                     int* __restrict__ acc, const int* __restrict__ table,
                     TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    ed_tape_lanes<D>(m, smem, tape, nsteps, acc, table, TPUECM_MOD_ARGS, B,
                     L);
}

extern "C" int tpuecm_ed_tape(const int* tape, long long nsteps, int* acc,
                              const int* table, TPUECM_MOD_PARAMS, int B,
                              int lanes, int digits, void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits))
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes<D>(ed_tape_lanes_kernel<D>, lanes, B,
                               (cudaStream_t)stream, tape, nsteps, acc, table,
                               TPUECM_MOD_ARGS, B, lanes);
    });
}

TPUECM_LANES_OCCUPANCY(tpuecm_ed_tape_occupancy, ed_tape_lanes_kernel)
#endif
