// K9, Edwards stage 1: replay an (op, arg) wNAF tape over the a=-1
// twisted-Edwards accumulator [4, NW, B] (X, Y, Z, T), in place, reading the
// cached window table [Tp, 3, NW, B] (Y-X, Y+X, 2dT of the odd multiples,
// Z = 1) on add steps.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:make_edwards_executor
// (_ed_tape_kernel), whose grid-less call kept the accumulator and the
// table in VMEM for an 8192-step chunk.  The formulas are those of
// pallas_ops.py:1349-1377 and curve/edops.py, so the digits are equal:
//   ED_DBL / ED_DBLT  3M+4S, T3 = E*H only for ED_DBLT (+1M)
//   ED_ADD / ED_SUB   cached mixed add 7M; ED_SUB swaps the first two table
//                     planes and negates C (0u - x on every digit)
//   ED_NOP            nothing (the tape length is a run-time value, so no
//                     padding is needed)
// Both reductions of arith.cuh (REDC and the special-form fold) run here.
//
// Bound on the H100: integer multiply-adds.  A doubling is 7-8 dependent
// modular products and an add 7, on one thread per curve, against 4*nw*4
// bytes of accumulator per curve read and written once per launch and
// 3*nw*4 bytes of table per add step (the table, 16 points at w=6, is
// 14 MB at 416 bits and B=2048, so it stays in L2).
//
// Design: every thread walks the same tape entry (a uniform load, no
// divergence); the accumulator lives in local arrays for the whole launch
// (unlike K1's register file it is never re-read between steps), and a
// table row is loaded only on an add step.
#include "arith.cuh"

#define ED_DBL 0
#define ED_DBLT 1
#define ED_ADD 2
#define ED_SUB 3

// acc := 2*acc; T is written only when want_t.  t0..t6 are scratch.
__device__ inline void ed_dbl(int* X, int* Y, int* Z, int* T, bool want_t,
                              int* t0, int* t1, int* t2, int* t3, int* t4,
                              int* t5, int* t6, const Mod& m) {
    const int nw = m.nw;
    sqrmod(t0, X, m);                        // A
    sqrmod(t1, Y, m);                        // B
    sqrmod(t2, Z, m);
    add_digits(t2, t2, t2, nw);              // C = 2 Z^2
    norm1(t2, m);
    add_digits(t3, X, Y, nw);
    norm1(t3, m);
    sqrmod(t3, t3, m);                       // E0 = (X+Y)^2
    sub_digits(t3, t3, t0, nw);
    norm1(t3, m);
    sub_digits(t3, t3, t1, nw);              // E = E0 - A - B
    norm1(t3, m);
    sub_digits(t4, t1, t0, nw);              // G = B - A
    norm1(t4, m);
    sub_digits(t5, t4, t2, nw);              // F = G - C
    norm1(t5, m);
    add_digits(t6, t0, t1, nw);
    norm1(t6, m);
    neg_digits(t6, t6, nw);                  // H = -(A + B)
    mulmod(X, t3, t5, m);                    // X3 = E F
    mulmod(Y, t4, t6, m);                    // Y3 = G H
    mulmod(Z, t5, t4, m);                    // Z3 = F G
    if (want_t) mulmod(T, t3, t6, m);        // T3 = E H
}

// acc := acc + (or -) the cached point k = (k0, k1, k2) at `tab` (planes
// `plane` apart, digits stride B).  T is left as it is.
__device__ inline void ed_add(int* X, int* Y, int* Z, const int* T,
                              const int* tab, size_t plane, size_t sB,
                              bool negate, int* t0, int* t1, int* t2,
                              int* t3, int* t4, int* t5, int* t6,
                              const Mod& m) {
    const int nw = m.nw;
    add_digits(t0, Y, X, nw);                // s1 = Y + X
    norm1(t0, m);
    sub_digits(t1, Y, X, nw);                // d1 = Y - X
    norm1(t1, m);
    load_row(t2, tab + (negate ? plane : 0), sB, nw);
    mulmod(t1, t1, t2, m);                   // A = d1 * ka
    load_row(t2, tab + (negate ? 0 : plane), sB, nw);
    mulmod(t0, t0, t2, m);                   // B = s1 * kb
    load_row(t2, tab + 2 * plane, sB, nw);
    mulmod(t2, T, t2, m);                    // C = T * k2
    if (negate) neg_digits(t2, t2, nw);
    add_digits(t3, Z, Z, nw);                // D = 2 Z
    norm1(t3, m);
    add_digits(t4, t0, t1, nw);              // H = B + A
    norm1(t4, m);
    sub_digits(t5, t0, t1, nw);              // E = B - A
    norm1(t5, m);
    add_digits(t6, t3, t2, nw);              // G = D + C
    norm1(t6, m);
    sub_digits(t0, t3, t2, nw);              // F = D - C
    norm1(t0, m);
    mulmod(X, t5, t0, m);                    // X3 = E F
    mulmod(Y, t6, t4, m);                    // Y3 = G H
    mulmod(Z, t0, t6, m);                    // Z3 = F G
}

__global__ void __launch_bounds__(TPUECM_THREADS)
ed_tape_kernel(const int* __restrict__ tape, long long nsteps,
               int* __restrict__ acc, const int* __restrict__ table,
               TPUECM_MOD_PARAMS, int B) {
    __shared__ Mod m;
    load_mod(m, TPUECM_MOD_ARGS);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const size_t sB = (size_t)B;
    const size_t plane = (size_t)nw * sB;     // one coordinate plane
    int X[TPUECM_NW_MAX], Y[TPUECM_NW_MAX], Z[TPUECM_NW_MAX],
        T[TPUECM_NW_MAX];
    int t0[TPUECM_NW_MAX], t1[TPUECM_NW_MAX], t2[TPUECM_NW_MAX],
        t3[TPUECM_NW_MAX], t4[TPUECM_NW_MAX], t5[TPUECM_NW_MAX],
        t6[TPUECM_NW_MAX];
    int* a = acc + b;
    load_row(X, a, sB, nw);
    load_row(Y, a + plane, sB, nw);
    load_row(Z, a + 2 * plane, sB, nw);
    load_row(T, a + 3 * plane, sB, nw);
    const int* tab_b = table + b;
    for (long long k = 0; k < nsteps; ++k) {
        const int op = tape[2 * k];
        if (op == ED_DBL || op == ED_DBLT) {
            ed_dbl(X, Y, Z, T, op == ED_DBLT, t0, t1, t2, t3, t4, t5, t6, m);
        } else if (op == ED_ADD || op == ED_SUB) {
            const int* tab = tab_b + (size_t)tape[2 * k + 1] * 3 * plane;
            ed_add(X, Y, Z, T, tab, plane, sB, op == ED_SUB, t0, t1, t2, t3,
                   t4, t5, t6, m);
        }                                     // ED_NOP: nothing
    }
    store_row(a, X, sB, nw);
    store_row(a + plane, Y, sB, nw);
    store_row(a + 2 * plane, Z, sB, nw);
    store_row(a + 3 * plane, T, sB, nw);
}

extern "C" int tpuecm_ed_tape(const int* tape, long long nsteps, int* acc,
                              const int* table, TPUECM_MOD_PARAMS, int B,
                              void* stream) {
    if (!mod_args_ok(nw, e, cl, w) || B < 1)
        return (int)cudaErrorInvalidValue;
    const int blocks = (B + TPUECM_THREADS - 1) / TPUECM_THREADS;
    ed_tape_kernel<<<blocks, TPUECM_THREADS, 0, (cudaStream_t)stream>>>(
        tape, nsteps, acc, table, TPUECM_MOD_ARGS, B);
    return (int)cudaGetLastError();
}
