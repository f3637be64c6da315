// Modular digit arithmetic for one curve per thread (the resident-slab
// replay K8): the CUDA twin of tpu_ecm/limbs/pallas_ops.py:_make_arith
// (and of limbs/torch_ops.py, its plain version in this package).  Its
// Mod, load_mod and mod_args_ok also serve the lane core arith_lanes.cuh.
//
// A value is nw signed base-2^w digits (int32).  In device memory every
// plane is [NW, B] with the curve axis B last, so digit j of consecutive
// curves sits at consecutive addresses and a warp's row load coalesces.
// Inside a thread a value is a local array of nw digits.  Functions here
// are inline so every .cu that includes the header may define them.
//
// mulmod forms the product columns by schoolbook (the Pallas
// schoolbook, Karatsuba and blocked-CIOS schedules give identical digits,
// pallas_ops.py:171-176, 321-328) and reduces them in one of two modes, one
// build serving both (Mod.e selects at run time):
//
//  * REDC (e == 0), a generic odd n: digit-serial Montgomery reduction, then
//    two lazy carry passes.  It runs column by column (product scanning):
//    column c gets its a*b terms, the q_i*n_{c-i} terms of the earlier
//    quotient digits and the carry of column c-1, exactly the addends the
//    digit-serial loop of jnp_ops._redc gives it, so the digits are the same.
//    The REDC quotient q = col * nprime mod 2^w overflows by design.
//  * fold (e > 0), a special form M = 2^e - c (pallas_ops.py:271-308,
//    jnp_ops._mersenne_reduce): all 2*nw product columns are held in the
//    thread, then three rounds of two lazy passes and one fold
//    lo + sign*|c|*(t >> e), the last fold into nw digits, then two lazy
//    passes.  The shift by e = k0*w + s is taken per digit with the
//    two's-complement identity x = (x & (2^s-1)) + (x >> s)*2^s.
//
// All sums are taken in uint32, which wraps like JAX's int32 (signed
// overflow is undefined in C++); right shifts are taken on int32 and are
// arithmetic.
//
// nw is a run-time value bounded by TPUECM_NW_MAX, and the digit count of
// |c| by TPUECM_CL_MAX (both set by limbs/build.py), so the per-thread
// arrays live in local memory; making them registers by
// specialising on nw is later work (PERF.md).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#if !defined(TPUECM_NW_MAX) || !defined(TPUECM_CL_MAX)
#error "TPUECM_NW_MAX and TPUECM_CL_MAX must be set by limbs/build.py"
#endif

#define TPUECM_THREADS 32   // one warp per block: 2048 curves span 64 SMs

// Modulus context of one launch, loaded into shared memory by every block.
struct Mod {
    int nw, w, mask, norm;   // norm: params.ArithParams.norm_inputs
    uint32_t nprime;         // REDC: -n^-1 mod 2^w
    int e, k0, s;            // fold: M = 2^e - c, e = k0*w + s (0: REDC)
    int cl, csign;           // fold: digits of |c| and the sign of c
    int c[TPUECM_CL_MAX];    // fold: digits of |c|
    int n[TPUECM_NW_MAX];    // digits of n
};

// The modulus arguments every kernel and entry point takes, in this order
// (limbs/kernels.py:_mod passes them).
#define TPUECM_MOD_PARAMS                                                    \
    const int *__restrict__ ndig, const int *__restrict__ cdig, int cl,     \
        int e, int csign, int nw, int w, int nprime, int norm
#define TPUECM_MOD_ARGS ndig, cdig, cl, e, csign, nw, w, nprime, norm

// Call with every thread of the block, before any thread returns.
__device__ __forceinline__ void load_mod(Mod& m, TPUECM_MOD_PARAMS) {
    for (int j = threadIdx.x; j < nw; j += blockDim.x) m.n[j] = ndig[j];
    for (int j = threadIdx.x; j < cl; j += blockDim.x) m.c[j] = cdig[j];
    if (threadIdx.x == 0) {
        m.nw = nw;
        m.w = w;
        m.mask = (1 << w) - 1;
        m.norm = norm;
        m.nprime = (uint32_t)nprime;
        m.e = e;
        m.k0 = e / w;
        m.s = e % w;
        m.cl = cl;
        m.csign = csign;
    }
    __syncthreads();
}

// The host-side checks of an entry point's arguments.
__host__ inline bool mod_args_ok(int nw, int e, int cl, int w) {
    if (nw < 2 || nw > TPUECM_NW_MAX || w < 1 || w > 13) return false;
    return e == 0 || (cl >= 1 && cl <= TPUECM_CL_MAX && cl <= e / w
                      && e / w < nw);
}

// plane row <-> thread-local digits (stride B between digits)
__device__ __forceinline__ void load_row(int* x, const int* plane, size_t B,
                                         int nw) {
    for (int j = 0; j < nw; ++j) x[j] = plane[(size_t)j * B];
}

__device__ __forceinline__ void store_row(int* plane, const int* x, size_t B,
                                          int nw) {
    for (int j = 0; j < nw; ++j) plane[(size_t)j * B] = x[j];
}

__device__ __forceinline__ void copy_digits(int* o, const int* x, int nw) {
    for (int j = 0; j < nw; ++j) o[j] = x[j];
}

// One lazy pass over `rows` digits in place: x_j := (x_j mod 2^w) +
// (x_{j-1} >> w), the top digit kept unsplit (jnp_ops._lazy_pass).  Walking
// down from the top reads every x_{j-1} before it is rewritten.
__device__ inline void lazy_rows(int* x, int rows, const Mod& m) {
    for (int j = rows - 1; j >= 1; --j) {
        const int lo = (j == rows - 1) ? x[j] : (x[j] & m.mask);
        x[j] = (int)((uint32_t)lo + (uint32_t)(x[j - 1] >> m.w));
    }
    x[0] &= m.mask;
}

__device__ __forceinline__ void lazy_pass(int* x, const Mod& m) {
    lazy_rows(x, m.nw, m);
}

// One lazy pass in norm_inputs mode (pallas_ops norm1 / torch_ops._norm_out).
__device__ __forceinline__ void norm1(int* x, const Mod& m) {
    if (m.norm) lazy_pass(x, m);
}

// Column c of a*b.
__device__ __forceinline__ uint32_t col_ab(const int* a, const int* b, int c,
                                           int nw) {
    const int lo = c - nw + 1 > 0 ? c - nw + 1 : 0;
    const int hi = c < nw - 1 ? c : nw - 1;
    uint32_t t = 0;
    for (int i = lo; i <= hi; ++i) t += (uint32_t)a[i] * (uint32_t)b[c - i];
    return t;
}

// REDC: out = a*b/R on pre-safe operands.  out may
// alias a or b: output digit c-nw is written after column c, and no later
// column reads an operand digit below c-nw+1.
__device__ inline void mont_cols(int* out, const int* a, const int* b,
                                 const Mod& m) {
    int s[TPUECM_NW_MAX];
    const int nw = m.nw;
    uint32_t carry = 0;
    for (int c = 0; c < nw; ++c) {
        uint32_t t = carry + col_ab(a, b, c, nw);
        for (int i = 0; i < c; ++i)
            t += (uint32_t)s[i] * (uint32_t)m.n[c - i];
        const uint32_t q = (t * m.nprime) & (uint32_t)m.mask;
        s[c] = (int)q;
        t += q * (uint32_t)m.n[0];
        carry = (uint32_t)(((int)t) >> m.w);
    }
    for (int c = nw; c < 2 * nw; ++c) {
        uint32_t t = (c == nw ? carry : 0u) + col_ab(a, b, c, nw);
        for (int i = c - nw + 1; i < nw; ++i)
            t += (uint32_t)s[i] * (uint32_t)m.n[c - i];
        out[c - nw] = (int)t;
    }
    lazy_pass(out, m);
    lazy_pass(out, m);
}

// One fold of the lazily normalized columns t[0..rows) mod 2^e - c into
// t[0..out_rows), in place (pallas_ops fold_list / jnp_ops._fold_once):
//   t := lo + sign * |c| * hi,  lo = t mod 2^e,  hi = t >> e,
// hi's digit j being (t[k0+j] >> s) + ((t[k0+j+1] & (2^s-1)) << (w-s)).
// In place is safe: digit i reads t[i] and hi digits j > i - cl, whose
// columns k0+j and k0+j+1 lie above i because cl <= k0.
__device__ inline void fold_rows(int* t, int rows, int out_rows,
                                 const Mod& m) {
    const int k0 = m.k0, s = m.s, hrows = rows - k0;
    const int smask = (1 << s) - 1;
    for (int i = 0; i < out_rows; ++i) {
        uint32_t acc = i < k0 ? (uint32_t)t[i]
                     : (i == k0 ? (uint32_t)(t[k0] & smask) : 0u);
        for (int l = 0; l < m.cl; ++l) {
            const int j = i - l;
            if (j < 0 || j >= hrows) continue;
            const int nxt = k0 + j + 1 < rows
                                ? (t[k0 + j + 1] & smask) << (m.w - s) : 0;
            const uint32_t hi = (uint32_t)(t[k0 + j] >> s) + (uint32_t)nxt;
            const uint32_t prod = (uint32_t)m.c[l] * hi;
            acc = m.csign < 0 ? acc - prod : acc + prod;
        }
        t[i] = (int)acc;
    }
}

// Fold: out = a*b mod 2^e - c on pre-safe operands,
// from all 2*nw product columns held in the thread.  out may alias a or b:
// it is written after every column is formed.
__device__ inline void fold_cols(int* out, const int* a, const int* b,
                                 const Mod& m) {
    int t[2 * TPUECM_NW_MAX];
    const int rows = 2 * m.nw;
    for (int c = 0; c < rows; ++c) t[c] = (int)col_ab(a, b, c, m.nw);
    for (int round = 0; round < 3; ++round) {
        lazy_rows(t, rows, m);
        lazy_rows(t, rows, m);
        fold_rows(t, rows, round < 2 ? rows : m.nw, m);
    }
    lazy_pass(t, m);
    lazy_pass(t, m);
    copy_digits(out, t, m.nw);
}

// Modular product (a*b/R or a*b mod 2^e - c) of pre-safe operands: every
// caller (K8) multiplies products and differences that took
// norm_inputs' pass, so no entry pass is taken here.
__device__ inline void mulmod(int* out, const int* a, const int* b,
                              const Mod& m) {
    if (m.e)
        fold_cols(out, a, b, m);
    else
        mont_cols(out, a, b, m);
}
