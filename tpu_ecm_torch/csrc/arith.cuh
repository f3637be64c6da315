// Montgomery digit arithmetic for one curve per thread: the CUDA twin of
// tpu_ecm/limbs/pallas_ops.py:_make_arith (and of limbs/torch_ops.py, its
// plain version in this package).
//
// A value is nw signed base-2^w digits (int32).  In device memory every
// plane is [NW, B] with the curve axis B last, so digit j of consecutive
// curves sits at consecutive addresses and a warp's row load coalesces.
// Inside a thread a value is a local array of nw digits.  Functions here
// are inline so every .cu that includes the header may define them.
//
// mulmod / sqrmod form the product columns by schoolbook (the Pallas
// schoolbook, Karatsuba and blocked-CIOS schedules give identical digits,
// pallas_ops.py:171-176, 321-328), reduce by digit-serial REDC and finish
// with two lazy carry passes.  The REDC runs column by column (product
// scanning): column c gets its a*b terms, the q_i*n_{c-i} terms of the
// earlier quotient digits and the carry of column c-1, exactly the addends
// the digit-serial loop of jnp_ops._redc gives it, so the digits are the
// same.  All sums are taken in uint32, which wraps like JAX's int32 (signed
// overflow is undefined in C++); the REDC quotient q = col * nprime mod 2^w
// overflows by design.  Right shifts are taken on int32 and are arithmetic.
//
// nw is a run-time value bounded by TPUECM_NW_MAX (set by limbs/build.py),
// so the per-thread arrays live in local memory; making them registers by
// specialising on nw is later work (PERF.md).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef TPUECM_NW_MAX
#error "TPUECM_NW_MAX must be defined by the build (limbs/build.py)"
#endif

#define TPUECM_THREADS 32   // one warp per block: 2048 curves span 64 SMs

// Modulus context of one launch, loaded into shared memory by every block.
struct Mod {
    int nw, w, mask, norm;   // norm: params.ArithParams.norm_inputs
    uint32_t nprime;         // -n^-1 mod 2^w
    int n[TPUECM_NW_MAX];    // digits of n
};

// Call with every thread of the block, before any thread returns.
__device__ __forceinline__ void load_mod(Mod& m, const int* ndig, int nw,
                                         int w, int nprime, int norm) {
    for (int j = threadIdx.x; j < nw; j += blockDim.x) m.n[j] = ndig[j];
    if (threadIdx.x == 0) {
        m.nw = nw;
        m.w = w;
        m.mask = (1 << w) - 1;
        m.norm = norm;
        m.nprime = (uint32_t)nprime;
    }
    __syncthreads();
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

__device__ __forceinline__ void add_digits(int* o, const int* a, const int* b,
                                           int nw) {
    for (int j = 0; j < nw; ++j) o[j] = (int)((uint32_t)a[j] + (uint32_t)b[j]);
}

__device__ __forceinline__ void sub_digits(int* o, const int* a, const int* b,
                                           int nw) {
    for (int j = 0; j < nw; ++j) o[j] = (int)((uint32_t)a[j] - (uint32_t)b[j]);
}

// One lazy pass in place: x_j := (x_j mod 2^w) + (x_{j-1} >> w), the top
// digit kept unsplit (jnp_ops._lazy_pass).  Walking down from the top reads
// every x_{j-1} before it is rewritten.
__device__ inline void lazy_pass(int* x, const Mod& m) {
    const int nw = m.nw;
    for (int j = nw - 1; j >= 1; --j) {
        const int lo = (j == nw - 1) ? x[j] : (x[j] & m.mask);
        x[j] = (int)((uint32_t)lo + (uint32_t)(x[j - 1] >> m.w));
    }
    x[0] &= m.mask;
}

// One lazy pass in norm_inputs mode (pallas_ops norm1 / torch_ops._norm_out).
__device__ __forceinline__ void norm1(int* x, const Mod& m) {
    if (m.norm) lazy_pass(x, m);
}

// Column c of a*b (b == nullptr: of a*a, by the symmetric half product;
// the same integer, hence the same digits).
__device__ __forceinline__ uint32_t col_ab(const int* a, const int* b, int c,
                                           int nw) {
    const int lo = c - nw + 1 > 0 ? c - nw + 1 : 0;
    const int hi = c < nw - 1 ? c : nw - 1;
    uint32_t t = 0;
    if (b != nullptr) {
        for (int i = lo; i <= hi; ++i)
            t += (uint32_t)a[i] * (uint32_t)b[c - i];
        return t;
    }
    for (int i = lo; 2 * i < c; ++i) t += (uint32_t)a[i] * (uint32_t)a[c - i];
    t += t;
    if ((c & 1) == 0 && c / 2 <= hi)
        t += (uint32_t)a[c / 2] * (uint32_t)a[c / 2];
    return t;
}

// out = a*b/R (b == nullptr: a*a/R) on pre-safe operands.  out may alias a
// or b: output digit c-nw is written after column c, and no later column
// reads an operand digit below c-nw+1.
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

// Montgomery product; pre=false applies the norm_inputs entry pass to
// copies of the operands first.
__device__ inline void mulmod(int* out, const int* a, const int* b,
                              const Mod& m, bool pre = true) {
    if (m.norm && !pre) {
        int ta[TPUECM_NW_MAX], tb[TPUECM_NW_MAX];
        copy_digits(ta, a, m.nw);
        copy_digits(tb, b, m.nw);
        lazy_pass(ta, m);
        lazy_pass(tb, m);
        mont_cols(out, ta, tb, m);
        return;
    }
    mont_cols(out, a, b, m);
}

__device__ inline void sqrmod(int* out, const int* a, const Mod& m,
                              bool pre = true) {
    if (m.norm && !pre) {
        int ta[TPUECM_NW_MAX];
        copy_digits(ta, a, m.nw);
        lazy_pass(ta, m);
        mont_cols(out, ta, nullptr, m);
        return;
    }
    mont_cols(out, a, nullptr, m);
}

// Duplicate (pallas_ops._tape_kernel xdbl / curve.ops.xdbl); s = (A+2)/4.
// Outputs must not alias inputs.
__device__ inline void xdbl(int* xo, int* zo, const int* x, const int* z,
                            const int* s, const Mod& m) {
    int sp[TPUECM_NW_MAX], dm[TPUECM_NW_MAX], u[TPUECM_NW_MAX],
        v[TPUECM_NW_MAX];
    const int nw = m.nw;
    add_digits(sp, x, z, nw);
    norm1(sp, m);
    sub_digits(dm, x, z, nw);
    norm1(dm, m);
    sqrmod(v, dm, m);
    sqrmod(u, sp, m);
    mulmod(xo, u, v, m);
    sub_digits(dm, u, v, nw);        // dm := W = U - V
    norm1(dm, m);
    mulmod(sp, dm, s, m);            // sp := s*W
    add_digits(sp, sp, v, nw);
    norm1(sp, m);
    mulmod(zo, sp, dm, m);
}

// Differential add P1 + P2 with difference D (curve.ops.xadd).  Outputs
// must not alias inputs.
__device__ inline void xadd(int* xo, int* zo, const int* x1, const int* z1,
                            const int* x2, const int* z2, const int* xd,
                            const int* zd, const Mod& m) {
    int s1[TPUECM_NW_MAX], d1[TPUECM_NW_MAX], s2[TPUECM_NW_MAX],
        d2[TPUECM_NW_MAX];
    const int nw = m.nw;
    add_digits(s1, x1, z1, nw);
    norm1(s1, m);
    sub_digits(d1, x1, z1, nw);
    norm1(d1, m);
    add_digits(s2, x2, z2, nw);
    norm1(s2, m);
    sub_digits(d2, x2, z2, nw);
    norm1(d2, m);
    mulmod(d1, d1, s2, m);           // d1 := U
    mulmod(s1, s1, d2, m);           // s1 := V
    add_digits(s2, d1, s1, nw);
    norm1(s2, m);
    sub_digits(d2, d1, s1, nw);
    norm1(d2, m);
    sqrmod(s2, s2, m);
    sqrmod(d2, d2, m);
    mulmod(xo, s2, zd, m);
    mulmod(zo, d2, xd, m);
}
