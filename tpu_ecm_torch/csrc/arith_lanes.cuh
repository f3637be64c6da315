// Modular digit arithmetic with several lanes per curve, the one core of
// every digit kernel (K1-K9): the CUDA twin of
// tpu_ecm/limbs/pallas_ops.py:_make_arith, giving the same digits as
// limbs/torch_ops.py, its plain version.  Mod, load_mod and the modulus
// arguments come from arith.cuh.
//
// A value is nw signed base-2^w digits (int32).  In device memory every
// plane is [NW, B] with the curve axis B last, so digit j of consecutive
// curves sits at consecutive addresses.  All sums are taken in uint32,
// which wraps like JAX's int32 (signed overflow is undefined in C++);
// right shifts are taken on int32 and are arithmetic.
//
// A group of L lanes (a power of two, 4 to 32, inside one warp) works on
// one curve.  A curve's values live in slots of shared memory (struct
// Group), digit i at slot[i], with L zeros on each side; lane l owns digits
// l*D .. l*D+D-1 of every slot and is the only lane that writes them.  D,
// the digits a lane owns, is a template parameter, so every loop over it
// unrolls and no array is indexed at run time: a product's columns and
// digits are registers, and nothing lives in local memory.  Digits at and
// above nw are zero in every slot.  A point operation is a program of
// steps on the slots (TPUECM_DUP, TPUECM_ADD, run by run_steps), so a
// kernel holds one copy of the product.
//
// A product step forms TPUECM_PAIR independent products a*b together:
//  * lane l forms the columns c = l + k*L, k < 2D (cyclic ownership, so
//    every lane has the same number of terms), reading a's digits as
//    broadcasts and b's beside the slot's zero pads, so no term needs a
//    bounds test; the columns then go through sT to two halves of rows,
//    lo (rows l*D+j) and hi (rows L*D+l*D+j);
//  * REDC (Mod.e == 0): the quotient chain runs in blocks of D columns.
//    Lane o broadcasts its D low columns, complete with every earlier
//    quotient (D shuffles); every lane forms the block's quotients
//    q = t*nprime mod 2^w (which overflows by design) and the carries
//    (int)(t + q*n0) >> w from them, and adds q*n into its own rows from a
//    window of n loaded ahead.  Rows nw..2nw-1 then go through sT to the
//    lanes that own the result's digits, and two lazy passes follow, each
//    needing the digit below, one shuffle from the lane below;
//  * fold (Mod.e > 0, M = 2^e - c): three rounds of two lazy passes and
//    one fold lo + sign*|c|*(t >> e) on the rows, each fold reading the
//    high digits at offset k0 = e/w from sT, the last into nw rows, then
//    two lazy passes.
//
// Why the digits equal the plain version's (torch_ops.mulmod, after
// jnp_ops' digit-serial REDC and fold): every column is its exact integer
// sum mod 2^32, because the sums are taken in uint32 and wrap.  The
// quotient, the carry, the lazy passes and the fold read only that value,
// so any split of a column's addends across lanes, and any order, gives the
// same digits.
//
// Every lane of a warp runs every shuffle (full mask) and every
// __syncwarp: loops have the same trip counts on all lanes, and a lane
// whose curve lies past the batch computes on a clamped curve and stores
// nothing (the caller's rule).
#pragma once

#include <cuda_pipeline_primitives.h>

#include <type_traits>

#include "arith.cuh"

#define TPUECM_TAPE_BLOCK 128   // threads a block: 4 warps
#define TPUECM_FULL 0xffffffffu
// A product step forms TPUECM_PAIR independent products together, so that
// the latency of one (the quotient chain's shuffles, the lazy passes, the
// fold's reads) hides behind the other's work.
#define TPUECM_PAIR 2

// The slots of a curve's values in shared memory: a tape step's inputs,
// s = (A+2)/4 and four temporaries.  DUP and ADD write their result over
// X, Z.
enum {
    SLOT_X, SLOT_Z, SLOT_X2, SLOT_Z2, SLOT_XD, SLOT_ZD, SLOT_S,
    SLOT_T0, SLOT_T1, SLOT_T2, SLOT_T3, TPUECM_SLOTS
};

// Shared-memory words of the block's padded n (L zeros, n, zeros to
// L + 2*L*D), rounded to whole 32-word rows.
__host__ __device__ inline int lanes_n_words(int L, int D) {
    return (L + 2 * L * D + 31) / 32 * 32;
}

// Shared-memory words of one slot: L zeros, L*D digits, L zeros.
__host__ __device__ inline int lanes_slot_words(int L, int D) {
    return L * D + 2 * L;
}

// Shared-memory words of one curve (its S slots, then the columns sT of
// 2*L*D words for each of a step's TPUECM_PAIR products), padded so that a
// curve's buffers start L banks after the previous curve's: the groups of
// a warp then read distinct banks.  S is TPUECM_SLOTS but for kernels that
// hold more values (K6-K8: csrc/replay_passes.cuh).
__host__ __device__ inline int lanes_curve_words(int L, int D,
                                                 int S = TPUECM_SLOTS) {
    const int words = S * lanes_slot_words(L, D) + TPUECM_PAIR * 2 * L * D;
    return words + ((L - words % 32) % 32 + 32) % 32;
}

__host__ inline size_t lanes_smem_bytes(int L, int D, int S = TPUECM_SLOTS) {
    return sizeof(int) * (size_t)(lanes_n_words(L, D)
                                  + (TPUECM_TAPE_BLOCK / L)
                                        * lanes_curve_words(L, D, S));
}

// The lanes per curve a launch accepts: a power of two from 4 to 32.
__host__ inline bool lanes_ok(int L) {
    return L == 4 || L == 8 || L == 16 || L == 32;
}

// X(D) for each digit count a lane that the lane-core kernels are
// instantiated for, D = 2..8 (limbs/kernels.py:TAPE_DIGITS).
#define TPUECM_LANE_DIGITS(X) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

// f(std::integral_constant<int, D>()) for D = digits, one of
// TPUECM_LANE_DIGITS, else cudaErrorInvalidValue: the one dispatch over D
// of every lane-core launcher and occupancy entry point.
template <typename F>
__host__ inline int with_lane_digits(int digits, F&& f) {
    switch (digits) {
#define TPUECM_CASE(d)                                                       \
    case d:                                                                  \
        return f(std::integral_constant<int, d>());
        TPUECM_LANE_DIGITS(TPUECM_CASE)
#undef TPUECM_CASE
    }
    return (int)cudaErrorInvalidValue;
}

// The checks every lane-core launcher makes: the modulus' arguments, a
// batch, and L lanes of D digits that cover nw.
__host__ inline bool lanes_args_ok(int nw, int e, int cl, int w, int B,
                                   int L, int D) {
    return mod_args_ok(nw, e, cl, w) && B >= 1 && lanes_ok(L) && L * D >= nw;
}

// One lane's view of its curve: its index in the group, the curve's
// buffers, and the modulus' scalars copied into registers (read from the
// shared Mod, they would be loaded again after every shuffle and barrier,
// on the quotient chain's critical path).
struct Group {
    int L, l, LD;      // lanes per curve, this lane, L*D
    int* V;            // digit 0 of slot 0; slot i at V + i*SS
    int SS;            // words a slot
    int* sT;           // product columns [2][2*L*D]
    const int* nP;     // n's digits after L zeros, zeros to L + 2*L*D
    const int* c;      // fold: digits of |c| (shared)
    int nw, w, mask, norm, e;
    uint32_t nprime, n0;        // REDC
    int k0, s, smask, cl, csign;  // fold
    __device__ __forceinline__ int* slot(int i) const { return V + i * SS; }
};

// Sets up the block's padded n and this lane's group of S slots, its
// buffers zeroed (a slot's pads stay zero, and so do its digits at and
// above nw); call with every thread of the block after load_mod (it ends
// in __syncthreads).
template <int D, int S = TPUECM_SLOTS>
__device__ __forceinline__ Group make_group(int* smem, int L, const Mod& m) {
    const int LD = L * D, nlen = L + 2 * LD;
    for (int i = threadIdx.x; i < nlen; i += blockDim.x)
        smem[i] = (i >= L && i - L < m.nw) ? m.n[i - L] : 0;
    Group g;
    g.L = L;
    g.l = threadIdx.x & (L - 1);
    g.LD = LD;
    g.SS = lanes_slot_words(L, D);
    int* curve = smem + lanes_n_words(L, D)
                 + (threadIdx.x / L) * lanes_curve_words(L, D, S);
    for (int i = g.l; i < S * g.SS; i += L) curve[i] = 0;
    g.V = curve + L;
    g.sT = curve + S * g.SS;
    g.nP = smem;
    g.c = m.c;
    g.nw = m.nw;
    g.w = m.w;
    g.mask = m.mask;
    g.norm = m.norm;
    g.e = m.e;
    g.nprime = m.nprime;
    g.n0 = (uint32_t)m.n[0];
    g.k0 = m.k0;
    g.s = m.s;
    g.smask = (1 << m.s) - 1;
    g.cl = m.cl;
    g.csign = m.csign;
    __syncthreads();
    return g;
}

// A value's digit plane [NW, B] (curve column already applied) <-> this
// lane's digits of a slot; digits at and above nw read as zero and are not
// stored.
template <int D>
__device__ __forceinline__ void load_slot(int* slot, const int* plane,
                                          size_t B, const Group& g, int nw) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const int row = g.l * D + j;
        slot[row] = row < nw ? plane[(size_t)row * B] : 0;
    }
}

// cp.async this lane's digits of a plane [NW, B] (curve column applied)
// into a slot, into the caller's open group; its digits at and above nw
// stay as they are (zero).
template <int D>
__device__ __forceinline__ void copy_slot_async(int* slot, const int* plane,
                                                size_t B, const Group& g) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const int row = g.l * D + j;
        if (row < g.nw)
            __pipeline_memcpy_async(slot + row, plane + (size_t)row * B,
                                    sizeof(int));
    }
}

template <int D>
__device__ __forceinline__ void store_slot(int* plane, const int* slot,
                                           size_t B, const Group& g, int nw) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const int row = g.l * D + j;
        if (row < nw) plane[(size_t)row * B] = slot[row];
    }
}

// One lazy-pass step on the row `row` holding x with `below` the old
// value of the row under it: (x mod 2^w) + (below >> w), the top row
// (rows - 1) kept unsplit, rows at and above `rows` kept zero.
__device__ __forceinline__ int lazy_digit(int x, int below, int row,
                                          int rows, const Group& g) {
    const int lo = row == rows - 1 ? x : (x & g.mask);
    return row < rows ? (int)((uint32_t)lo + (uint32_t)(below >> g.w)) : 0;
}

// One lazy pass over `rows` digits in the block layout: x_j := (x_j mod
// 2^w) + (x_{j-1} >> w), the top digit kept unsplit (jnp_ops._lazy_pass).
// The digit below a lane's first is the top digit of the lane below, one
// shuffle.  Every new digit is formed from the old ones, in an
// ascending loop the compiler unrolls.
template <int D>
__device__ __forceinline__ void lazy_lanes(int* x, int rows, const Group& g) {
    const int prev = __shfl_sync(TPUECM_FULL, x[D - 1],
                                 (g.l + g.L - 1) & (g.L - 1), g.L);
    int y[D];
#pragma unroll
    for (int j = 0; j < D; ++j)
        y[j] = lazy_digit(x[j], j > 0 ? x[j > 0 ? j - 1 : 0]
                                      : (g.l ? prev : 0),
                          g.l * D + j, rows, g);
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = y[j];
}

// One lazy pass over `rows` rows held as two block-layout halves: lo[j]
// is row l*D+j, hi[j] row L*D+l*D+j.  Lane 0's first hi row sits on top of
// lane L-1's last lo row.
template <int D>
__device__ __forceinline__ void lazy2_lanes(int* lo, int* hi, int rows,
                                            const Group& g) {
    const int src = (g.l + g.L - 1) & (g.L - 1);
    const int plo = __shfl_sync(TPUECM_FULL, lo[D - 1], src, g.L);
    const int phi = __shfl_sync(TPUECM_FULL, hi[D - 1], src, g.L);
    int ylo[D], yhi[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
        ylo[j] = lazy_digit(lo[j], j > 0 ? lo[j > 0 ? j - 1 : 0]
                                         : (g.l ? plo : 0),
                            g.l * D + j, rows, g);
        yhi[j] = lazy_digit(hi[j], j > 0 ? hi[j > 0 ? j - 1 : 0]
                                         : (g.l ? phi : plo),
                            g.LD + g.l * D + j, rows, g);
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
        lo[j] = ylo[j];
        hi[j] = yhi[j];
    }
}

// dst = a + b or a - b on this lane's digits, then norm_inputs mode's
// lazy pass (pallas_ops norm1, torch_ops._norm_out).  Each lane reads and writes only its own
// digits, so dst may be a or b.
template <int D>
__device__ __forceinline__ void addsub_slots(int* dst, const int* a,
                                             const int* b, bool sub,
                                             const Group& g) {
    int x[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const uint32_t u = (uint32_t)a[g.l * D + j];
        const uint32_t v = (uint32_t)b[g.l * D + j];
        x[j] = (int)(sub ? u - v : u + v);
    }
    if (g.norm) lazy_lanes<D>(x, g.nw, g);
#pragma unroll
    for (int j = 0; j < D; ++j) dst[g.l * D + j] = x[j];
}

// dst = -a on this lane's digits (0u - x: the Edwards formulas' H = -(A+B)
// and C = -C), with no lazy pass after it; dst may be a.
template <int D>
__device__ __forceinline__ void neg_slots(int* dst, const int* a,
                                          const Group& g) {
#pragma unroll
    for (int j = 0; j < D; ++j)
        dst[g.l * D + j] = (int)(0u - (uint32_t)a[g.l * D + j]);
}

// The columns c = l + k*L (k < 2D) of a[p] * b[p] (slots): for each r < L
// and i, q <= D, a[i*L + r] (a broadcast within the group) times
// b[l - r + q*L] lands in column (i + q)*L + l.  b's index runs from
// -(L-1) to L*D+L-1, inside its slot's zero pads, so no term needs a test.
template <int D, int P>
__device__ __forceinline__ void ab_cols(uint32_t (&col)[P][2 * D],
                                        const int* const (&a)[P],
                                        const int* const (&b)[P],
                                        const Group& g) {
    const int L = g.L;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
        for (int k = 0; k < 2 * D; ++k) col[p][k] = 0;
    for (int r = 0; r < L; ++r) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
            int av[D], bv[D + 1];
            const int* bb = b[p] + g.l - r;
#pragma unroll
            for (int i = 0; i < D; ++i) av[i] = a[p][i * L + r];
#pragma unroll
            for (int q = 0; q <= D; ++q) bv[q] = bb[q * L];
#pragma unroll
            for (int i = 0; i < D; ++i)
#pragma unroll
                for (int q = 0; q <= D; ++q)
                    col[p][i + q] += (uint32_t)av[i] * (uint32_t)bv[q];
        }
    }
}

// Cyclic columns through sT to two halves: lo[j] row l*D+j, hi[j] row
// L*D+l*D+j.  Product p of a step's pair uses sT + p * 2*L*D.
template <int D>
__device__ __forceinline__ void cols_to_rows(uint32_t* lo, uint32_t* hi,
                                             const uint32_t* col, int* sT,
                                             const Group& g) {
#pragma unroll
    for (int k = 0; k < 2 * D; ++k) sT[g.l + k * g.L] = (int)col[k];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D; ++j) {
        lo[j] = (uint32_t)sT[g.l * D + j];
        hi[j] = (uint32_t)sT[g.LD + g.l * D + j];
    }
}

// REDC of each product's cyclic columns into out[p] (block layout), then
// two lazy passes (jnp_ops._redc).  The columns go to rows (lo,
// hi), and the quotient chain runs in blocks of D columns: the owner of
// block o (lane o) broadcasts its D columns, complete with every earlier
// quotient (D shuffles, independent of one another); every lane forms the
// block's D quotients and the carry from them, as jnp_ops._redc's
// digit-serial loop does, and adds q*n into its own rows, reading n from a
// window loaded ahead (one window serves every product).  The chain thus
// waits on a shuffle once per D quotients.
template <int D, int P>
__device__ __forceinline__ void redc_lanes(int (&out)[P][D],
                                           const uint32_t (&col)[P][2 * D],
                                           const Group& g) {
    const int L = g.L, l = g.l, nw = g.nw, LD = g.LD;
    uint32_t lo[P][D], hi[P][D], nr[D], carry[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        cols_to_rows<D>(lo[p], hi[p], col[p], g.sT + p * 2 * LD, g);
        carry[p] = 0;
    }
#pragma unroll
    for (int j = 0; j < D; ++j) nr[j] = (uint32_t)g.nP[L + j];
    for (int o = 0; o * D < nw; ++o) {
        uint32_t blk[P][D];
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
            for (int j = 0; j < D; ++j)
                blk[p][j] = __shfl_sync(TPUECM_FULL, lo[p][j], o, L);
        // n[i0 + t] for this lane's rows against the block's quotients:
        // row r and quotient column o*D + j' meet at n[r - o*D - j']
        const int i0 = (l - o) * D - (D - 1);
        uint32_t wl[2 * D - 1], wh[2 * D - 1];
#pragma unroll
        for (int t = 0; t < 2 * D - 1; ++t) {
            wl[t] = i0 + t >= 0 ? (uint32_t)g.nP[L + i0 + t] : 0u;
            wh[t] = (uint32_t)g.nP[L + LD + i0 + t];
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
            uint32_t qv[D];
#pragma unroll
            for (int j = 0; j < D; ++j) {
                const bool ok = o * D + j < nw;
                const uint32_t t = blk[p][j] + carry[p];
                const uint32_t q =
                    ok ? (t * g.nprime) & (uint32_t)g.mask : 0u;
                carry[p] = ok ? (uint32_t)((int)(t + q * g.n0) >> g.w)
                              : carry[p];
                qv[j] = q;
#pragma unroll
                for (int j2 = j + 1; j2 < D; ++j2)
                    blk[p][j2] += q * nr[j2 - j];
            }
            // lane o keeps its block as formed (its rows at and above nw
            // stay live); lanes below o hold spent rows and read zeros of
            // the window
#pragma unroll
            for (int j = 0; j < D; ++j) {
                uint32_t a = lo[p][j], b = hi[p][j];
#pragma unroll
                for (int jq = 0; jq < D; ++jq) {
                    a += qv[jq] * wl[j - jq + D - 1];
                    b += qv[jq] * wh[j - jq + D - 1];
                }
                lo[p][j] = l == o ? blk[p][j] : a;
                hi[p][j] = b;
            }
        }
    }
    __syncwarp();                       // every read of sT is done
#pragma unroll
    for (int p = 0; p < P; ++p) {
        int* sT = g.sT + p * 2 * LD;
#pragma unroll
        for (int j = 0; j < D; ++j) {
            const int rl = l * D + j, rh = LD + l * D + j;
            if (rl >= nw)
                sT[rl - nw] = (int)(lo[p][j] + (rl == nw ? carry[p] : 0u));
            if (rh < 2 * nw)
                sT[rh - nw] = (int)(hi[p][j] + (rh == nw ? carry[p] : 0u));
        }
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
            const int row = l * D + j;
            out[p][j] = row < nw ? g.sT[p * 2 * LD + row] : 0;
        }
        lazy_lanes<D>(out[p], nw, g);
        lazy_lanes<D>(out[p], nw, g);
    }
}

// This lane's part of one fold (jnp_ops._fold_once) of the old rows of
// each product in its sT, rows i at `row` into acc: acc starts from t_i
// (mod 2^e) and gets sign * |c|_l * hi_{i-l} for each digit l of |c|, hi_j
// being (t[k0+j] >> s) + ((t[k0+j+1] & (2^s-1)) << (w-s)).  The loop over
// l is outside, so the rows read sT independently of one another.
template <int D, int P>
__device__ __forceinline__ void fold_rows_lanes(uint32_t (&acc)[P][D],
                                                const int (&x)[P][D],
                                                int row, int rows,
                                                const Group& g) {
    const int k0 = g.k0, s = g.s;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < D; ++j) {
            const int i = row + j;
            acc[p][j] = i < k0 ? (uint32_t)x[p][j]
                      : (i == k0 ? (uint32_t)(x[p][j] & g.smask) : 0u);
        }
    for (int l = 0; l < g.cl; ++l) {
        const uint32_t cv = (uint32_t)g.c[l];
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int* sT = g.sT + p * 2 * g.LD;
#pragma unroll
            for (int j = 0; j < D; ++j) {
                const int hj = row + j - l;   // hi digit, row k0 + hj of t
                const bool ok = hj >= 0 && hj < rows - k0;
                const int lo = ok ? sT[k0 + hj] : 0;
                const int up = ok && k0 + hj + 1 < rows ? sT[k0 + hj + 1] : 0;
                const uint32_t prod =
                    cv * ((uint32_t)(lo >> s)
                          + (uint32_t)((up & g.smask) << (g.w - s)));
                acc[p][j] = g.csign < 0 ? acc[p][j] - prod
                                        : acc[p][j] + prod;
            }
        }
    }
}

// One fold of the two halves of each product in place, into out_rows rows.
template <int D, int P>
__device__ __forceinline__ void fold_lanes_once(int (&lo)[P][D],
                                                int (&hi)[P][D], int rows,
                                                int out_rows,
                                                const Group& g) {
    __syncwarp();                       // every read of sT is done
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < D; ++j) {
            g.sT[p * 2 * g.LD + g.l * D + j] = lo[p][j];
            g.sT[p * 2 * g.LD + g.LD + g.l * D + j] = hi[p][j];
        }
    __syncwarp();
    uint32_t alo[P][D], ahi[P][D];
    fold_rows_lanes<D, P>(alo, lo, g.l * D, rows, g);
    fold_rows_lanes<D, P>(ahi, hi, g.LD + g.l * D, rows, g);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < D; ++j) {
            lo[p][j] = g.l * D + j < out_rows ? (int)alo[p][j] : 0;
            hi[p][j] = g.LD + g.l * D + j < out_rows ? (int)ahi[p][j] : 0;
        }
}

// The fold of each product's cyclic columns into out[p] (pallas_ops
// fold_list, jnp_ops._mersenne_reduce): three rounds of two lazy passes and one fold, the last into
// nw rows, then two lazy passes.
template <int D, int P>
__device__ __forceinline__ void fold_lanes(int (&out)[P][D],
                                           const uint32_t (&col)[P][2 * D],
                                           const Group& g) {
    const int rows = 2 * g.nw;
    int lo[P][D], hi[P][D];
#pragma unroll
    for (int p = 0; p < P; ++p)
        cols_to_rows<D>((uint32_t*)lo[p], (uint32_t*)hi[p], col[p],
                        g.sT + p * 2 * g.LD, g);
#pragma unroll 1
    for (int round = 0; round < 3; ++round) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
            lazy2_lanes<D>(lo[p], hi[p], rows, g);
            lazy2_lanes<D>(lo[p], hi[p], rows, g);
        }
        fold_lanes_once<D, P>(lo, hi, rows, round < 2 ? rows : g.nw, g);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        lazy_lanes<D>(lo[p], g.nw, g);
        lazy_lanes<D>(lo[p], g.nw, g);
#pragma unroll
        for (int j = 0; j < D; ++j) out[p][j] = lo[p][j];
    }
}

// dst[p] = a[p]*b[p]/R (REDC) or a[p]*b[p] mod 2^e - c (fold) of pre-safe
// operands (slots; a square has a == b: the full product gives the same
// columns as the half one), P products at once.  A dst may be any operand:
// every lane has read the operands when it passes the barrier inside the
// reduction, before any lane writes a dst.
template <int D, int P>
__device__ __forceinline__ void mul_slots(int* const (&dst)[P],
                                          const int* const (&a)[P],
                                          const int* const (&b)[P],
                                          const Group& g) {
    __syncwarp();                       // the operands are complete
    uint32_t col[P][2 * D];
    int out[P][D];
    ab_cols<D, P>(col, a, b, g);
    if (g.e)
        fold_lanes<D, P>(out, col, g);
    else
        redc_lanes<D, P>(out, col, g);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < D; ++j) dst[p][g.l * D + j] = out[p][j];
}

// A point operation as a program of steps on the slots, so that a kernel
// holds one copy of the product.  A step is an ADD or SUB (d = a + b or
// a - b, then norm_inputs mode's pass), a MUL of TPUECM_PAIR products
// (d = a*b and d2 = a2*b2) or a NEG (d = 0 - a on every digit, no pass:
// the Edwards formulas' negations, run only by runners that ask for it),
// packed as kind | d << 4 | a << 8 | b << 12 | d2 << 16 | a2 << 20 |
// b2 << 24 (slot numbers; TPUECM_STEP and TPUECM_MUL2 name the slots).
enum { STEP_ADD, STEP_SUB, STEP_MUL, STEP_NEG };
#define TPUECM_PACK(kind, d, a, b) \
    ((kind) | (d) << 4 | (a) << 8 | (b) << 12)
#define TPUECM_PACK2(d, a, b, d2, a2, b2) \
    (TPUECM_PACK(STEP_MUL, d, a, b) | (d2) << 16 | (a2) << 20 | (b2) << 24)
#define TPUECM_STEP(kind, d, a, b) \
    TPUECM_PACK(kind, SLOT_##d, SLOT_##a, SLOT_##b)
#define TPUECM_MUL2(d, a, b, d2, a2, b2)                                     \
    TPUECM_PACK2(SLOT_##d, SLOT_##a, SLOT_##b, SLOT_##d2, SLOT_##a2,         \
                 SLOT_##b2)

// Duplicate (curve.ops.xdbl, pallas_ops._point_ops) of (X, Z) into (X, Z);
// S = (A+2)/4: sp = X+Z, dm = X-Z, V = dm^2, U = sp^2, X2 = U*V,
// W = U - V, Z2 = (s*W + V)*W.  The last product's partner is spent (T2,
// V, is dead by then).
__device__ const int TPUECM_DUP[] = {
    TPUECM_STEP(STEP_ADD, T0, X, Z),
    TPUECM_STEP(STEP_SUB, T1, X, Z),
    TPUECM_MUL2(T2, T1, T1, T3, T0, T0),          // V, U
    TPUECM_STEP(STEP_SUB, T1, T3, T2),            // W
    TPUECM_MUL2(X, T3, T2, T0, T1, S),            // X2, s*W
    TPUECM_STEP(STEP_ADD, T0, T0, T2),
    TPUECM_MUL2(Z, T0, T1, T2, T0, T1),           // Z2
};

// Differential add (curve.ops.xadd, pallas_ops._point_ops) of (X, Z) and
// (X2, Z2) with difference (XD, ZD) into (X, Z): U = (X-Z)(X2+Z2),
// V = (X+Z)(X2-Z2), X+ = ZD*(U+V)^2, Z+ = XD*(U-V)^2.
__device__ const int TPUECM_ADD[] = {
    TPUECM_STEP(STEP_ADD, T0, X, Z),
    TPUECM_STEP(STEP_SUB, T1, X, Z),
    TPUECM_STEP(STEP_ADD, T2, X2, Z2),
    TPUECM_STEP(STEP_SUB, T3, X2, Z2),
    TPUECM_MUL2(T1, T1, T2, T0, T0, T3),          // U, V
    TPUECM_STEP(STEP_ADD, T2, T1, T0),
    TPUECM_STEP(STEP_SUB, T3, T1, T0),
    TPUECM_MUL2(T2, T2, T2, T3, T3, T3),
    TPUECM_MUL2(X, T2, ZD, Z, T3, XD),
};
#define TPUECM_DUP_STEPS 7
#define TPUECM_ADD_STEPS 9

// Runs `steps` steps of a program on this curve's slots; NEG steps only
// where NEG is set (K9), so the other runners keep their two kinds.
template <int D, bool NEG = false>
__device__ __forceinline__ void run_steps(const int* prog, int steps,
                                          const Group& g) {
#pragma unroll 1
    for (int i = 0; i < steps; ++i) {
        const int st = prog[i], kind = st & 15;
        if (kind == STEP_MUL) {
            int* const dst[TPUECM_PAIR] = {g.slot((st >> 4) & 15),
                                           g.slot((st >> 16) & 15)};
            const int* const a[TPUECM_PAIR] = {g.slot((st >> 8) & 15),
                                               g.slot((st >> 20) & 15)};
            const int* const b[TPUECM_PAIR] = {g.slot((st >> 12) & 15),
                                               g.slot((st >> 24) & 15)};
            mul_slots<D, TPUECM_PAIR>(dst, a, b, g);
        } else if (NEG && kind == STEP_NEG) {
            neg_slots<D>(g.slot((st >> 4) & 15), g.slot((st >> 8) & 15), g);
        } else {
            addsub_slots<D>(g.slot((st >> 4) & 15), g.slot((st >> 8) & 15),
                            g.slot((st >> 12) & 15), kind == STEP_SUB, g);
        }
    }
}

#ifdef __CUDACC__
// Launches an instantiation of a lane-core kernel over B curves at L lanes
// a curve (TPUECM_TAPE_BLOCK / L curves a block) with smem bytes of
// dynamic shared memory, which it allows first (above 48 KB a block's must
// be); returns the refusal (a size past the card's limit:
// cudaErrorInvalidValue, cleared) or cudaGetLastError().
template <typename... P, typename... A>
__host__ inline int launch_lanes_smem(void (*kernel)(P...), int L, int B,
                                      size_t smem, cudaStream_t stream,
                                      A... args) {
    const int per_block = TPUECM_TAPE_BLOCK / L;
    const int blocks = (B + per_block - 1) / per_block;
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) {
        cudaGetLastError();
        return (int)rc;
    }
    kernel<<<blocks, TPUECM_TAPE_BLOCK, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

// The same with the slots' lanes_smem_bytes(L, D, S), the kernel's all.
template <int D, int S = TPUECM_SLOTS, typename... P, typename... A>
__host__ inline int launch_lanes(void (*kernel)(P...), int L, int B,
                                 cudaStream_t stream, A... args) {
    return launch_lanes_smem(kernel, L, B, lanes_smem_bytes(L, D, S), stream,
                             args...);
}

// Resident blocks per SM of an instantiation of a lane-core kernel of S
// slots at L lanes a curve and `extra` dynamic bytes past them; call after
// a launch of it, which allows its shared memory.
template <int D, int S = TPUECM_SLOTS, typename... P>
__host__ inline int lanes_occupancy(void (*kernel)(P...), int L,
                                    int* blocks_per_sm, size_t extra = 0) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, TPUECM_TAPE_BLOCK,
        lanes_smem_bytes(L, D, S) + extra);
}

// Defines extern "C" int name(int lanes, int digits, int* blocks_per_sm):
// resident blocks per SM of kernel<digits> (S slots a curve) at `lanes`
// lanes a curve (chip_smoke.py prints them beside the kernel's times).
#define TPUECM_LANES_OCCUPANCY_SLOTS(name, kernel, S)                        \
    extern "C" int name(int lanes, int digits, int* blocks_per_sm) {         \
        if (!lanes_ok(lanes)) return (int)cudaErrorInvalidValue;             \
        return with_lane_digits(digits, [&](auto d) {                        \
            constexpr int D = decltype(d)::value;                            \
            return lanes_occupancy<D, S>(kernel<D>, lanes, blocks_per_sm);   \
        });                                                                  \
    }
#define TPUECM_LANES_OCCUPANCY(name, kernel)                                 \
    TPUECM_LANES_OCCUPANCY_SLOTS(name, kernel, TPUECM_SLOTS)
#endif
