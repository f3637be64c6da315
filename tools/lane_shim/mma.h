// A CPU stand-in for the part of the CUDA toolkit's mma.h (nvcuda::wmma)
// that tpu_ecm_torch/csrc/rns_mma.cuh uses: u8 x u8 -> s32 tiles of shape
// m32n8k16, loaded from and stored to memory (see cuda_runtime.h beside
// this file for the threads and barriers).
//
// Each operation is warp-collective: it starts with the warp's barrier, so
// a call that not every lane of a warp makes hangs here as it would be
// undefined on the card.  Lane l holds row l of an A or accumulator tile
// and the whole B tile, so an element-wise operation on two accumulators
// of one type pairs the same (row, column), as on the card.  A pointer
// that is not 32-byte aligned, or an ldm that is not a multiple of 16
// bytes, aborts (the card's rule for load_matrix_sync and
// store_matrix_sync).
#pragma once
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <type_traits>

#include <cuda_runtime.h>

namespace nvcuda {
namespace wmma {

struct matrix_a {};
struct matrix_b {};
struct accumulator {};
struct row_major {};
struct col_major {};
enum layout_t { mem_row_major, mem_col_major };

template <typename Use, int M, int N, int K, typename T,
          typename Layout = void>
struct fragment;

template <typename Layout>
struct fragment<matrix_a, 32, 8, 16, unsigned char, Layout> {
    static constexpr int num_elements = 16;
    unsigned char x[16];      // row l of the 32 x 16 tile
};

template <typename Layout>
struct fragment<matrix_b, 32, 8, 16, unsigned char, Layout> {
    static constexpr int num_elements = 128;
    unsigned char x[128];     // the 16 x 8 tile, x[k * 8 + n]
};

template <>
struct fragment<accumulator, 32, 8, 16, int, void> {
    static constexpr int num_elements = 8;
    int x[8];                 // row l of the 32 x 8 tile
};

inline void emu_check_tile(const void* p, unsigned ldm_bytes) {
    if ((uintptr_t)p % 32 || ldm_bytes % 16) {
        std::fprintf(stderr, "wmma: pointer %p or ldm of %u bytes breaks "
                     "the 32-byte / 16-byte rule\n", p, ldm_bytes);
        std::abort();
    }
}

inline int emu_lane() { return threadIdx.x % 32; }

template <typename Layout>
inline void load_matrix_sync(
        fragment<matrix_a, 32, 8, 16, unsigned char, Layout>& a,
        const unsigned char* p, unsigned ldm) {
    __syncwarp();
    emu_check_tile(p, ldm);
    const int l = emu_lane();
    for (int k = 0; k < 16; ++k)
        a.x[k] = std::is_same_v<Layout, row_major> ? p[l * ldm + k]
                                                   : p[k * ldm + l];
}

template <typename Layout>
inline void load_matrix_sync(
        fragment<matrix_b, 32, 8, 16, unsigned char, Layout>& b,
        const unsigned char* p, unsigned ldm) {
    __syncwarp();
    emu_check_tile(p, ldm);
    for (int k = 0; k < 16; ++k)
        for (int n = 0; n < 8; ++n)
            b.x[k * 8 + n] = std::is_same_v<Layout, row_major>
                                 ? p[k * ldm + n] : p[n * ldm + k];
}

inline void fill_fragment(fragment<accumulator, 32, 8, 16, int>& c, int v) {
    __syncwarp();
    for (int& e : c.x) e = v;
}

template <typename LA, typename LB>
inline void mma_sync(fragment<accumulator, 32, 8, 16, int>& d,
                     const fragment<matrix_a, 32, 8, 16, unsigned char, LA>& a,
                     const fragment<matrix_b, 32, 8, 16, unsigned char, LB>& b,
                     const fragment<accumulator, 32, 8, 16, int>& c) {
    __syncwarp();
    int out[8];
    for (int n = 0; n < 8; ++n) {
        int s = c.x[n];
        for (int k = 0; k < 16; ++k) s += (int)a.x[k] * (int)b.x[k * 8 + n];
        out[n] = s;
    }
    for (int n = 0; n < 8; ++n) d.x[n] = out[n];
}

inline void store_matrix_sync(int* p,
                              const fragment<accumulator, 32, 8, 16, int>& c,
                              unsigned ldm, layout_t layout) {
    __syncwarp();
    emu_check_tile(p, 4 * ldm);
    const int l = emu_lane();
    for (int n = 0; n < 8; ++n)
        (layout == mem_row_major ? p[l * ldm + n] : p[n * ldm + l]) = c.x[n];
}

}  // namespace wmma
}  // namespace nvcuda
