// Cycles of the sections of one K10 product (csrc/rns_mma.cuh: mma_mul),
// read with clock64() by thread 0 of every block and averaged: phase A
// (mul_head), the first dot (ext_dot), phase C (mul_mid), the second dot
// and phase E (mul_tail), each up to the barrier that ends it; then one
// dot's mma alone, on fragments loaded once (the tensor pipe's share).
// Synthetic tables and residues inside the kernels' bounds (timing does
// not depend on their values), K=200 and K=128 at B=1024, 8 curves a
// block as K10 runs them.
// Built and run on the card by tools/k10_probe/probe.py.
#include <cstdio>
#include <random>
#include <vector>
#include "rns_mma.cuh"

#define SEGS 6

// one dot's mma on fragments loaded once
__device__ __forceinline__ unsigned dot_mma(const MmaCtx& L, int plane) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
    const size_t wsz = (size_t)L.mt * L.kt * 512;
    unsigned sink = 0;
    for (int item = warp; item < 2 * L.mt; item += warps) {
        const int m = item >> 1, h = item & 1;
        const unsigned char* w = L.w + (plane + h) * wsz
                                 + (size_t)m * L.kt * 512;
        wmma::fragment<wmma::matrix_a, 32, 8, 16, unsigned char,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 32, 8, 16, unsigned char,
                       wmma::col_major> vl, vh;
        wmma::fragment<wmma::accumulator, 32, 8, 16, int> lo, hi;
        wmma::fill_fragment(lo, 0);
        wmma::fill_fragment(hi, 0);
        wmma::load_matrix_sync(a, w, 16);
        wmma::load_matrix_sync(vl, L.x, 16);
        wmma::load_matrix_sync(vh, L.x + 128 * L.kt, 16);
        for (int k = 0; k < L.kt; ++k) {
            wmma::mma_sync(lo, a, vl, lo);
            wmma::mma_sync(hi, a, vh, hi);
        }
        for (int i = 0; i < lo.num_elements; ++i) sink += lo.x[i] ^ hi.x[i];
    }
    return sink;
}

__global__ void __launch_bounds__(448)
sections(long long* out, unsigned* sink, const int* tab,
         const unsigned char* wmma, const int* vals, int K, int B,
         int reps) {
    extern __shared__ __align__(128) unsigned char smem[];
    MmaCtx L;
    mma_setup<8>(L, smem, tab, wmma, K, B);
    MV x, y;
    load_mv(x, vals, L);
    load_mv(y, vals + (size_t)(2 * K + 1) * B, L);
    long long seg[SEGS] = {0};
    unsigned s = 0;
    for (int r = 0; r < reps; ++r) {
        uint32_t sR[4];
        __syncthreads();
        const long long t0 = clock64();
        mul_head(sR, x, y, L);
        __syncthreads();
        const long long t1 = clock64();
        ext_dot<8>(L, 0);
        __syncthreads();
        const long long t2 = clock64();
        mul_mid(x, sR, L);
        __syncthreads();
        const long long t3 = clock64();
        ext_dot<8>(L, 2);
        __syncthreads();
        const long long t4 = clock64();
        mul_tail(x, L);
        __syncthreads();
        const long long t5 = clock64();
        s += dot_mma(L, 0);
        __syncthreads();
        const long long t6 = clock64();
        const long long t[7] = {t0, t1, t2, t3, t4, t5, t6};
        for (int i = 0; i < SEGS; ++i) seg[i] += t[i + 1] - t[i];
    }
    for (int i = 0; i < 4; ++i) s += x.a[i] ^ x.r[i];
    if (threadIdx.x == 0)
        for (int i = 0; i < SEGS; ++i) out[blockIdx.x * SEGS + i] = seg[i];
    atomicAdd(sink, s);
}

static void run(int K, int B, int reps) {
    std::mt19937 rng(K);
    const int rows = 2 * K + 1;
    std::vector<int> p(rows);
    for (int i = 0; i < 2 * K; ++i) p[i] = 8191 - 2 * i;
    p[2 * K] = 1 << 14;
    std::vector<int> tab(9 * K + 5, 0);
    for (int i = 0; i < rows; ++i) tab[RNS_TAB_P(K) + i] = p[i];
    auto below = [&](int m) { return (int)(rng() % (unsigned)m); };
    for (int i = 0; i < K; ++i) {
        tab[RNS_TAB_C1(K) + i] = below(p[i]);
        tab[RNS_TAB_QDI(K) + i] = below(p[K + i]);
        tab[RNS_TAB_QMOD(K) + i] = below(p[i]);
    }
    for (int i = 0; i <= K; ++i) {
        tab[RNS_TAB_PINV(K) + i] = below(p[K + i]);
        tab[RNS_TAB_NPINV(K) + i] = below(p[K + i]);
    }
    for (int i = 0; i < rows; ++i) tab[RNS_TAB_FSUB(K) + i] = below(p[i]);
    tab[RNS_TAB_QINV(K)] = 2 * below(1 << 13) + 1;
    const size_t wbytes = 4 * (size_t)rns_kpad(K) * rns_mpad(K);
    std::vector<unsigned char> w(wbytes);
    for (size_t i = 0; i < wbytes; ++i)
        w[i] = (unsigned char)(rng() % ((i / (wbytes / 4)) % 2 ? 64 : 256));
    std::vector<int> vals(2 * (size_t)rows * B);
    for (size_t i = 0; i < vals.size(); ++i)
        vals[i] = below(p[(i / B) % rows]);
    RnsMmaLaunch c;
    if (rns_tape_config(K, B, 8, c) != 0) {
        std::printf("K=%d: no T=8 launch\n", K);
        return;
    }
    int *dtab, *dvals;
    unsigned char* dw;
    long long* dout;
    unsigned* dsink;
    cudaMalloc(&dtab, tab.size() * 4);
    cudaMalloc(&dvals, vals.size() * 4);
    cudaMalloc(&dw, wbytes);
    cudaMalloc(&dout, c.blocks * SEGS * 8);
    cudaMalloc(&dsink, 4);
    cudaMemcpy(dtab, tab.data(), tab.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(dvals, vals.data(), vals.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(dw, w.data(), wbytes, cudaMemcpyHostToDevice);
    cudaFuncSetAttribute(sections, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)c.smem);
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    sections<<<c.blocks, c.threads, c.smem>>>(dout, dsink, dtab, dw, dvals,
                                              K, B, 4);
    cudaEventRecord(e0);
    sections<<<c.blocks, c.threads, c.smem>>>(dout, dsink, dtab, dw, dvals,
                                              K, B, reps);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0;
    cudaEventElapsedTime(&ms, e0, e1);
    const cudaError_t err = cudaGetLastError();
    std::vector<long long> out(c.blocks * SEGS);
    cudaMemcpy(out.data(), dout, out.size() * 8, cudaMemcpyDeviceToHost);
    double avg[SEGS] = {0};
    for (int b = 0; b < c.blocks; ++b)
        for (int i = 0; i < SEGS; ++i)
            avg[i] += (double)out[b * SEGS + i] / reps / c.blocks;
    const char* names[SEGS] = {"A", "dot1", "C", "dot2", "E",
                               "dot mma only"};
    std::printf("K=%d B=%d T=8 threads=%d blocks=%d (%s): %.3f ms for %d "
                "reps, cycles per product section:", K, B, c.threads,
                c.blocks, cudaGetErrorString(err), ms, reps);
    for (int i = 0; i < SEGS; ++i) std::printf(" %s %.0f;", names[i], avg[i]);
    std::printf(" product %.0f\n", avg[0] + avg[1] + avg[2] + avg[3] + avg[4]);
    cudaFree(dtab);
    cudaFree(dvals);
    cudaFree(dw);
    cudaFree(dout);
    cudaFree(dsink);
}

int main() {
    run(200, 1024, 200);
    run(128, 1024, 200);
    return 0;
}
