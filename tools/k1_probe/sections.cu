// Cycles of the sections of one K1 product step (csrc/arith_lanes.cuh),
// read with clock64() by the first warp of the first block: the a*b
// columns of a pair of products, their reduction (REDC or fold), the whole
// step (mul_slots), and one sum with its norm_inputs pass.  Built and run
// on the card by tools/k1_probe/probe.py; prints one line per geometry.
#include <cstdio>
#include <vector>
#include "arith_lanes.cuh"

template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
sections(long long* out, TPUECM_MOD_PARAMS, int B, int L, int reps) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D>(smem, L, m);
    int* A = g.slot(SLOT_T0);
    int* Bv = g.slot(SLOT_T1);
    int* C = g.slot(SLOT_T2);
    for (int j = 0; j < D; ++j) {
        const int row = g.l * D + j;
        A[row] = row < nw ? (row * 37 + threadIdx.x) & g.mask : 0;
        Bv[row] = row < nw ? (row * 91 + 5 * threadIdx.x) & g.mask : 0;
    }
    __syncwarp();
    long long t_ab = 0, t_red = 0, t_mul = 0, t_add = 0;
    const int* const x[2] = {A, Bv};
    const int* const y[2] = {Bv, A};
    int* const dd[2] = {C, g.slot(SLOT_T3)};
    for (int i = 0; i < reps; ++i) {
        __syncwarp();
        long long t0 = clock64();
        uint32_t col[2][2 * D];
        ab_cols<D, 2>(col, x, y, g);
        uint32_t sink = 0;             // keeps the columns live
        for (int k = 0; k < 2 * D; ++k) sink ^= col[0][k] ^ col[1][k];
        __syncwarp();
        long long t1 = clock64();
        int o[2][D];
        if (g.e) fold_lanes<D, 2>(o, col, g); else redc_lanes<D, 2>(o, col, g);
        for (int j = 0; j < D; ++j)
            C[g.l * D + j] = o[0][j] ^ o[1][j] ^ (int)(sink & 0);
        __syncwarp();
        long long t2 = clock64();
        mul_slots<D, 2>(dd, x, y, g);
        __syncwarp();
        long long t3 = clock64();
        addsub_slots<D>(C, A, Bv, true, g);
        __syncwarp();
        long long t4 = clock64();
        t_ab += t1 - t0; t_red += t2 - t1; t_mul += t3 - t2; t_add += t4 - t3;
    }
    if (threadIdx.x == 0) {
        out[4 * blockIdx.x + 0] = t_ab / reps;
        out[4 * blockIdx.x + 1] = t_red / reps;
        out[4 * blockIdx.x + 2] = t_mul / reps;
        out[4 * blockIdx.x + 3] = t_add / reps;
    }
}

template <int D>
void run(const char* label, int nw, int w, int e, int L, int B) {
    std::vector<int> n(nw), c(1, 1);
    for (int i = 0; i < nw; ++i) n[i] = (i * 2654435761u) & ((1 << w) - 1);
    n[0] |= 1;
    int *dn, *dc; long long* dout;
    cudaMalloc(&dn, nw * 4); cudaMalloc(&dc, 4);
    cudaMemcpy(dn, n.data(), nw * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(dc, c.data(), 4, cudaMemcpyHostToDevice);
    const int per = TPUECM_TAPE_BLOCK / L, blocks = (B + per - 1) / per;
    cudaMalloc(&dout, blocks * 4 * 8);
    size_t smem = lanes_smem_bytes(L, D);
    cudaFuncSetAttribute(sections<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
    sections<D><<<blocks, TPUECM_TAPE_BLOCK, smem>>>(
        dout, dn, dc, 1, e, 1, nw, w, 12345, 0, B, L, 2);
    cudaEventRecord(a);
    sections<D><<<blocks, TPUECM_TAPE_BLOCK, smem>>>(
        dout, dn, dc, 1, e, 1, nw, w, 12345, 0, B, L, 200);
    cudaEventRecord(b); cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b);
    long long h[4]; cudaMemcpy(h, dout, 32, cudaMemcpyDeviceToHost);
    printf("%s nw=%d L=%d D=%d B=%d: cycles per pair of products: a*b %lld, "
           "reduction %lld, whole step %lld; one sum %lld; %.3f ms for 200 "
           "repetitions (%s)\n", label, nw, L, D, B, h[0], h[1], h[2], h[3],
           ms,
           cudaGetErrorString(cudaGetLastError()));
}

int main() {
    run<5>("N416 REDC", 36, 12, 0, 8, 128);
    run<5>("N416 REDC", 36, 12, 0, 8, 2048);
    run<8>("M1277 fold", 118, 11, 1277, 16, 128);
    run<8>("M1277 fold", 118, 11, 1277, 16, 2048);
    run<8>("1277-bit REDC", 118, 11, 0, 16, 128);
    return 0;
}
