// K5, stage 2: the pairmap replay acc *= prod over entries of
// (Pa_inv[pa] - Pb[pb]), the cross product of the inverted form.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:make_replay_stream_executor at its
// default tree=4 (stage2/exec.py:1128), which streamed Pb rows through a
// manual DMA ring.
//
// idx = [count, e_0, ..., e_{T-1}] int32 with e = pa << 16 | pb.  Entries
// retire four at a time as pure values: four differences, each given one
// lazy pass, multiplied pairwise ((d0 d1)(d2 d3)) and then once into acc;
// the count % 4 tail entries multiply into acc one by one.  A pad entry
// G << 16 | 0 reads pa_ext[G] = the Montgomery one and pbx[0] = 0.
//
// Bound on the H100: integer multiply-adds, 1.25 dependent Montgomery
// products per entry on one thread per curve, against two nw*4-byte row
// gathers per entry per curve (coalesced across the warp; the Pa row of a
// v-sorted entry stream is mostly an L1/L2 hit, the Pb rows come from the
// whole table).
//
// Design: every thread reads the same index entry (uniform, no divergence)
// and keeps acc in a local array for the whole call.
#include "arith.cuh"

__device__ __forceinline__ void load_diff(int* d, const int* pa_ext,
                                          const int* pbx, int e, size_t row,
                                          size_t sB, const Mod& m) {
    const uint32_t u = (uint32_t)e;
    const int* pa = pa_ext + (u >> 16) * row;
    const int* pb = pbx + (u & 0xFFFFu) * row;
    for (int j = 0; j < m.nw; ++j)
        d[j] = (int)((uint32_t)pa[(size_t)j * sB] - (uint32_t)pb[(size_t)j * sB]);
    norm1(d, m);
}

__global__ void __launch_bounds__(TPUECM_THREADS)
replay_kernel(const int* __restrict__ acc_in, int* __restrict__ acc_out,
              const int* __restrict__ pa_ext, const int* __restrict__ pbx,
              const int* __restrict__ idx, const int* __restrict__ ndig,
              int nw, int w, int nprime, int norm, int B) {
    __shared__ Mod m;
    load_mod(m, ndig, nw, w, nprime, norm);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const size_t sB = (size_t)B;
    const size_t row = (size_t)nw * sB;
    const int count = idx[0];
    const int* ent = idx + 1;
    pa_ext += b;
    pbx += b;
    int acc[TPUECM_NW_MAX], d0[TPUECM_NW_MAX], d1[TPUECM_NW_MAX],
        d2[TPUECM_NW_MAX], d3[TPUECM_NW_MAX];
    load_row(acc, acc_in + b, sB, nw);
    const int quads = count / 4;
    for (int t = 0; t < quads; ++t) {
        const int* e = ent + 4 * t;
        load_diff(d0, pa_ext, pbx, e[0], row, sB, m);
        load_diff(d1, pa_ext, pbx, e[1], row, sB, m);
        load_diff(d2, pa_ext, pbx, e[2], row, sB, m);
        load_diff(d3, pa_ext, pbx, e[3], row, sB, m);
        mulmod(d0, d0, d1, m);
        mulmod(d2, d2, d3, m);
        mulmod(d0, d0, d2, m);
        mulmod(acc, acc, d0, m);
    }
    for (int k = 4 * quads; k < count; ++k) {
        load_diff(d0, pa_ext, pbx, ent[k], row, sB, m);
        mulmod(acc, acc, d0, m);
    }
    store_row(acc_out + b, acc, sB, nw);
}

extern "C" int tpuecm_replay(const int* acc_in, int* acc_out,
                             const int* pa_ext, const int* pbx,
                             const int* idx, const int* ndig, int nw, int w,
                             int nprime, int norm, int B, void* stream) {
    if (nw < 2 || nw > TPUECM_NW_MAX || B < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + TPUECM_THREADS - 1) / TPUECM_THREADS;
    replay_kernel<<<blocks, TPUECM_THREADS, 0, (cudaStream_t)stream>>>(acc_in, acc_out, pa_ext, pbx, idx, ndig, nw, w, nprime, norm, B);
    return (int)cudaGetLastError();
}
