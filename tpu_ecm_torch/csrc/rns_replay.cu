// K15, stage 2 of the RNS engine: the pairmap replay acc *= prod over
// entries of (Pa_inv[pa] - Pb[pb]), the cross product of the inverted
// form, on [2K+1, B] residue planes.
//
// Replaces tpu_ecm/limbs/rns_exec.py:make_rns_replay_stream_executor at
// its defaults (unroll=1, n_acc=1), which streamed Pb rows through a manual
// DMA ring of sublane-padded slabs.
//
// idx = [count, e_0, ..., e_{T-1}] int32 with e = pa << 16 | pb.  Entries
// retire one at a time, in entry order, as in the Pallas kernel: acc :=
// acc * sub(pa_ext[pa], pbx[pb]), so the residues equal that kernel's and
// the plain version's exactly.  A pad entry G << 16 | 0 multiplies by
// sub(one, 0) = one + F, which is one mod n.
//
// Bound on the H100: integer multiply-adds, one RNS product per entry
// (about 2*K*(K+1) multiply-adds per curve) with the extension matrices in
// shared memory (csrc/rns_arith.cuh), against two row gathers of (2K+1)*4
// bytes per entry and curve (the Pa row of a v-sorted stream mostly hits
// L1/L2; Pb rows come from the whole table, 1.58 GB at K=200, B=1024).
//
// Design: every lane reads the same index entry (uniform, no divergence)
// and keeps acc in registers for the whole call; no padding is needed.
#include "rns_arith.cuh"

__global__ void __launch_bounds__(RNS_MAX_THREADS)
rns_replay_kernel(const int* __restrict__ acc_in, int* __restrict__ acc_out,
                  const int* __restrict__ pa_ext, const int* __restrict__ pbx,
                  const int* __restrict__ idx, const int* __restrict__ tab,
                  const int* __restrict__ wpk, int K, int B, int resident) {
    RnsLane L;
    rns_setup(L, tab, wpk, K, B, resident);
    const size_t row = (size_t)(2 * K + 1) * B;
    const int count = idx[0];
    RV acc, a, d;
    load_rv(acc, acc_in, L);
    for (int k = 0; k < count; ++k) {
        const uint32_t e = (uint32_t)idx[1 + k];
        load_rv(a, pa_ext + (e >> 16) * row, L);
        load_rv(d, pbx + (e & 0xFFFFu) * row, L);
        rns_sub(d, a, d, L);
        rns_mul(acc, acc, d, L);
    }
    store_rv(acc_out, acc, L);
}

extern "C" int tpuecm_rns_replay(const int* acc_in, int* acc_out,
                                 const int* pa_ext, const int* pbx,
                                 const int* idx, const int* tab,
                                 const int* wpk, int K, int B, void* stream) {
    RnsLaunch c;
    const int rc = rns_launch_config(rns_replay_kernel, K, B, c);
    if (rc != (int)cudaSuccess) return rc;
    rns_replay_kernel<<<c.grid, c.block, c.smem, (cudaStream_t)stream>>>(acc_in, acc_out, pa_ext, pbx, idx, tab, wpk, K, B, c.resident);
    return (int)cudaGetLastError();
}
