// Entry points that run K10's kernel body (tpu_ecm_torch/csrc/rns_tape.cu
// on csrc/rns_mma.cuh) on the CPU through cuda_runtime.h and mma.h beside
// this file, on host arrays laid out as the kernel's planes:
//   rns_tape_run:      the body over the [6, 2, 2K+1, B] file in place, at
//                      rns_tape_config's geometry for `tile`;
//   rns_tape_geometry: that geometry, {tile, threads, blocks, resident,
//                      smem bytes};
//   rns_reduce:        red, mulc and chan on n inputs.
// The first two return rns_tape_config's code (0, or cudaErrorInvalidValue
// for a K, B or tile the kernel refuses).
#include <cstdlib>
#include <cstring>

#include <cuda_runtime.h>
#include <mma.h>

#include "rns_tape.cu"

extern "C" int rns_tape_geometry(int K, int B, int tile, long long* out) {
    RnsTapeLaunch c;
    const int rc = rns_tape_config(K, B, tile, c);
    if (rc != cudaSuccess) return rc;
    const long long g[5] = {c.tile, c.threads, c.blocks, c.resident,
                            (long long)c.smem};
    std::memcpy(out, g, sizeof g);
    return 0;
}

extern "C" int rns_tape_run(const int* tape, long long nsteps, int* pts,
                            const int* s_const, const int* tab,
                            const unsigned char* wmma, int K, int B,
                            int tile) {
    RnsTapeLaunch c;
    const int rc = rns_tape_config(K, B, tile, c);
    if (rc != cudaSuccess) return rc;
    const size_t bytes = (c.smem + 127) / 128 * 128;
    auto* smem = static_cast<unsigned char*>(std::aligned_alloc(128, bytes));
    std::memset(smem, 0xA5, bytes);   // no read may rely on zeroed memory
    emu_launch(c.blocks, c.threads, [&] {
        if (tile == 8)
            rns_tape_body<8>(smem, tape, nsteps, pts, s_const, tab, wmma, K,
                             B);
        else
            rns_tape_body<4>(smem, tape, nsteps, pts, s_const, tab, wmma, K,
                             B);
    });
    std::free(smem);
    return 0;
}

// out[3i] = red(x[i]), out[3i+1] = mulc(x[i], w), out[3i+2] = chan(x[i],
// y[i]), all mod p
extern "C" void rns_reduce(const unsigned* x, const unsigned* y, int n,
                           unsigned p, unsigned w, unsigned* out) {
    const unsigned m = barrett_m(p), ws = shoup_w(w, p);
    for (int i = 0; i < n; ++i) {
        out[3 * i] = red(x[i], p, m);
        out[3 * i + 1] = mulc(x[i], w, ws, p);
        out[3 * i + 2] = chan(x[i], y[i], p, m);
    }
}
