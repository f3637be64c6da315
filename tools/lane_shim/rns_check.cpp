// Entry points that run the kernel bodies of K10 (tpu_ecm_torch/csrc/
// rns_tape.cu), K11 (csrc/rns_chain.cu), K12 and K13
// (csrc/rns_batch_inverse.cu), K14 (csrc/rns_replay_gather.cu) and K15
// (csrc/rns_replay.cu), all on csrc/rns_mma.cuh, on the CPU through
// cuda_runtime.h and mma.h beside this file, on host arrays laid out as
// the kernels' planes:
//   rns_tape_run:   K10's body over the [6, 2, 2K+1, B] file in place, at
//                   rns_tape_config's geometry for `tile`;
//   rns_chain_run:  K11's body on one chain of `count` rows, at
//                   rns_chain_config's geometry for `tile`;
//   rns_prefix_run: K12's body on one stack of `count` rows, at
//                   rns_prefix_config's geometry for `tile`;
//   rns_apply_inverse_run: K13's body on one stack of `count` rows, at
//                   rns_apply_inverse_config's geometry for `tile`;
//   rns_gather_run: K14's body on one call, at rns_gather_config's
//                   geometry for `tile`, its cp.async copies landing at
//                   once or (late) at their wait;
//   rns_replay_run: K15's body on one call of `count` entries, at
//                   rns_replay_config's geometry for `tile`, its cp.async
//                   copies landing at once or (late) at their wait;
//   rns_reduce:     red, mulc and chan on n inputs.
// The sources' own geometry entry points (tpuecm_rns_tape_geometry,
// tpuecm_rns_chain_geometry, tpuecm_rns_prefix_geometry,
// tpuecm_rns_apply_inverse_geometry, tpuecm_rns_gather_geometry,
// tpuecm_rns_replay_geometry) are exported as they are.  All but the last
// return the launch's code (0, or cudaErrorInvalidValue for a K, B, tile
// or call shape the kernel refuses).
#include <cstdlib>
#include <cstring>
#include <type_traits>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "rns_batch_inverse.cu"
#include "rns_chain.cu"
#include "rns_replay.cu"
#include "rns_replay_gather.cu"
#include "rns_tape.cu"

using I4 = std::integral_constant<int, 4>;
using I8 = std::integral_constant<int, 8>;
using H1 = std::integral_constant<int, 1>;
using H2 = std::integral_constant<int, 2>;

// run(T, H) at a paired kernel's (K11's, K13's, K14's) instantiation for c
template <typename Run>
static void at_instantiation(const RnsMmaLaunch& c, Run run) {
    if (c.tile == 4) run(I4{}, H2{});
    else if (c.halves == 2) run(I8{}, H2{});
    else run(I8{}, H1{});
}

// body(smem) on each thread of each block of launch c, as emu_launch runs
// them, over one shared-memory buffer of c.smem bytes filled with 0xA5
// first; returns 0
template <typename Body>
static int on_blocks(const RnsMmaLaunch& c, Body body) {
    const size_t bytes = (c.smem + 127) / 128 * 128;
    auto* smem = static_cast<unsigned char*>(std::aligned_alloc(128, bytes));
    std::memset(smem, 0xA5, bytes);   // no read may rely on zeroed memory
    emu_launch(c.blocks, c.threads, [&] { body(smem); });
    std::free(smem);
    return 0;
}

extern "C" int rns_tape_run(const int* tape, long long nsteps, int* pts,
                            const int* s_const, const int* tab,
                            const unsigned char* wmma, int K, int B,
                            int tile) {
    RnsMmaLaunch c;
    const int rc = rns_tape_config(K, B, tile, c);
    if (rc != cudaSuccess) return rc;
    return on_blocks(c, [&](unsigned char* smem) {
        if (tile == 8)
            rns_tape_body<8>(smem, tape, nsteps, pts, s_const, tab, wmma, K,
                             B);
        else
            rns_tape_body<4>(smem, tape, nsteps, pts, s_const, tab, wmma, K,
                             B);
    });
}

extern "C" int rns_chain_run(const int* p1, const int* p2, const int* pd,
                             int* out, int count, const int* tab,
                             const unsigned char* wmma, int K, int B,
                             int tile) {
    if (count < 1) return cudaErrorInvalidValue;
    RnsMmaLaunch c;
    const int rc = rns_chain_config(K, B, tile, c);
    if (rc != cudaSuccess) return rc;
    return on_blocks(c, [&](unsigned char* smem) {
        at_instantiation(c, [&](auto t, auto h) {
            rns_chain_body<decltype(t)::value, decltype(h)::value>(
                smem, p1, p2, pd, out, count, tab, wmma, K, B);
        });
    });
}

extern "C" int rns_prefix_run(const int* zs, const int* one, int* out,
                              int count, const int* tab,
                              const unsigned char* wmma, int K, int B,
                              int tile) {
    if (count < 1) return cudaErrorInvalidValue;
    RnsMmaLaunch c;
    const int rc = rns_prefix_config(K, B, tile, c);
    if (rc != cudaSuccess) return rc;
    return on_blocks(c, [&](unsigned char* smem) {
        if (c.tile == 8)
            rns_prefix_body<8>(smem, zs, one, out, count, tab, wmma, K, B);
        else
            rns_prefix_body<4>(smem, zs, one, out, count, tab, wmma, K, B);
    });
}

extern "C" int rns_apply_inverse_run(const int* xs, const int* zs,
                                     const int* pres, const int* total_inv,
                                     int* out, int count, const int* tab,
                                     const unsigned char* wmma, int K, int B,
                                     int tile) {
    if (count < 1) return cudaErrorInvalidValue;
    RnsMmaLaunch c;
    const int rc = rns_apply_inverse_config(K, B, tile, c);
    if (rc != cudaSuccess) return rc;
    return on_blocks(c, [&](unsigned char* smem) {
        at_instantiation(c, [&](auto t, auto h) {
            rns_apply_inverse_body<decltype(t)::value, decltype(h)::value>(
                smem, xs, zs, pres, total_inv, out, count, tab, wmma, K, B);
        });
    });
}

extern "C" int rns_gather_run(const int* acc_in, int* acc_out,
                              int* scratch, const int* pa_ext,
                              const int* pbx,
                              const int* idx, int nsteps, int E,
                              const int* tab, const unsigned char* wmma,
                              int K, int B, int tile, int late) {
    if (!gather_args_ok(nsteps, E)) return cudaErrorInvalidValue;
    RnsMmaLaunch c;
    const int rc = rns_gather_config(K, B, tile, c);
    if (rc != cudaSuccess) return rc;
    emu_copy_late = late;
    return on_blocks(c, [&](unsigned char* smem) {
        at_instantiation(c, [&](auto t, auto h) {
            rns_replay_gather_body<decltype(t)::value, decltype(h)::value>(
                smem, acc_in, acc_out, scratch, pa_ext, pbx, idx, nsteps, E,
                tab, wmma, K, B);
        });
    });
}

extern "C" int rns_replay_run(const int* acc_in, int* acc_out,
                              const int* pa_ext, const int* pbx,
                              const int* idx, int count, const int* tab,
                              const unsigned char* wmma, int K, int B,
                              int tile, int late) {
    if (count < 0) return cudaErrorInvalidValue;
    RnsMmaLaunch c;
    const int rc = rns_replay_config(K, B, tile, c);
    if (rc != cudaSuccess) return rc;
    emu_copy_late = late;
    return on_blocks(c, [&](unsigned char* smem) {
        if (c.tile == 8)
            rns_replay_body<8>(smem, acc_in, acc_out, pa_ext, pbx, idx,
                               count, tab, wmma, K, B);
        else
            rns_replay_body<4>(smem, acc_in, acc_out, pa_ext, pbx, idx,
                               count, tab, wmma, K, B);
    });
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
