// Entry points that run the lane core of tpu_ecm_torch/csrc/arith_lanes.cuh
// on the CPU through cuda_runtime.h beside this file, on host arrays laid
// out as the kernels' planes ([.., NW, B], curve axis last):
//   lanes_mul:   out = a*b (op 0), a*a (op 1), or a*b written over a's slot
//                (op 2), paired in one step with out2 = b*b;
//   lanes_point: the DUP (add = 0) or ADD (add = 1) program on
//                in = [x, z, x2, z2, xd, zd] with s, into out = [x, z];
//   lanes_replay: K5's kernel body (csrc/replay.cu) on one call, its Pb
//                copies landing at once (late = 0) or at their wait (1);
//   lanes_replay_gather: K6's (parow = 0: idx [T, 2] pairs) or K7's
//                (parow = 1: idx [S, 1 + E] steps, with `one`) kernel body
//                (csrc/replay_passes.cuh) on one call of nsteps steps of E
//                entries, its copies landing as K5's;
//   lanes_replay_resident: K8's kernel body (csrc/replay_resident.cu) on
//                one call: entries [T, 2] (pa, slab row) in nslabs slab
//                segments [nslabs, 3] of cap rows, its slab fills landing
//                as K5's copies;
//   lanes_ed_tape: K9's kernel body (csrc/ed_tape.cu) on one tape, over
//                acc [4, NW, B] in place with the table [Tp, 3, NW, B];
//   lanes_chain: K2's kernel body (csrc/chain.cu), count rows from the
//                points p1, p2, pd [2, NW, B] into out [count, 2, NW, B];
//   lanes_prefix: K3's kernel body (csrc/batch_inverse.cu), zs [count, NW,
//                B] and one [NW, B] into out [count, NW, B];
//   lanes_apply_inverse: K4's kernel body (csrc/batch_inverse.cu), xs, zs,
//                pres [count, NW, B] and total_inv [NW, B] into out.
//   K3's and K4's cp.async copies land at once (late = 0) or at their
//   wait (1), as K5's.
// Each returns 0, or 1 for a digit count with no instantiation (or a
// step shape the kernel refuses, or a slab past the shared buffer).
#include <cuda_runtime.h>

#include "arith_lanes.cuh"
#include "batch_inverse.cu"
#include "chain.cu"
#include "ed_tape.cu"
#include "replay.cu"
#include "replay_gather.cu"
#include "replay_resident.cu"

namespace {

int smem_words[1 << 16];

template <int D>
void mul_body(const int* a, const int* b, int* out, int* out2,
              TPUECM_MOD_PARAMS, int B, int L, int op) {
    __shared__ Mod m;
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D>(smem_words, L, m);
    const int curve = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
    const int c = curve < B ? curve : B - 1;
    load_slot<D>(g.slot(SLOT_T0), a + c, B, g, nw);
    load_slot<D>(g.slot(SLOT_T1), b + c, B, g, nw);
    int* const dst[TPUECM_PAIR] = {g.slot(op == 2 ? SLOT_T0 : SLOT_T2),
                                   g.slot(SLOT_T3)};
    const int* const x[TPUECM_PAIR] = {g.slot(SLOT_T0), g.slot(SLOT_T1)};
    const int* const y[TPUECM_PAIR] = {
        g.slot(op == 1 ? SLOT_T0 : SLOT_T1), g.slot(SLOT_T1)};
    mul_slots<D, TPUECM_PAIR>(dst, x, y, g);
    if (curve < B) {
        store_slot<D>(out + c, dst[0], B, g, nw);
        store_slot<D>(out2 + c, dst[1], B, g, nw);
    }
}

template <int D>
void point_body(const int* in, int* out, const int* s, TPUECM_MOD_PARAMS,
                int B, int L, int add) {
    __shared__ Mod m;
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D>(smem_words, L, m);
    const int curve = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
    const int c = curve < B ? curve : B - 1;
    const size_t plane = (size_t)nw * B;
    for (int i = 0; i < 6; ++i)
        load_slot<D>(g.slot(SLOT_X + i), in + i * plane + c, B, g, nw);
    load_slot<D>(g.slot(SLOT_S), s + c, B, g, nw);
    if (add)
        run_steps<D>(TPUECM_ADD, TPUECM_ADD_STEPS, g);
    else
        run_steps<D>(TPUECM_DUP, TPUECM_DUP_STEPS, g);
    if (curve < B) {
        store_slot<D>(out + c, g.slot(SLOT_X), B, g, nw);
        store_slot<D>(out + plane + c, g.slot(SLOT_Z), B, g, nw);
    }
}

template <int D>
void replay_body(const int* acc_in, int* acc_out, const int* pa_ext,
                 const int* pbx, const int* idx, TPUECM_MOD_PARAMS, int B,
                 int L) {
    __shared__ Mod m;
    replay_lanes<D>(m, smem_words, acc_in, acc_out, pa_ext, pbx, idx,
                    TPUECM_MOD_ARGS, B, L);
}

template <int D>
void replay_gather_body(const int* acc_in, int* acc_out, const int* pa_ext,
                        const int* pbx, const int* idx, const int* one,
                        int nsteps, int E, TPUECM_MOD_PARAMS, int B, int L,
                        int parow) {
    __shared__ Mod m;
    if (parow)
        replay_gather_lanes<D, RG_PAROW>(m, smem_words, acc_in, acc_out,
                                         pa_ext, pbx, idx, one, nsteps, E,
                                         TPUECM_MOD_ARGS, B, L);
    else
        replay_gather_lanes<D, RG_GATHER>(m, smem_words, acc_in, acc_out,
                                          pa_ext, pbx, idx, one, nsteps, E,
                                          TPUECM_MOD_ARGS, B, L);
}

template <int D>
void replay_resident_body(const int* acc_in, int* acc_out, const int* pa_ext,
                          const int* pbx, int pb_rows, const int* idx,
                          const int* slabs, int nslabs, int cap, int E,
                          TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    replay_resident_lanes<D>(m, smem_words, acc_in, acc_out, pa_ext, pbx,
                             pb_rows, idx, slabs, nslabs, cap, E,
                             TPUECM_MOD_ARGS, B, L);
}

template <int D>
void ed_tape_body(const int* tape, long long nsteps, int* acc,
                  const int* table, TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    ed_tape_lanes<D>(m, smem_words, tape, nsteps, acc, table,
                     TPUECM_MOD_ARGS, B, L);
}

template <int D>
void chain_body(const int* p1, const int* p2, const int* pd, int* out,
                int count, TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    chain_lanes<D>(m, smem_words, p1, p2, pd, out, count, TPUECM_MOD_ARGS, B,
                   L);
}

template <int D>
void prefix_body(const int* zs, const int* one, int* out, int count,
                 TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    prefix_lanes<D>(m, smem_words, zs, one, out, count, TPUECM_MOD_ARGS, B,
                    L);
}

template <int D>
void apply_inverse_body(const int* xs, const int* zs, const int* pres,
                        const int* total_inv, int* out, int count,
                        TPUECM_MOD_PARAMS, int B, int L) {
    __shared__ Mod m;
    apply_inverse_lanes<D>(m, smem_words, xs, zs, pres, total_inv, out,
                           count, TPUECM_MOD_ARGS, B, L);
}

// body(std::integral_constant<int, D>()) on every thread of the blocks
// that B curves at L lanes a curve take; 1 for a D with no instantiation.
template <typename F>
int run_lanes(int B, int L, int D, F&& body) {
    return with_lane_digits(D, [&](auto d) {
        const int per = TPUECM_TAPE_BLOCK / L;
        emu_launch((B + per - 1) / per, TPUECM_TAPE_BLOCK, [&] { body(d); });
        return 0;
    });
}

}  // namespace

extern "C" int lanes_mul(const int* a, const int* b, int* out, int* out2,
                         TPUECM_MOD_PARAMS, int B, int L, int D, int op) {
    return run_lanes(B, L, D, [&](auto d) {
        mul_body<decltype(d)::value>(a, b, out, out2, TPUECM_MOD_ARGS, B, L,
                                     op);
    });
}

extern "C" int lanes_point(const int* in, int* out, const int* s,
                           TPUECM_MOD_PARAMS, int B, int L, int D, int add) {
    return run_lanes(B, L, D, [&](auto d) {
        point_body<decltype(d)::value>(in, out, s, TPUECM_MOD_ARGS, B, L,
                                       add);
    });
}

extern "C" int lanes_replay(const int* acc_in, int* acc_out,
                            const int* pa_ext, const int* pbx,
                            const int* idx, TPUECM_MOD_PARAMS, int B, int L,
                            int D, int late) {
    emu_copy_late = late != 0;
    return run_lanes(B, L, D, [&](auto d) {
        replay_body<decltype(d)::value>(acc_in, acc_out, pa_ext, pbx, idx,
                                        TPUECM_MOD_ARGS, B, L);
    });
}

extern "C" int lanes_replay_gather(const int* acc_in, int* acc_out,
                                   const int* pa_ext, const int* pbx,
                                   const int* idx, const int* one,
                                   int nsteps, int E, TPUECM_MOD_PARAMS,
                                   int B, int L, int D, int parow,
                                   int late) {
    if (!step_args_ok(nsteps, E)) return 1;
    emu_copy_late = late != 0;
    return run_lanes(B, L, D, [&](auto d) {
        replay_gather_body<decltype(d)::value>(acc_in, acc_out, pa_ext, pbx,
                                               idx, one, nsteps, E,
                                               TPUECM_MOD_ARGS, B, L, parow);
    });
}

extern "C" int lanes_replay_resident(const int* acc_in, int* acc_out,
                                     const int* pa_ext, const int* pbx,
                                     int pb_rows, const int* idx,
                                     const int* slabs, int nslabs, int cap,
                                     int E, TPUECM_MOD_PARAMS, int B, int L,
                                     int D, int late) {
    if (!step_args_ok(nslabs, E) || cap < 1
        || resident_smem_bytes(L, D, cap) > sizeof smem_words)
        return 1;
    emu_copy_late = late != 0;
    return run_lanes(B, L, D, [&](auto d) {
        replay_resident_body<decltype(d)::value>(
            acc_in, acc_out, pa_ext, pbx, pb_rows, idx, slabs, nslabs, cap, E,
            TPUECM_MOD_ARGS, B, L);
    });
}

extern "C" int lanes_ed_tape(const int* tape, long long nsteps, int* acc,
                             const int* table, TPUECM_MOD_PARAMS, int B,
                             int L, int D) {
    return run_lanes(B, L, D, [&](auto d) {
        ed_tape_body<decltype(d)::value>(tape, nsteps, acc, table,
                                         TPUECM_MOD_ARGS, B, L);
    });
}

extern "C" int lanes_chain(const int* p1, const int* p2, const int* pd,
                           int* out, int count, TPUECM_MOD_PARAMS, int B,
                           int L, int D) {
    return run_lanes(B, L, D, [&](auto d) {
        chain_body<decltype(d)::value>(p1, p2, pd, out, count,
                                       TPUECM_MOD_ARGS, B, L);
    });
}

extern "C" int lanes_prefix(const int* zs, const int* one, int* out,
                            int count, TPUECM_MOD_PARAMS, int B, int L, int D,
                            int late) {
    emu_copy_late = late != 0;
    return run_lanes(B, L, D, [&](auto d) {
        prefix_body<decltype(d)::value>(zs, one, out, count, TPUECM_MOD_ARGS,
                                        B, L);
    });
}

extern "C" int lanes_apply_inverse(const int* xs, const int* zs,
                                   const int* pres, const int* total_inv,
                                   int* out, int count, TPUECM_MOD_PARAMS,
                                   int B, int L, int D, int late) {
    emu_copy_late = late != 0;
    return run_lanes(B, L, D, [&](auto d) {
        apply_inverse_body<decltype(d)::value>(xs, zs, pres, total_inv, out,
                                               count, TPUECM_MOD_ARGS, B, L);
    });
}
