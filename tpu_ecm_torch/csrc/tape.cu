// K1, stage 1: replay an (op, dst, a, b, c) DUP/ADD/NOP tape over the
// [6, 2, NW, B] point register file, in place.
//
// Replaces tpu_ecm/limbs/pallas_ops.py:_tape_kernel (via
// make_tape_executor), whose grid-less call kept the register file in VMEM
// for an 8192-step chunk.
//
// Bound on the H100: integer multiply-adds.  A tape step is 5 (DUP) or 6
// (ADD) dependent modular products of ~2*nw^2 (REDC) or ~nw^2 (fold)
// multiply-adds each, against about 6*nw*4 bytes of point traffic per
// curve that stays in L2 (the file is 6*2*nw*B*4 bytes, 3.5 MB at the
// flagship, 11.6 MB at M1277).
//
// Design (csrc/arith_lanes.cuh): a group of L lanes works on one curve,
// each lane owning D = ceil(nw / L) digits of every value, its products'
// columns and digits in registers; D is a template parameter, so nothing
// is indexed at run time and nothing lives in local memory.  The values of
// a step sit in the curve's slots of shared memory, and a step is a
// program of paired products, sums and differences on them, so the kernel
// holds one copy of the product.  The host (limbs/kernels.py:
// tape_geometry) picks L from nw: L = 8 at nw = 36, so 2048 curves make
// 512 warps in 128 blocks; L = 16 at nw = 118.  A block is
// TPUECM_TAPE_BLOCK threads, 128/L curves.  Measured on the H100 (PERF.md,
// tools/k1_probe), each warp is bound by its own rate of integer
// multiply-adds, most of them REDC's quotient chain and its q*n terms,
// which run in blocks of D columns.  The point file stays in device
// memory.
//
// Every thread walks the same tape entry (a uniform load, no divergence);
// the tape length is a run-time value, so no NOP padding is needed.  A lane
// past the batch computes on the last curve and stores nothing, so every
// lane reaches every shuffle and barrier.  Each lane reads and writes only
// its own digits of its curve in the file, and reads the inputs before it
// writes dst, so dst may alias any input.
#include "arith_lanes.cuh"

template <int D>
__global__ void __launch_bounds__(TPUECM_TAPE_BLOCK, 1)
tape_lanes_kernel(const int* __restrict__ tape, long long nsteps, int* pts,
                  const int* __restrict__ s_const, TPUECM_MOD_PARAMS, int B,
                  int L) {
    __shared__ Mod m;
    extern __shared__ int smem[];
    load_mod(m, TPUECM_MOD_ARGS);
    const Group g = make_group<D>(smem, L, m);
    const int curve = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
    const bool live = curve < B;

    const size_t sB = (size_t)B;
    const size_t coord = (size_t)nw * sB;     // X -> Z within a point
    const size_t slot = 2 * coord;            // point -> point
    int* file = pts + (live ? curve : B - 1);
    load_slot<D>(g.slot(SLOT_S), s_const + (live ? curve : B - 1), sB, g,
                 nw);

    for (long long k = 0; k < nsteps; ++k) {
        const int* e = tape + 5 * k;
        const int op = e[0], dst = e[1];
        const int* pa = file + e[2] * slot;
        load_slot<D>(g.slot(SLOT_X), pa, sB, g, nw);
        load_slot<D>(g.slot(SLOT_Z), pa + coord, sB, g, nw);
        if (op == 1) {                        // ADD: P2 and the difference
            const int* pb = file + e[3] * slot;
            const int* pd = file + e[4] * slot;
            load_slot<D>(g.slot(SLOT_X2), pb, sB, g, nw);
            load_slot<D>(g.slot(SLOT_Z2), pb + coord, sB, g, nw);
            load_slot<D>(g.slot(SLOT_XD), pd, sB, g, nw);
            load_slot<D>(g.slot(SLOT_ZD), pd + coord, sB, g, nw);
        }
        // one call site, so the kernel holds one copy of the product;
        // NOP (dst := pts[a]) runs no step
        run_steps<D>(op == 0 ? TPUECM_DUP : TPUECM_ADD,
                     op == 0 ? TPUECM_DUP_STEPS
                             : (op == 1 ? TPUECM_ADD_STEPS : 0), g);
        if (live) {
            store_slot<D>(file + dst * slot, g.slot(SLOT_X), sB, g, nw);
            store_slot<D>(file + dst * slot + coord, g.slot(SLOT_Z), sB, g,
                          nw);
        }
    }
}

extern "C" int tpuecm_tape(const int* tape, long long nsteps, int* pts,
                           const int* s_const, TPUECM_MOD_PARAMS, int B,
                           int lanes, int digits, void* stream) {
    if (!lanes_args_ok(nw, e, cl, w, B, lanes, digits))
        return (int)cudaErrorInvalidValue;
    return with_lane_digits(digits, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return launch_lanes<D>(tape_lanes_kernel<D>, lanes, B,
                               (cudaStream_t)stream, tape, nsteps, pts,
                               s_const, TPUECM_MOD_ARGS, B, lanes);
    });
}

TPUECM_LANES_OCCUPANCY(tpuecm_tape_occupancy, tape_lanes_kernel)

// Make `device` the current device of this library's CUDA runtime in the
// calling thread: the wrappers launch every kernel on the device that
// holds its tensors, whichever device was current (limbs/kernels.py,
// on_device).
extern "C" int tpuecm_set_device(int device) {
    return (int)cudaSetDevice(device);
}
