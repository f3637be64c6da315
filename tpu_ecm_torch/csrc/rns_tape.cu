// K10, stage 1 of the RNS engine: replay an (op, dst, a, b, c) DUP/ADD/NOP
// tape over the [6, 2, 2K+1, B] residue register file, in place.
//
// Replaces tpu_ecm/limbs/rns_exec.py:_rns_tape_kernel (via
// make_rns_tape_executor), whose grid-less call kept the register file in
// VMEM for a 4096-step chunk and ran both base extensions of every product
// as bf16 matmuls on the MXU.
//
// Bound on the H100: the two extension dots of each product, K x (K+1)
// multiply-adds each per curve (80,400 at K=200), 5 (DUP) or 6 (ADD)
// dependent products per tape op.  As exact u8 splits they are four int8
// tensor-core products a dot; the channel work beside them (about 60
// integer instructions per channel pair) runs on the int32 pipes.  Point
// traffic (8 planes of (2K+1)*4 bytes per curve and op) stays in L2: the
// file is 19.7 MB at K=200, B=1024.
//
// Design (csrc/rns_mma.cuh): one block per tile of T curves, all 2K+1
// channels of them, for the whole tape slice.  T = 8 at K <= 222, where the
// split u8 weight planes (186 KB at K=200) sit in shared memory, copied
// once per block: 128 blocks for the rns job's 1024 curves on 132 SMs, one
// block an SM, 14 warps (448 threads) at K=200.  Past K=222, T = 4 and the
// fragments load from the global table.  Both dots run on the tensor cores
// (nvcuda::wmma, u8 m32n8k16), two warps a 32-row tile; every channel
// reduction is a multiply-high one (no `%` by a runtime modulus); each
// thread holds its channel pair of four curves of every value of a tape op
// in registers, and a warp moves whole 32-byte rows of a plane.  Every
// thread walks the same tape entry (a uniform load, the same barriers).
// Inputs are read before dst is written, and each thread writes only the
// elements it read, so dst may alias any input.
#include "rns_mma.cuh"

// Duplicate; s is the curve constant's plane.  xo, zo may alias x, z.
template <int T>
__device__ __forceinline__ void mma_xdbl(MV& xo, MV& zo, const MV& x,
                                         const MV& z, const int* s,
                                         const MmaCtx& L) {
    MV sp, dm, u, v;
    mma_add(sp, x, z, L);
    mma_sub(dm, x, z, L);
    mma_mul<T>(v, dm, dm, L);
    mma_mul<T>(u, sp, sp, L);
    mma_mul<T>(xo, u, v, L);
    mma_sub(dm, u, v, L);                      // dm := W = U - V
    load_mv(sp, s, L);
    mma_mul<T>(sp, dm, sp, L);                 // sp := s*W
    mma_add(sp, sp, v, L);
    mma_mul<T>(zo, sp, dm, L);
}

// The differential add P1 + P2 with difference Pd (planes pd, pd +
// coord): t1 = (U+V)^2 * Zd, t2 = (U-V)^2 * Xd.  Pd is loaded after the
// squares, which keeps fewer values live.
template <int T>
__device__ __forceinline__ void mma_xadd(MV& xo, MV& zo, const MV& x1,
                                         const MV& z1, const MV& x2,
                                         const MV& z2, const int* pd,
                                         size_t coord, const MmaCtx& L) {
    MV s1, d1, s2, d2;
    mma_add(s1, x1, z1, L);
    mma_sub(d1, x1, z1, L);
    mma_add(s2, x2, z2, L);
    mma_sub(d2, x2, z2, L);
    mma_mul<T>(d1, d1, s2, L);                 // d1 := U
    mma_mul<T>(s1, s1, d2, L);                 // s1 := V
    mma_add(s2, d1, s1, L);
    mma_sub(d2, d1, s1, L);
    mma_mul<T>(s2, s2, s2, L);                 // t1
    mma_mul<T>(d2, d2, d2, L);                 // t2
    load_mv(d1, pd + coord, L);                // Zd
    load_mv(s1, pd, L);                        // Xd
    mma_mul<T>(xo, s2, d1, L);
    mma_mul<T>(zo, d2, s1, L);
}

// The kernel body on one block (smem: rns_mma_bytes(K, T == 8, 1) bytes).
template <int T>
__device__ void rns_tape_body(unsigned char* smem, const int* tape,
                              long long nsteps, int* pts, const int* s_const,
                              const int* tab, const unsigned char* wmma,
                              int K, int B) {
    MmaCtx L;
    mma_setup<T>(L, smem, tab, wmma, K, B);
    const size_t coord = (size_t)(2 * K + 1) * B;   // X -> Z within a point
    const size_t slot = 2 * coord;                  // point -> point
    for (long long k = 0; k < nsteps; ++k) {
        const int* e = tape + 5 * k;
        const int op = e[0], dst = e[1];
        const int* pa = pts + e[2] * slot;
        MV ax, az, ox, oz;
        load_mv(ax, pa, L);
        load_mv(az, pa + coord, L);
        if (op == 0) {                                  // DUP
            mma_xdbl<T>(ox, oz, ax, az, s_const, L);
        } else if (op == 1) {                           // ADD
            const int* pb = pts + e[3] * slot;
            MV bx, bz;
            load_mv(bx, pb, L);
            load_mv(bz, pb + coord, L);
            mma_xadd<T>(ox, oz, ax, az, bx, bz, pts + e[4] * slot, coord,
                        L);
        } else {                                        // NOP: dst := pts[a]
            ox = ax;
            oz = az;
        }
        store_mv(pts + dst * slot, ox, L);
        store_mv(pts + dst * slot + coord, oz, L);
    }
}

#ifdef __CUDACC__
template <int T>
__global__ void __launch_bounds__(rns_tape_max_threads(T))
rns_tape_kernel(const int* __restrict__ tape, long long nsteps, int* pts,
                const int* __restrict__ s_const, const int* __restrict__ tab,
                const unsigned char* __restrict__ wmma, int K, int B) {
    extern __shared__ __align__(128) unsigned char rns_mma_smem[];
    rns_tape_body<T>(rns_mma_smem, tape, nsteps, pts, s_const, tab, wmma, K,
                     B);
}

template <int T>
static int launch_tape(const RnsMmaLaunch& c, const int* tape,
                       long long nsteps, int* pts, const int* s_const,
                       const int* tab, const unsigned char* wmma, int K,
                       int B, cudaStream_t stream) {
    if (c.smem > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            rns_tape_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)c.smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    rns_tape_kernel<T><<<c.blocks, c.threads, c.smem, stream>>>(
        tape, nsteps, pts, s_const, tab, wmma, K, B);
    return (int)cudaGetLastError();
}

extern "C" int tpuecm_rns_tape(const int* tape, long long nsteps, int* pts,
                               const int* s_const, const int* tab,
                               const unsigned char* wmma, int K, int B,
                               int tile, void* stream) {
    RnsMmaLaunch c;
    const int rc = rns_tape_config(K, B, tile, c);
    if (rc != (int)cudaSuccess) return rc;
    return c.tile == 8
        ? launch_tape<8>(c, tape, nsteps, pts, s_const, tab, wmma, K, B,
                         (cudaStream_t)stream)
        : launch_tape<4>(c, tape, nsteps, pts, s_const, tab, wmma, K, B,
                         (cudaStream_t)stream);
}
#endif

// K10's geometry at K, B and `tile` (0: its own) into out[5]: {tile,
// threads, blocks, smem bytes, resident}, as rns_kernels.tape_geometry
// reads it; cudaErrorInvalidValue where rns_tape_config refuses
extern "C" int tpuecm_rns_tape_geometry(int K, int B, int tile,
                                        long long* out) {
    RnsMmaLaunch c;
    const int rc = rns_tape_config(K, B, tile, c);
    if (rc == (int)cudaSuccess) rns_mma_geometry(c, false, out);
    return rc;
}
