// A CPU stand-in for the part of the CUDA runtime that
// tpu_ecm_torch/csrc/arith_lanes.cuh and rns_mma.cuh use, so that their
// device code builds with g++ (-std=c++20) and runs on the CPU
// (tools/lane_shim/check.py; mma.h beside this file stands in for wmma).
//
// A launch runs its blocks in turn, each with one std::thread per CUDA
// thread.  __syncthreads is a barrier of the block, __syncwarp one of the
// warp, and __shfl_sync writes the value to a per-warp buffer between two
// warp barriers and reads the source lane's.  __shared__ becomes static, so
// a block's threads share it.  Not thread-safe across launches.
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(n) alignas(n)

struct alignas(8) uint2 {
    unsigned x, y;
};
struct alignas(16) uint4 {
    unsigned x, y, z, w;
};
struct alignas(16) int4 {
    int x, y, z, w;
};

inline unsigned __umulhi(unsigned a, unsigned b) {
    return (unsigned)(((unsigned long long)a * b) >> 32);
}

struct dim3 {
    unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

struct EmuBlock {
    std::unique_ptr<std::barrier<>> block;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    int shfl[1024];
};
inline EmuBlock* emu_block;

inline void __syncthreads() { emu_block->block->arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) {
    emu_block->warps[threadIdx.x / 32]->arrive_and_wait();
}

inline int __shfl_sync(unsigned, int v, int src, int width) {
    const int t = threadIdx.x;
    __syncwarp();
    emu_block->shfl[t] = v;
    __syncwarp();
    const int r = emu_block->shfl[(t / width) * width + src];
    __syncwarp();
    return r;
}

inline unsigned __shfl_sync(unsigned mask, unsigned v, int src, int width) {
    return (unsigned)__shfl_sync(mask, (int)v, src, width);
}

// body() once per thread of each of `blocks` blocks of `threads` threads
// (a multiple of 32).
inline void emu_launch(int blocks, int threads,
                       const std::function<void()>& body) {
    blockDim.x = threads;
    for (int b = 0; b < blocks; ++b) {
        blockIdx.x = b;
        EmuBlock eb;
        eb.block = std::make_unique<std::barrier<>>(threads);
        for (int w = 0; w < threads / 32; ++w)
            eb.warps.push_back(std::make_unique<std::barrier<>>(32));
        emu_block = &eb;
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
            ts.emplace_back([&body, t] {
                threadIdx.x = t;
                body();
            });
        for (auto& t : ts) t.join();
    }
}
