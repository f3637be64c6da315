// A CPU stand-in for the cp.async primitives of the CUDA toolkit's
// cuda_pipeline_primitives.h that tpu_ecm_torch/csrc/arith_lanes.cuh's
// copy_slot_async uses (K3, K4 and K5; see cuda_runtime.h beside this
// file).
//
// A copy lands either at once (emu_copy_late false) or at the
// __pipeline_wait_prior that covers its group (true): the two ends of the
// window in which the card may land it, so that a slot read before its
// wait, or written by a copy before its last read, shows in one of them.
#pragma once
#include <cstddef>
#include <cstring>
#include <vector>

struct EmuCopy {
    void* dst;
    const void* src;
    size_t bytes;
};
inline bool emu_copy_late = false;
inline thread_local std::vector<EmuCopy> emu_open;
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes,
                                    size_t = 0) {
    if (emu_copy_late)
        emu_open.push_back({dst, src, bytes});
    else
        std::memcpy(dst, src, bytes);
}

inline void __pipeline_commit() {
    emu_groups.push_back(std::move(emu_open));
    emu_open.clear();
}

inline void __pipeline_wait_prior(size_t pending) {
    while (emu_groups.size() > pending) {
        for (const EmuCopy& c : emu_groups.front())
            std::memcpy(c.dst, c.src, c.bytes);
        emu_groups.erase(emu_groups.begin());
    }
}
