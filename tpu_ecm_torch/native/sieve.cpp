// Segmented sieve of Eratosthenes — native prime stream for the driver.
// Copy of tpu_ecm/native/sieve.cpp (the port imports nothing of tpu_ecm).
//
// Native replacement for the reference's eratosthenes/ subsystem
// (reference eratosthenes/soe.c:221-301 and friends): on the TPU build
// primes are a host-side input tape, so this is a compact cache-blocked
// segmented sieve instead of 6.4 kLoC of AVX-512 line sieving.  Exposed via
// ctypes (native/lib.py) with a numpy fallback (primes/sieve.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// simple sieve for base primes < limit
std::vector<uint32_t> base_primes(uint64_t limit) {
    std::vector<uint8_t> comp(limit + 1, 0);
    std::vector<uint32_t> out;
    for (uint64_t i = 2; i <= limit; i++) {
        if (!comp[i]) {
            out.push_back((uint32_t)i);
            for (uint64_t j = i * i; j <= limit; j += i) comp[j] = 1;
        }
    }
    return out;
}

}  // namespace

extern "C" {

// Count-and-fill: writes primes in [lo, hi) into out (capacity cap) and
// returns the number found (regardless of cap; only min(count, cap) are
// written).  Caller sizes cap with a pi(x) overestimate.
uint64_t tpuecm_primes_range(uint64_t lo, uint64_t hi, uint64_t* out,
                             uint64_t cap) {
    if (hi <= 2 || hi <= lo) return 0;
    uint64_t count = 0;
    auto emit = [&](uint64_t p) {
        if (count < cap) out[count] = p;
        count++;
    };
    if (lo <= 2 && 2 < hi) emit(2);

    uint64_t root = 1;
    while ((root + 1) * (root + 1) <= hi - 1) root++;
    auto base = base_primes(root);

    const uint64_t SEG_ODDS = 1u << 20;       // 2 MiB of flags per segment
    uint64_t start = lo < 3 ? 3 : (lo | 1);
    std::vector<uint8_t> flags(SEG_ODDS);
    for (uint64_t seg_lo = start; seg_lo < hi; seg_lo += 2 * SEG_ODDS) {
        uint64_t seg_hi = seg_lo + 2 * SEG_ODDS < hi ? seg_lo + 2 * SEG_ODDS
                                                     : hi;
        uint64_t n_odds = (seg_hi - seg_lo + 1) / 2;
        std::memset(flags.data(), 1, n_odds);
        for (uint32_t p : base) {
            if (p == 2) continue;
            uint64_t pp = (uint64_t)p * p;
            if (pp >= seg_hi) break;
            uint64_t first = pp > seg_lo ? pp : ((seg_lo + p - 1) / p) * p;
            if ((first & 1) == 0) first += p;
            for (uint64_t m = first; m < seg_hi; m += 2ull * p)
                flags[(m - seg_lo) / 2] = 0;
        }
        for (uint64_t i = 0; i < n_odds; i++)
            if (flags[i]) emit(seg_lo + 2 * i);
    }
    return count;
}

}  // extern "C"
