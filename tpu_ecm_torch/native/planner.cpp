// Host planners in C++: PRAC stage-1 tape emission and the stage-2 PAIR
// (copy of tpu_ecm/native/planner.cpp; the port imports nothing of tpu_ecm)
// algorithm.  These are the serial, control-flow-heavy host components of
// the framework (the TPU replays their output as data), ported from the
// Python planners (curve/prac.py, stage2/plan.py) which
// re-derive reference ecm.c:565-884 (prac) and :2559-2910 (pair).
// Bit-for-bit identical output to the Python planners (same IEEE-double
// cost function, same queue discipline) — tested in tests/test_native.py and
// tests/test_torch_host.py.

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr double kAdd = 5.5;
constexpr double kDup = 4.5;
constexpr int kNumSlots = 6;
constexpr int32_t OP_DUP = 0;
constexpr int32_t OP_ADD = 1;

const double kVal[10] = {
    0.61803398874989485, 0.72360679774997897, 0.58017872829546410,
    0.63283980608870629, 0.61242994950949500, 0.62018198080741576,
    0.61721461653440386, 0.61834711965622806, 0.61791440652881789,
    0.61807966846989581};

double lucas_cost(uint64_t n, double v) {
    uint64_t d = n;
    uint64_t r = (uint64_t)((double)d * v + 0.5);
    if (r >= n) return kAdd * (double)n;
    d = n - r;
    uint64_t e = 2 * r - n;
    double c = kDup + kAdd;
    while (d != e) {
        if (d < e) { uint64_t t = d; d = e; e = t; }
        if ((d + 3) / 4 <= e) {
            d -= e;
            c += kAdd;
        } else if ((d + e) % 2 == 0) {
            d = (d - e) / 2;
            c += kAdd + kDup;
        } else if (d % 2 == 0) {
            d /= 2;
            c += kAdd + kDup;
        } else {
            e /= 2;
            c += kAdd + kDup;
        }
    }
    if (d != 1) return 999999999.0;
    return c;
}

double best_ratio(uint64_t n) {
    double cmin = kAdd * (double)n;
    int besti = 0;
    for (int i = 0; i < 10; i++) {
        double c = lucas_cost(n, kVal[i]);
        if (c < cmin) { cmin = c; besti = i; }
    }
    return kVal[besti];
}

// virtual {A,B,C,T} -> physical slot renaming (mirror of prac.py _RegFile)
struct RegFile {
    // indices: 0=A, 1=B, 2=C, 3=T;  -1 = unset
    int v2p[4];
    RegFile() { v2p[0] = -1; v2p[1] = 0; v2p[2] = 0; v2p[3] = -1; }
    int slot(int v) const { return v2p[v]; }
    int free_slot() const {
        bool used[kNumSlots] = {false};
        for (int i = 0; i < 4; i++)
            if (v2p[i] >= 0) used[v2p[i]] = true;
        for (int s = 1; s < kNumSlots; s++)
            if (!used[s]) return s;
        return -1;
    }
    int write_target(int v) {
        int cur = v2p[v];
        int shared = 0;
        for (int i = 0; i < 4; i++)
            if (v2p[i] == cur) shared++;
        if (cur < 0 || cur == 0 || shared > 1) cur = free_slot();
        v2p[v] = cur;
        return cur;
    }
};

struct TapeOut {
    int32_t* buf;
    uint64_t cap;
    uint64_t count;
    void emit(int32_t op, int32_t dst, int32_t a, int32_t b, int32_t c) {
        if (count < cap) {
            int32_t* e = buf + 5 * count;
            e[0] = op; e[1] = dst; e[2] = a; e[3] = b; e[4] = c;
        }
        count++;
    }
};

void prac_tape(uint64_t p, TapeOut& out) {
    enum { A = 0, B = 1, C = 2, T = 3 };
    double v = best_ratio(p);
    uint64_t r = (uint64_t)((double)p * v + 0.5);
    uint64_t d = p - r;
    uint64_t e = 2 * r - p;
    RegFile rf;
    out.emit(OP_DUP, rf.write_target(A), 0, 0, 0);
    while (d != e) {
        if (d < e) {
            uint64_t t = d; d = e; e = t;
            int tmp = rf.v2p[A]; rf.v2p[A] = rf.v2p[B]; rf.v2p[B] = tmp;
        }
        if ((d + 3) / 4 <= e) {             // condition 3
            d -= e;
            int sb = rf.slot(B), sa = rf.slot(A), sc = rf.slot(C);
            int dst = rf.write_target(T);
            out.emit(OP_ADD, dst, sb, sa, sc);
            // rotate (B,T,C) <- (T,C,B)
            int ob = rf.v2p[B], ot = rf.v2p[T], oc = rf.v2p[C];
            rf.v2p[B] = ot; rf.v2p[T] = oc; rf.v2p[C] = ob;
        } else if ((d + e) % 2 == 0) {      // condition 4
            d = (d - e) / 2;
            int sb = rf.slot(B), sa = rf.slot(A), sc = rf.slot(C);
            out.emit(OP_ADD, rf.write_target(B), sb, sa, sc);
            out.emit(OP_DUP, rf.write_target(A), sa, 0, 0);
        } else if (d % 2 == 0) {            // condition 5
            d /= 2;
            int sc = rf.slot(C), sa = rf.slot(A), sb = rf.slot(B);
            out.emit(OP_ADD, rf.write_target(C), sc, sa, sb);
            out.emit(OP_DUP, rf.write_target(A), sa, 0, 0);
        } else {                            // condition 9
            e /= 2;
            int sc = rf.slot(C), sb = rf.slot(B), sa = rf.slot(A);
            out.emit(OP_ADD, rf.write_target(C), sc, sb, sa);
            out.emit(OP_DUP, rf.write_target(B), sb, 0, 0);
        }
    }
    out.emit(OP_ADD, 0, rf.slot(A), rf.slot(B), rf.slot(C));
}

uint64_t spgcd(uint64_t a, uint64_t b) {
    while (b) { uint64_t t = a % b; a = b; b = t; }
    return a;
}

}  // namespace

extern "C" {

// Stage-1 tape: leading 2^k doublings (if include_two) then PRAC chains with
// the prime-power rule (do {prac} while c*q < b1).  Returns entry count
// (entries written only up to cap).
uint64_t tpuecm_stage1_tape(const uint64_t* primes, uint64_t nprimes,
                            uint64_t b1, int include_two, int32_t* out,
                            uint64_t cap) {
    TapeOut t{out, cap, 0};
    if (include_two) {
        for (uint64_t q = 2; q < b1; q *= 2) t.emit(OP_DUP, 0, 0, 0, 0);
    }
    for (uint64_t i = 0; i < nprimes; i++) {
        uint64_t q = primes[i];
        if (q == 2 || q >= b1) continue;
        uint64_t c = 1;
        for (;;) {
            prac_tape(q, t);
            c *= q;
            if (c * q >= b1) break;
        }
    }
    return t.count;
}

// Stage-2 PAIR planner (mirror of stage2/plan.py pair()).
// Outputs (v, u) uint32 pairs ((0,0) = window-shift sentinel); returns the
// entry count.  amin_out receives the executor's starting window index.
uint64_t tpuecm_pair(const uint64_t* primes, uint64_t nprimes,
                     uint64_t b1, uint64_t b2, uint32_t D, uint32_t U,
                     uint32_t* out_v, uint32_t* out_u, uint64_t cap,
                     uint32_t* amin_out) {
    const int64_t w = D;
    const uint32_t L = 2 * U;
    const int64_t umax = (int64_t)U * w;
    uint64_t amin = (b1 + w) / (2 * w);
    if (amin_out) *amin_out = (uint32_t)amin;

    // queue index maps over residues coprime to 2D
    std::vector<int32_t> qmap(2 * D, -1);
    std::vector<uint32_t> qrmap;
    for (uint32_t k = 0; k < 2 * D; k++) {
        if (spgcd(k, 2 * D) == 1) {
            qmap[k] = (int32_t)qrmap.size();
            qrmap.push_back(k);
        }
    }
    const size_t R = qrmap.size();
    std::vector<std::deque<uint64_t>> queues(R);

    uint64_t mapid = 0;
    auto emit = [&](uint32_t v, uint32_t u) {
        if (mapid < cap) { out_v[mapid] = v; out_u[mapid] = u; }
        mapid++;
    };

    auto flush_stale = [&](uint64_t oldmin, uint64_t newmin) {
        for (size_t qi = 0; qi < R; qi++) {
            uint32_t r = qrmap[qi];
            uint32_t q = r > w ? (uint32_t)(2 * w - r) : r;
            std::deque<uint64_t> keep;
            while (!queues[qi].empty()) {
                uint64_t ap = queues[qi].front();
                queues[qi].pop_front();
                if (ap < newmin)
                    emit((uint32_t)(2 * ap - oldmin), q);
                else
                    keep.push_back(ap);
            }
            queues[qi] = std::move(keep);
        }
    };

    for (uint64_t i = 0; i < nprimes; i++) {
        uint64_t s = primes[i];
        if (s < b1) continue;
        if (s >= b2) break;
        uint64_t a = (s + w) / (2 * w);

        while (a >= amin + L) {
            uint64_t oldmin = amin;
            amin = amin + L - U;
            flush_stale(oldmin, amin);
            emit(0, 0);
        }

        int64_t q = (int64_t)s - 2 * (int64_t)a * w;   // in (-w, w)
        int64_t mq = q < 0 ? -q : 2 * w - q;

        for (;;) {
            int32_t qi = qmap[mq];
            if (!queues[qi].empty()) {
                uint64_t ap = queues[qi].front();
                queues[qi].pop_front();
                int64_t u = w * (int64_t)(a - ap) + q;
                if (u > umax) {
                    uint32_t qq = q < 0 ? (uint32_t)(-q)
                                        : (q >= w ? (uint32_t)(2 * w - q)
                                                  : (uint32_t)q);
                    emit((uint32_t)(2 * ap - amin), qq);
                    continue;   // retry pairing s
                }
                emit((uint32_t)(a + ap - amin), (uint32_t)u);
                break;
            } else {
                int64_t res = q < 0 ? 2 * w + q : q;
                queues[qmap[res]].push_back(a);
                break;
            }
        }
    }

    for (size_t qi = 0; qi < R; qi++) {
        uint32_t r = qrmap[qi];
        uint32_t q = r > w ? (uint32_t)(2 * w - r) : r;
        while (!queues[qi].empty()) {
            uint64_t ap = queues[qi].front();
            queues[qi].pop_front();
            emit((uint32_t)(2 * ap - amin), q);
        }
    }
    return mapid;
}

}  // extern "C"
