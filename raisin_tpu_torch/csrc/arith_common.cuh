// Constants and the shared adaptive model of the arithmetic coder kernels.
//
// Wire format: raisin_tpu/formats/arithmetic_ref.py (reference
// compressor/arithmetic/arithmetic.go). A 16-bit shift-renormalizing coder
// over 257 symbols (bytes + EOF=256); the order-0 model is a 258-entry
// cumulative count table, initialised cum[i] = i, that gains +1 on every
// entry above the coded symbol after each step (EOF included) until
// cum[257] reaches MAX_FREQ.
//
// The model lives in registers (reg_model_*, below): lane l of a warp owns
// entries l, l+32, ... Kernel C searches it (reg_model_find); kernels A and
// I read a known symbol's bounds (reg_model_bounds, and once the model
// freezes reg_pairs_bounds in A). The coder's step is encode_narrow32 and
// renorm_counts, in 32 bits, with the quotients by the total taken by a
// magic number (MagicTable).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rsn {

constexpr uint32_t MAX_CODE = 0xFFFF;
constexpr uint32_t ONE_FOURTH = 0x4000;
constexpr uint32_t ONE_HALF = 0x8000;
constexpr uint32_t THREE_FOURTHS = 0xC000;
constexpr uint32_t MAX_FREQ = 16383;
constexpr uint32_t INIT_TOTAL = 257;  // cum[257] before the first step
// the steps that update the model: the total is INIT_TOTAL + t at step t, and
// the update that takes it to MAX_FREQ is the last (arithmetic.go:184-192)
constexpr int UPDATE_STEPS = MAX_FREQ - INIT_TOTAL;
constexpr int EOF_SYMBOL = 256;
constexpr int NUM_CUM = 258;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int WARPS_PER_CTA = 4;

// The register-resident model (kernels A, C and I). Lane l holds cum[l + 32 j] in
// c[j], j < MODEL_REGS; the entries past 257 hold MODEL_PAD and never
// change. A search is MODEL_REGS independent multiply-compares, two folds
// and two warp reductions, an update MODEL_REGS register adds: no shared
// memory, no barrier.
constexpr int MODEL_REGS = 9;  // ceil(NUM_CUM / 32)
constexpr uint32_t MODEL_PAD = 0xFFFF;
static_assert(MODEL_REGS * 32 >= NUM_CUM && (MODEL_REGS - 1) * 32 < NUM_CUM, "MODEL_REGS = ceil(NUM_CUM / 32)");

__device__ __forceinline__ void reg_model_init(uint32_t (&c)[MODEL_REGS], int lane) {
#pragma unroll
    for (int j = 0; j < MODEL_REGS; ++j) {
        const int i = lane + 32 * j;
        c[j] = i < NUM_CUM ? (uint32_t)i : MODEL_PAD;
    }
}

// The model after the updates whose symbols `counts` counts (counts[s] for s
// <= EOF_SYMBOL): cum[i] = i + the counts of the symbols below i, an
// exclusive prefix over the entries; each register's 32 entries are one
// shuffle scan, carried into the next register (kernel I's pass 1).
__device__ __forceinline__ void reg_model_from_counts(uint32_t (&c)[MODEL_REGS], int lane,
                                                      const uint32_t* counts) {
    uint32_t carry = 0;  // the counts of the entries below register j's
#pragma unroll
    for (int j = 0; j < MODEL_REGS; ++j) {
        const int i = lane + 32 * j;
        const uint32_t own = i <= EOF_SYMBOL ? counts[i] : 0u;
        uint32_t v = own;  // inclusive scan over the lanes
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
            const uint32_t x = __shfl_up_sync(FULL_MASK, v, off);
            v += lane >= off ? x : 0u;
        }
        c[j] = i < NUM_CUM ? (uint32_t)i + carry + v - own : MODEL_PAD;
        carry += __shfl_sync(FULL_MASK, v, 31);
    }
}

// The decoder's search: the symbol s with cum[s] <= floor(num / d) <
// cum[s + 1], for d in [2, 2^16] and num < cum[257] * d, with the bounds of
// its interval. cum[i] <= floor(num / d) is cum[i] * d <= num, so there is
// no division; every product fits 32 bits, and a pad's exceeds num. Tagged
// with its index, an entry is i << 16 | cum[i]; the table increases, so the
// largest tagged entry that passes is s << 16 | lower and the smallest that
// fails (s + 1) << 16 | upper: one warp max and one warp min. EOF's entry
// is tagged with 0 for its value as a lower bound, so EOF gives lower 0 and
// upper cum[257] = the total, which narrow the interval to itself.
__device__ __forceinline__ int reg_model_find(const uint32_t (&c)[MODEL_REGS], int lane, uint32_t d,
                                              uint32_t num, uint32_t& lower, uint32_t& upper) {
    uint32_t lo[MODEL_REGS], hi[MODEL_REGS];
#pragma unroll
    for (int j = 0; j < MODEL_REGS; ++j) {
        const int i = lane + 32 * j;
        const uint32_t tagged = ((uint32_t)i << 16) | c[j];
        const bool in = c[j] * d <= num;
        lo[j] = in ? (i == EOF_SYMBOL ? tagged & 0xFFFF0000u : tagged) : 0u;
        hi[j] = in ? 0xFFFFFFFFu : tagged;
    }
#pragma unroll
    for (int w = 1; w < MODEL_REGS; w *= 2) {
#pragma unroll
        for (int j = 0; j + w < MODEL_REGS; j += 2 * w) {
            lo[j] = max(lo[j], lo[j + w]);
            hi[j] = min(hi[j], hi[j + w]);
        }
    }
    const uint32_t below = __reduce_max_sync(FULL_MASK, lo[0]);
    const uint32_t above = __reduce_min_sync(FULL_MASK, hi[0]);
    lower = below & 0xFFFF;
    upper = above & 0xFFFF;
    return (int)(below >> 16);
}

// +1 on every entry above `sym` (the model update, arithmetic.go:184), the
// pads excepted: i > sym is the sign bit of sym - i.
__device__ __forceinline__ void reg_model_update(uint32_t (&c)[MODEL_REGS], int lane, int sym) {
#pragma unroll
    for (int j = 0; j < MODEL_REGS; ++j) {
        const int i = lane + 32 * j < NUM_CUM ? lane + 32 * j : -1;
        c[j] += (uint32_t)(sym - i) >> 31;
    }
}

// Division by a model total t in [2, MAX_FREQ] without a divide: with
// L = floor(log2(t - 1)) and m = ceil(2^(32 + L) / t), 2^31 <= m < 2^32 and
// m * t = 2^(32 + L) + e with e < t <= 2^(L + 1), so for x < 2^30,
// x * m / 2^(32 + L) = x / t + x * e / (t * 2^(32 + L)) < x / t + 1 / t:
// floor(x / t) = umulhi(x, m) >> L, exactly. MagicTable holds (m, L) for
// every t; the compiler builds it (make_magic_table is constexpr).
struct MagicTable {
    uint2 m[MAX_FREQ + 1];
};

__host__ __device__ constexpr MagicTable make_magic_table() {
    MagicTable tab{};
    uint32_t L = 0;  // floor(log2(t - 1)), kept as t grows
    for (uint32_t t = 2; t <= MAX_FREQ; ++t) {
        if ((2u << L) <= t - 1) ++L;
        tab.m[t] = uint2{(uint32_t)(((1ull << (32 + L)) + t - 1) / t), L};
    }
    return tab;
}

__device__ __forceinline__ uint32_t div_by_total(uint32_t x, uint2 magic) {  // x < 2^30
    return __umulhi(x, magic.x) >> magic.y;
}

// The encoder's model (kernels A and I). Until it freezes, C's
// layout: cum[i] for a warp-uniform i in [0, NUM_CUM) is register i >> 5 of
// lane i & 31, taken by a tree of selects on the bits of i >> 5 (depth 4,
// no local memory) and a shuffle from its owner. The encoder knows its
// symbol, so it needs no search: lower = cum[s], upper = cum[s + 1].
__device__ __forceinline__ uint32_t reg_select(const uint32_t (&c)[MODEL_REGS], int j) {
    static_assert(MODEL_REGS == 9, "the select tree covers registers 0-8");
    const uint32_t c01 = j & 1 ? c[1] : c[0], c23 = j & 1 ? c[3] : c[2];
    const uint32_t c45 = j & 1 ? c[5] : c[4], c67 = j & 1 ? c[7] : c[6];
    const uint32_t c03 = j & 2 ? c23 : c01, c47 = j & 2 ? c67 : c45;
    const uint32_t c07 = j & 4 ? c47 : c03;
    return j & 8 ? c[8] : c07;
}

__device__ __forceinline__ void reg_model_bounds(const uint32_t (&c)[MODEL_REGS], int s, uint32_t& lower,
                                                 uint32_t& upper) {
    lower = __shfl_sync(FULL_MASK, reg_select(c, s >> 5), s & 31);
    upper = __shfl_sync(FULL_MASK, reg_select(c, (s + 1) >> 5), (s + 1) & 31);
}

// Once it is frozen, each entry's successor beside it: lane l holds
// cum[i] | cum[i + 1] << 16 in p[j], i = l + 32 j, so one select and one
// shuffle give both bounds. The entries stay below MAX_FREQ < 2^16, so the
// halves never mix; the words past i = 256 are never read.
__device__ __forceinline__ void reg_pairs_from_model(const uint32_t (&c)[MODEL_REGS], int lane,
                                                     uint32_t (&p)[MODEL_REGS]) {
#pragma unroll
    for (int j = 0; j < MODEL_REGS; ++j) {
        const uint32_t right = __shfl_sync(FULL_MASK, c[j], (lane + 1) & 31);        // cum[i + 1], lane < 31
        const uint32_t wrap = __shfl_sync(FULL_MASK, j + 1 < MODEL_REGS ? c[j + 1] : 0u, 0);  // lane 31's
        p[j] = c[j] | (lane == 31 ? wrap : right) << 16;
    }
}

__device__ __forceinline__ void reg_pairs_bounds(const uint32_t (&p)[MODEL_REGS], int s, uint32_t& lower,
                                                 uint32_t& upper) {
    const uint32_t v = __shfl_sync(FULL_MASK, reg_select(p, s >> 5), s & 31);
    lower = v & 0xFFFF;
    upper = v >> 16;
}

// The symbol's share of the range d = high - low + 1: q_lo = floor(d *
// lower / total) and q_hi = floor(d * upper / total), so that the interval
// narrows to [low + q_lo, low + q_hi - 1]. d <= 2^16 and upper <= total <
// 2^14 keep both dividends below 2^30, so the quotients are div_by_total's;
// they do not depend on each other, nor on low.
__device__ __forceinline__ void encode_narrow32(uint32_t d, uint32_t lower, uint32_t upper, uint2 magic,
                                                uint32_t& q_lo, uint32_t& q_hi) {
    q_lo = div_by_total(d * lower, magic);
    q_hi = div_by_total(d * upper, magic);
}

// The renormalisation of [nl, nh] in closed form: k E1/E2 shifts, one per
// leading bit that nl and nh share (16 when they are equal), then m E3
// shifts, one per following bit where nl has 1 and nh 0 (an E3 shift leaves
// the interval straddling the half, so no E1/E2 shift follows it). Each E3
// shift flips bit 15 of what it shifts in, and the next shifts that bit out,
// so m > 0 flips bit 15 once. Gives the new low and d = (nh - nl + 1) << (k + m).
__device__ __forceinline__ void renorm_counts(uint32_t nl, uint32_t nh, int& k, int& m, uint32_t& low,
                                              uint32_t& d) {
    k = __clz(nl ^ nh) - 16;
    m = __clz(~__funnelshift_lc(0u, nl & ~nh, k + 17));
    const int s = k + m;
    low = ((nl << s) & MAX_CODE) ^ (m ? ONE_HALF : 0u);
    d = (nh - nl + 1) << s;
}

}  // namespace rsn
