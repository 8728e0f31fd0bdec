// Constants and the shared adaptive model of the arithmetic coder kernels.
//
// Wire format: raisin_tpu/formats/arithmetic_ref.py (reference
// compressor/arithmetic/arithmetic.go). A 16-bit shift-renormalizing coder
// over 257 symbols (bytes + EOF=256); the order-0 model is a 258-entry
// cumulative count table, initialised cum[i] = i, that gains +1 on every
// entry above the coded symbol after each step (EOF included) until
// cum[257] reaches MAX_FREQ.
//
// One warp codes one block; lane l owns entries l, l+32, ... of the table.
// The encoders (kernels A and I) keep it in shared memory, so the update
// touches 32 consecutive words per instruction: one per bank, no
// conflicts; their scalar coder state is replicated in every lane (all
// lanes read the same table words, which shared memory broadcasts), and
// lane 0 alone stores. The decoder (kernel C) keeps it in registers
// (reg_model_*, below).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rsn {

constexpr uint32_t MAX_CODE = 0xFFFF;
constexpr uint32_t ONE_FOURTH = 0x4000;
constexpr uint32_t ONE_HALF = 0x8000;
constexpr uint32_t THREE_FOURTHS = 0xC000;
constexpr uint32_t MAX_FREQ = 16383;
constexpr int EOF_SYMBOL = 256;
constexpr int NUM_CUM = 258;
constexpr int CUM_STRIDE = 260;  // per-warp table, padded to a 16-byte multiple
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int WARPS_PER_CTA = 4;

// cum[i] = i for the lanes' entries.
__device__ __forceinline__ void model_init(uint32_t* cum, int lane) {
    for (int i = lane; i < NUM_CUM; i += 32) cum[i] = i;
    __syncwarp();
}

// +1 on every entry above `sym` (the model update, arithmetic.go:184).
// Callers read the entries they need before this and see the update after.
__device__ __forceinline__ void model_update(uint32_t* cum, int lane, int sym) {
    __syncwarp();
    for (int i = lane; i < NUM_CUM; i += 32) {
        if (i > sym) cum[i] += 1;
    }
    __syncwarp();
}

// One encoder step up to the renormalisation, shared by kernels A and I:
// the model is read before it is updated (EOF updates it too), the freeze
// comes after the triggering update (arithmetic.go:184-192), and the
// interval narrows to the symbol's share (diff * upper < 2^31).
__device__ __forceinline__ void encode_narrow(uint32_t* cum, int lane, int s, uint32_t& low,
                                              uint32_t& high, uint32_t& count, bool& frozen) {
    const uint32_t lower = cum[s];
    const uint32_t upper = cum[s + 1];
    const uint32_t total = count;
    if (!frozen) {
        model_update(cum, lane, s);
        count += 1;
        frozen = count >= MAX_FREQ;
    }
    const uint32_t diff = high - low + 1;
    high = low + diff * upper / total - 1;
    low = low + diff * lower / total;
}

// The register-resident model (kernel C). Lane l holds cum[l + 32 j] in
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

}  // namespace rsn
