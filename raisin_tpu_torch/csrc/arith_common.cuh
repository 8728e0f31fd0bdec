// Constants and the shared adaptive model of the arithmetic coder kernels.
//
// Wire format: raisin_tpu/formats/arithmetic_ref.py (reference
// compressor/arithmetic/arithmetic.go). A 16-bit shift-renormalizing coder
// over 257 symbols (bytes + EOF=256); the order-0 model is a 258-entry
// cumulative count table, initialised cum[i] = i, that gains +1 on every
// entry above the coded symbol after each step (EOF included) until
// cum[257] reaches MAX_FREQ.
//
// One warp codes one block. The warp keeps its block's table in shared
// memory; lane l owns entries l, l+32, ..., so the update and the decoder's
// search touch 32 consecutive words per instruction: one per bank, no
// conflicts. The scalar coder state is replicated in every lane (all lanes
// read the same table words, which shared memory broadcasts), and lane 0
// alone stores.
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

}  // namespace rsn
