// Kernel E: greedy LZSS commit and ASCII token emission, one warp per block.
//
// Replaces raisin_tpu/ops/lzss_commit_pallas.py:_commit_kernel (via
// commit_emit_words). The walk is the reference's (lzss.go:134-151): at
// position i with match (L, D), L <= 1 is one literal; otherwise the token
// "<D,L>" is written when strictly shorter than L, else the L matched bytes
// are copied, and L positions are consumed either way. D and L take up to 5
// digits (windows above 9999), so a token is at most 13 bytes; the TPU
// kernel packed 4.
//
// What bounds it: the chain of commits is sequential, so each step's
// latency. The warp takes 32 positions at a time: one coalesced load of
// their L, a ballot finds the first match (L > 1), and the literal run
// before it (computed here, not in a side table as on the TPU) is copied by
// the lanes together; a token's bytes are written by one lane each, a raw
// copy 32 bytes a step. So a step costs one dependent load round trip per
// match or per 32 literals, not per byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int WARPS = 4;

__device__ __forceinline__ int ndigits(int v) {
    return 1 + (v >= 10) + (v >= 100) + (v >= 1000) + (v >= 10000);
}

// ASCII digit p (0 = most significant) of the nd-digit decimal v.
__device__ __forceinline__ uint8_t digit_at(int v, int p, int nd) {
    int q = v;
    for (int k = nd - 1 - p; k > 0; --k) q /= 10;
    return (uint8_t)('0' + q % 10);
}

// Byte k of the token "<D,L>" (nd_d and nd_l digits).
__device__ __forceinline__ uint8_t token_byte(int k, int D, int L, int nd_d, int nd_l) {
    if (k == 0) return '<';
    if (k <= nd_d) return digit_at(D, k - 1, nd_d);
    if (k == nd_d + 1) return ',';
    if (k <= nd_d + 1 + nd_l) return digit_at(L, k - nd_d - 2, nd_l);
    return '>';
}

__global__ void __launch_bounds__(WARPS * 32)
lzss_commit_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ Lm,
                   const int32_t* __restrict__ Dm, const int32_t* __restrict__ lengths,
                   uint8_t* __restrict__ tok, int32_t* __restrict__ tok_len, int B, int S) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;
    const int n = min(max(lengths[b], 0), S);
    const size_t row = (size_t)b * S;
    const uint8_t* xr = x + row;
    const int32_t* Lr = Lm + row;
    const int32_t* Dr = Dm + row;
    uint8_t* out = tok + row;

    int i = 0, o = 0;
    while (i < n) {
        const int p = i + lane;
        const int l = p < n ? Lr[p] : 0;
        const unsigned match = __ballot_sync(FULL_MASK, l > 1);
        const int run = match ? __ffs(match) - 1 : min(32, n - i);
        if (lane < run) out[o + lane] = xr[i + lane];  // literals
        i += run;
        o += run;
        if (!match) continue;
        const int L = min(__shfl_sync(FULL_MASK, l, run), n - i);
        const int D = Dr[i];
        const int nd_d = ndigits(D), nd_l = ndigits(L);
        const int tl = 3 + nd_d + nd_l;
        if (tl < L) {
            if (lane < tl) out[o + lane] = token_byte(lane, D, L, nd_d, nd_l);
            o += tl;
        } else {
            for (int k = lane; k < L; k += 32) out[o + k] = xr[i + k];
            o += L;
        }
        i += L;
    }
    if (lane == 0) tok_len[b] = o;
}

}  // namespace

extern "C" int rsn_lzss_commit(const void* x, const void* L, const void* D, const void* lengths,
                               void* tok, void* tok_len, int B, int S, void* stream) {
    const int grid = (B + WARPS - 1) / WARPS;
    lzss_commit_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const int32_t*)L, (const int32_t*)D, (const int32_t*)lengths,
        (uint8_t*)tok, (int32_t*)tok_len, B, S);
    return (int)cudaGetLastError();
}
