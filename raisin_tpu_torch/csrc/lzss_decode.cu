// Kernel F: LZSS token walk, one warp per block.
//
// Replaces raisin_tpu/ops/lzss_decode_pallas.py:_decode_kernel (via
// lzss_decode_blocks). It follows the reference state machine (lzss.go:323):
// outside a token every byte but '<' is a literal; '<' opens a token whose
// bytes up to ',' are D and up to '>' are L (a number that is not all
// decimal digits counts as 0, values saturate at 2^30); the token copies
// out[len - D : len - D + L]. A stream that ends inside a token drops it.
// The TPU kernel read a (toklen, L, D) side table that an XLA pass built
// beforehand and packed D and L in 13 bits; here the warp parses as it
// walks, so no side table and no 13-bit limit.
//
// Faults stop the walk: a reference with D > len or L > D (outside the
// decoded output; err 1), or output past cap_out (err 2). The kernel never
// writes past its row.
//
// What bounds it: the walk is sequential, so the latency of each step. The
// warp reads 32 token bytes at a time with one coalesced load, a ballot
// finds the next '<', and the lanes copy the literal run before it
// together; a copy moves 32 bytes a step. L <= D on every valid stream, so
// a copy's source lies wholly before its destination: __syncwarp() orders
// each step's writes before later steps read them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int WARPS = 4;
constexpr long long SATURATE = 1LL << 30;

// Reads the number that ends at `stop`; returns false if the stream ends first.
__device__ __forceinline__ bool read_number(const uint8_t* t, int n, int& ip, uint8_t stop,
                                            long long& value) {
    long long v = 0;
    bool digits = true;
    while (ip < n) {
        const int ch = t[ip++];
        if (ch == stop) {
            value = digits ? v : 0;
            return true;
        }
        if (ch >= '0' && ch <= '9') {
            v = min(v * 10 + (ch - '0'), SATURATE);
        } else {
            digits = false;
        }
    }
    return false;
}

__global__ void __launch_bounds__(WARPS * 32)
lzss_decode_kernel(const uint8_t* __restrict__ tok, const int32_t* __restrict__ tok_len,
                   uint8_t* __restrict__ rows, int32_t* __restrict__ out_len,
                   int32_t* __restrict__ err, int B, int S, int cap) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;
    const int n = min(max(tok_len[b], 0), S);
    const uint8_t* t = tok + (size_t)b * S;
    uint8_t* out = rows + (size_t)b * cap;

    int ip = 0;
    long long op = 0;
    int e = 0;
    while (ip < n) {
        const int p = ip + lane;
        const uint8_t ch = p < n ? t[p] : 0;
        const unsigned opens = __ballot_sync(FULL_MASK, p < n && ch == '<');
        const int run = opens ? __ffs(opens) - 1 : min(32, n - ip);
        if (op + run > cap) {
            e = 2;
            break;
        }
        if (lane < run) out[op + lane] = ch;  // literals
        op += run;
        ip += run;
        if (!opens) continue;
        ++ip;  // the '<'
        long long D, L;
        if (!read_number(t, n, ip, ',', D) || !read_number(t, n, ip, '>', L)) break;
        if (D > op || L > D) {
            e = 1;
            break;
        }
        if (op + L > cap) {
            e = 2;
            break;
        }
        __syncwarp();
        for (long long k = lane; k < L; k += 32) out[op + k] = out[op - D + k];
        __syncwarp();
        op += L;
    }
    if (lane == 0) {
        out_len[b] = e ? 0 : (int32_t)op;
        err[b] = e;
    }
}

}  // namespace

extern "C" int rsn_lzss_decode(const void* tok, const void* tok_len, void* rows, void* out_len,
                               void* err, int B, int S, int cap, void* stream) {
    const int grid = (B + WARPS - 1) / WARPS;
    lzss_decode_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)tok, (const int32_t*)tok_len, (uint8_t*)rows, (int32_t*)out_len,
        (int32_t*)err, B, S, cap);
    return (int)cudaGetLastError();
}
