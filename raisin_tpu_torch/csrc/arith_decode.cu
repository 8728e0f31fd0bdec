// Kernel C: adaptive arithmetic decode, one warp per block.
//
// Replaces raisin_tpu/ops/arithmetic_pallas.py:_dec_kernel. The TPU kernel
// decoded all blocks in lockstep and fed each block's bits through a 64-bit
// window refilled from a 128-word VMEM prefetch window, which is why the
// JAX container gates payloads at 64 KiB. Here each warp reads its block's
// `.rsn` row straight from device memory (one byte per 8 bits, a load all
// lanes share), so no payload size gate applies.
//
// The stream is read as the reference reads it: the 0..01 prepad is
// stripped (up to 8 zeros, then the sentinel 1), the decoder tail [1, 0]
// follows the last payload byte (arithmetic.go:48), and reads past it give
// 0 (bits.go:12). At step n == out_len the symbol must be EOF (eof_ok).
//
// What bounds it: like the encoder, one sequential chain per block; the
// symbol search (first s with scaled < cum[s+1]) is a count over the
// warp's 258 table entries, 9 per lane, summed with one warp reduction.
//
// `value` lives in 64 bits and the arithmetic on it wraps, so for any input
// the kernel computes what the plain version (_decode_rows_torch, int64)
// computes; for valid streams value stays in [low, high].
#include "arith_common.cuh"

namespace {

using namespace rsn;

struct ByteReader {
    const uint8_t* row;
    int len;
    int next;      // next byte index
    uint32_t buf;  // current byte
    int avail;     // bits of buf not yet read

    __device__ __forceinline__ uint32_t bit() {
        if (avail == 0) {
            const int i = next++;
            buf = i < len ? row[i] : (i == len ? 0x80u : 0u);
            avail = 8;
        }
        --avail;
        return (buf >> avail) & 1u;
    }
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {  // b > 0
    long long q = a / b;
    if ((a % b) != 0 && a < 0) --q;
    return q;
}

__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
arith_decode_kernel(const uint8_t* __restrict__ rows, const int32_t* __restrict__ byte_lens,
                    const int32_t* __restrict__ out_lens, uint8_t* __restrict__ syms,
                    int32_t* __restrict__ eof_ok, int B, int capb, int num_steps) {
    __shared__ uint32_t cum_all[WARPS_PER_CTA][CUM_STRIDE];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS_PER_CTA + warp;
    if (b >= B) return;

    uint32_t* cum = cum_all[warp];
    model_init(cum, lane);

    const int n = out_lens[b];
    ByteReader r{rows + (size_t)b * capb, min(max(byte_lens[b], 0), capb), 0, 0u, 0};
    for (int i = 0; i < 8; ++i) {  // strip the prepad
        if (r.bit()) break;
    }
    unsigned long long value = 0;
    for (int i = 0; i < 16; ++i) value = (value << 1) | r.bit();

    uint32_t low = 0, high = MAX_CODE, count = 257;
    bool frozen = false;
    int eof = 0;
    uint8_t mine = 0;  // this lane's symbol of the current 32-step group
    uint8_t* out = syms + (size_t)b * num_steps;
    const int steps = n < num_steps ? n + 1 : num_steps;

    for (int t = 0; t < steps; ++t) {
        const long long diff = (long long)high - low + 1;
        const long long num = (long long)((value - low + 1) * (unsigned long long)count - 1);
        const long long scaled = floor_div(num, diff);
        int below = 0;  // entries i in [1, 257] with cum[i] <= scaled
        for (int i = lane; i < NUM_CUM; i += 32) below += (i >= 1 && (long long)cum[i] <= scaled);
        const int sym = min(__reduce_add_sync(FULL_MASK, below), EOF_SYMBOL);

        const uint32_t lower = cum[sym];
        const uint32_t upper = cum[sym + 1];
        const uint32_t total = count;
        if (!frozen) {
            model_update(cum, lane, sym);
            count += 1;
            frozen = count >= MAX_FREQ;
        }

        const bool is_eof = sym == EOF_SYMBOL;
        if (t == n) eof = is_eof ? 1 : 0;
        if (!is_eof) {
            const uint32_t d = high - low + 1;
            high = low + d * upper / total - 1;
            low = low + d * lower / total;
            for (;;) {
                uint32_t sub;
                if (high < ONE_HALF) {
                    sub = 0;
                } else if (low >= ONE_HALF) {
                    sub = ONE_HALF;
                } else if (low >= ONE_FOURTH && high < THREE_FOURTHS) {
                    sub = ONE_FOURTH;
                } else {
                    break;
                }
                value = ((value - sub) << 1) + r.bit();
                low = (low - sub) << 1;
                high = ((high - sub) << 1) + 1;
            }
        }
        if ((t & 31) == lane) mine = is_eof ? 0 : (uint8_t)sym;
        if ((t & 31) == 31 || t == steps - 1) {  // coalesced store of the group
            const int i = (t & ~31) + lane;
            if (i <= t) out[i] = mine;
        }
    }
    if (lane == 0) eof_ok[b] = eof;
}

}  // namespace

extern "C" int rsn_arith_decode(const void* rows, const void* byte_lens, const void* out_lens,
                                void* syms, void* eof_ok, int B, int capb, int num_steps,
                                void* stream) {
    const int grid = (B + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
    arith_decode_kernel<<<grid, WARPS_PER_CTA * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rows, (const int32_t*)byte_lens, (const int32_t*)out_lens,
        (uint8_t*)syms, (int32_t*)eof_ok, B, capb, num_steps);
    return (int)cudaGetLastError();
}
