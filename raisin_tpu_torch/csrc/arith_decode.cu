// Kernel C: adaptive arithmetic decode, one warp per block.
//
// Replaces raisin_tpu/ops/arithmetic_pallas.py:_dec_kernel. The TPU kernel
// decoded all blocks in lockstep, one block per vector lane, and fed each
// block's bits through a 64-bit window refilled from a 128-word VMEM
// prefetch window. Here one warp decodes one block, straight from its
// `.rsn` row in device memory, so no payload size gate applies.
//
// The stream is read as the reference reads it: the 0..01 prepad is
// stripped (up to 8 zeros, then the sentinel 1), the decoder tail [1, 0]
// follows the last payload byte (arithmetic.go:48), and reads past it give
// 0 (bits.go:12). At step n == out_len the symbol must be EOF (eof_ok).
//
// What bounds it: the format makes each block one chain of dependent steps
// (an adaptive model, one coder state), and the blocks are all the
// parallelism there is (1024 of 64 KiB: ~2 warps a scheduler). So the time
// is steps x the latency of one step, and the design shortens the step:
// - the model lives in registers, 9 entries a lane (arith_common.cuh
//   reg_model_*): the search multiplies instead of dividing, folds the
//   lane's index-tagged entries and takes one warp max (the symbol and its
//   lower bound) and one warp min (the upper bound); EOF's tag narrows the
//   interval to itself, so no branch; the update is 9 register adds, and
//   none once the model freezes;
// - the coder keeps low, value - low and the range d = high - low + 1, in
//   32 bits; the two narrowing quotients by the total are a multiply-high
//   and a shift by a magic number (div_by_total), loaded a step ahead from
//   a table that the compiler builds (make_magic_table);
// - the renormalisation is closed-form, as in the plain version: k E1/E2
//   shifts from the leading bits that nl and nh share, then m E3 shifts,
//   and value takes the next k + m <= 16 bits at once;
// - the bits come from a 64-bit window in registers, refilled 32 bits at a
//   time by a shuffle from the warp's copy of the row: 128 bytes, 4 a lane,
//   and the 128 after them, whose load is issued 32 refills (>= 64 steps)
//   before they are needed, so device-memory latency stays off the chain.
//
// For every input, garbage included, low <= value <= high holds at every
// step: the chosen symbol's interval holds value (cum[s] <= scaled <
// cum[s + 1]), EOF leaves the interval as it is, and each shift keeps the
// bound. So 0 <= value - low < d <= 2^16, the scaled count's dividend
// (value - low + 1) * total - 1 stays below 2^16 * MAX_FREQ < 2^30, the
// search finds a symbol <= 256 with no clamp, d * cum < 2^30 for the
// quotients, and after a renormalisation d >= 2^14 + 2. The kernel computes
// what the plain version (_decode_rows_torch, int64) computes.
#include "arith_common.cuh"

namespace {

using namespace rsn;

constexpr int DEC_WARPS = 4;      // warps a CTA
constexpr int CHUNK_BYTES = 128;  // bytes of the row the warp holds in one buffer, 4 a lane

// div_by_total's (m, L) for each model total t in [2, MAX_FREQ], built at compile time
__device__ const MagicTable magic_table = make_magic_table();

// Bytes [pos, pos + 4) of the stream the decoder reads, big-endian: the
// payload below len, the tail byte 0x80 at len, then zeros. Reads no byte
// at or past len (<= capb), so never past the row or the tensor.
__device__ __forceinline__ uint32_t stream_word(const uint8_t* row, int len, long long pos) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const long long i = pos + k;
        w = (w << 8) | (i < len ? (uint32_t)row[i] : (i == len ? 0x80u : 0u));
    }
    return w;
}

__global__ void __launch_bounds__(DEC_WARPS * 32)
arith_decode_kernel(const uint8_t* __restrict__ rows, const int32_t* __restrict__ byte_lens,
                    const int32_t* __restrict__ out_lens, uint8_t* __restrict__ syms,
                    int32_t* __restrict__ eof_ok, int B, int capb, int num_steps) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * DEC_WARPS + (threadIdx.x >> 5);
    if (b >= B) return;

    const uint8_t* row = rows + (size_t)b * capb;  // any pitch: the row is read byte by byte
    const int len = min(max(byte_lens[b], 0), capb);
    const int n = out_lens[b];

    // the bit supply: cur holds the chunk at `base`, nxt the one after
    long long base = 0;
    uint32_t cur = stream_word(row, len, 4 * lane);
    uint32_t nxt = stream_word(row, len, CHUNK_BYTES + 4 * lane);
    unsigned long long win = ((unsigned long long)__shfl_sync(FULL_MASK, cur, 0) << 32) |
                             __shfl_sync(FULL_MASK, cur, 1);  // the next `avail` bits, MSB first
    int avail = 64;
    int w = 2;  // the next word of cur to enter the window

    const uint32_t first = (uint32_t)(win >> 56);  // the prepad: up to 8 zeros, then the sentinel 1
    const int prepad = first ? __clz(first) - 23 : 8;
    win <<= prepad;
    uint32_t vrel = (uint32_t)(win >> 48);  // value - low; low starts at 0
    win <<= 16;
    avail -= prepad + 16;

    uint32_t c[MODEL_REGS];
    reg_model_init(c, lane);
    uint32_t low = 0, d = MAX_CODE + 1, count = 257;
    uint2 magic = __ldg(&magic_table.m[count]);
    bool is_eof = false;
    uint8_t* out = syms + (size_t)b * num_steps;
    const int steps = n < num_steps ? n + 1 : num_steps;

    for (int g = 0; g < steps; g += 32) {  // groups of 32 steps, one coalesced store each
        const int g_end = min(g + 32, steps);
        uint8_t mine = 0;  // this lane's symbol of the group
        for (int t = g; t < g_end; ++t) {
            const uint32_t total = count;
            const uint2 by_total = magic;
            // the model updates (EOF too) until the update that takes count to
            // MAX_FREQ, then freezes (arithmetic.go:184-192)
            const bool update = count < MAX_FREQ;
            count += update ? 1u : 0u;
            magic = __ldg(&magic_table.m[count]);  // the next step's, loaded a step ahead

            uint32_t lower, upper;
            const int sym = reg_model_find(c, lane, d, vrel * total + total - 1, lower, upper);
            is_eof = sym == EOF_SYMBOL;
            const uint32_t q_hi = div_by_total(d * upper, by_total);
            const uint32_t q_lo = div_by_total(d * lower, by_total);
            const uint32_t nh = low + q_hi - 1;
            const uint32_t nl = low + q_lo;

            // k E1/E2 shifts (leading bits shared by nl and nh), then m E3 shifts
            // (the following bits where nl has 1 and nh 0); each E3 shift flips
            // bit 15 of what it shifts in, and the next one shifts that bit out.
            // value and high shift as low does, value taking the stream's bits:
            // value - low and d scale by 2^s
            const int k = __clz(nl ^ nh) - 16;
            const int m = __clz(~__funnelshift_lc(0u, nl & ~nh, k + 17));
            const int s = k + m;
            low = ((nl << s) & MAX_CODE) ^ (m ? ONE_HALF : 0u);
            d = (q_hi - q_lo) << s;
            vrel = ((vrel - q_lo) << s) | ((uint32_t)(win >> 48) >> (16 - s));
            win <<= s;
            avail -= s;
            if (avail < 32) {  // warp-uniform: the next word from the lane that holds it
                win |= (unsigned long long)__shfl_sync(FULL_MASK, cur, w) << (32 - avail);
                avail += 32;
                if (++w == 32) {
                    w = 0;
                    cur = nxt;
                    base += CHUNK_BYTES;
                    nxt = stream_word(row, len, base + CHUNK_BYTES + 4 * lane);
                }
            }
            if (t - g == lane) mine = is_eof ? 0 : (uint8_t)sym;
            if (update) reg_model_update(c, lane, sym);  // warp-uniform, off the coder's chain
        }
        if (g + lane < g_end) out[g + lane] = mine;
    }
    // eof_ok: step n, the last one when n < num_steps, decoded EOF
    if (lane == 0) eof_ok[b] = n < num_steps && steps > 0 && is_eof ? 1 : 0;
}

}  // namespace

extern "C" int rsn_arith_decode(const void* rows, const void* byte_lens, const void* out_lens,
                                void* syms, void* eof_ok, int B, int capb, int num_steps,
                                void* stream) {
    const int grid = (B + DEC_WARPS - 1) / DEC_WARPS;
    arith_decode_kernel<<<grid, DEC_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rows, (const int32_t*)byte_lens, (const int32_t*)out_lens,
        (uint8_t*)syms, (int32_t*)eof_ok, B, capb, num_steps);
    return (int)cudaGetLastError();
}
