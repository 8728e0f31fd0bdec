// Kernel I: adaptive arithmetic encode that writes the per-step event record.
//
// The port of raisin_tpu/ops/arithmetic_pallas.py:_enc_kernel (via
// encode_events and encode_blocks_events), a producer of the event record
// that raisin_tpu/ops/arithmetic_scan.py expands into the single-stream
// `.rsn` bits. The JAX stream path produces the record with the XLA scan
// arithmetic_scan._events_xla and reaches _enc_kernel only with
// use_pallas=True; this kernel takes the place of both. Per coder step t of
// block b it writes
//   slots[b, t, j], j < 16: the j-th renormalisation shift of the step, 0 for
//     a shift that emits nothing (E3) and for the steps past the shifts, else
//     0x80 | bit << 6 | first << 5 | in_pend: the emitted bit, whether it is
//     the step's first emission, and for the later ones the E3 shifts since
//     the previous emission, which it flushes;
//   slot0[b, t]: the pending count carried into the step, which its first
//     emission flushes (it may exceed 255);
// and zeros for every step past the block's EOF.
//
// The TPU kernel ran 1024 blocks in lockstep on (8, 128) vector registers
// with a (264, 8, 128) VMEM model and unrolled all 16 renormalisation
// iterations of every step. Here the function is split by what depends on
// what, for any B >= 0 and any S > max(lengths):
// - the model does not depend on the coder: step t's bounds follow from the
//   symbols before it, and its total is min(INIT_TOTAL + t, MAX_FREQ);
// - the coder's state is low and the range d alone (arith_common.cuh:
//   encode_narrow32, renorm_counts);
// - a step's record follows from its narrowed low nl and its E1/E2 count k:
//   slot j < k is 0x80 | (bit 15 - j of nl) << 6 | (j == 0) << 5, every
//   other slot 0 (no emission follows an E3 shift within a step, so the
//   in-step pending field is always 0); slot0 is the pending count carried
//   into a step that emits, 0 for one that does not.
// So a call launches three kernels over a workspace of one word a step:
// 1. arith_events_kernel_model, one CTA of MODEL_WARPS warps a block: warp w
//    takes the steps [w * MODEL_TILE, (w + 1) * MODEL_TILE) before the
//    freeze. The tiles' symbol counts, prefixed over the tiles, give each
//    tile's starting model (cum[i] = i + the symbols below i coded before
//    it), and every warp walks its tile at once with kernel A's register
//    model. The counts of all tiles give the frozen model, from which the
//    whole CTA looks up every later step. Each step's word is lower | upper
//    << 16, (0, 1) past EOF.
// 2. arith_events_kernel_chain, one warp a block: the coder's chain and only
//    what feeds it and stores it. The bound words come 32 per coalesced load
//    a chunk ahead and are handed out by shuffle two steps ahead; the magic
//    number of the step's total comes from the table before the freeze and
//    is one constant after it (two loops, as in kernel A); the steps are
//    unrolled STEP_GROUP at a time. Lane j keeps step j's nl | k << 16 and
//    its slot0 (the pending count, k > 0 ? m : pending + m, rides beside the
//    chain without feeding it), and every 32 steps the warp stores 32 of
//    each: the words in place of their bounds, slot0 into the output.
// 3. arith_events_kernel_records, a thread a step over all blocks: the 16
//    slot bytes from nl and k, one 16-byte store; zeros past EOF.
//
// What bounds it: pass 2's chain of dependent coder steps, one a block (two
// leading-zero counts, two multiply-highs, the shifts and adds between:
// ~15 instructions in a row); a single stream is one warp on one SM. Passes
// 1 and 3 run in parallel over the steps and move 8 and 24 bytes a step;
// pass 1's longest path is a warp's walk of MODEL_TILE steps. Probes on the
// H100 chose this pass 2 over: the records built and stored by pass 2
// itself (slower than a pass of their own), groups of 4 or 16 steps, bounds
// handed out one step ahead, the quotients from (nh - nl + 1) * bound << s
// without d, and the E3 count from leading-zero counts taken side by side;
// keeping the pending count costs the chain little, so slot0 needs no scan
// of its own.
#include <type_traits>

#include "arith_common.cuh"

namespace {

using namespace rsn;

constexpr int MODEL_TILE = 512;  // steps before the freeze that one warp of pass 1 walks
constexpr int MODEL_WARPS = 32;  // pass 1's warps a block
static_assert(MODEL_WARPS * MODEL_TILE >= UPDATE_STEPS, "pass 1's tiles cover the steps before the freeze");
constexpr int COUNT_STRIDE = 260;        // a tile's 257 symbol counts, padded
constexpr uint32_t PAST_EOF = 1u << 16;  // lower 0, upper 1: leaves the interval as it is
constexpr int STEP_GROUP = 8;            // pass 2's steps unrolled together; divides 32, where a chunk turns
constexpr int RECORD_THREADS = 256;      // pass 3's threads a CTA

// div_by_total's (m, L) for each model total t in [2, MAX_FREQ], built at compile time
__device__ const MagicTable magic_table = make_magic_table();

// Pass 1: every step's bounds, words[b, t] = lower | upper << 16.
__global__ void __launch_bounds__(MODEL_WARPS * 32)
arith_events_kernel_model(const int32_t* __restrict__ symbols, const int32_t* __restrict__ lengths,
                          uint32_t* __restrict__ words, int S) {
    __shared__ uint32_t counts[MODEL_WARPS + 1][COUNT_STRIDE];  // per tile; then those before it; [MODEL_WARPS]: all
    __shared__ uint32_t frozen[NUM_CUM];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const size_t row = (size_t)blockIdx.x * S;
    const int32_t* sym_row = symbols + row;
    uint32_t* out = words + row;
    const int steps = min(lengths[blockIdx.x] + 1, S);  // payload symbols + EOF at n
    const int updates = min(steps, UPDATE_STEPS);       // the steps that update the model
    const int t_begin = warp * MODEL_TILE;
    const int t_end = min(t_begin + MODEL_TILE, min(S, UPDATE_STEPS));  // this warp's tile

    for (int i = threadIdx.x; i < (MODEL_WARPS + 1) * COUNT_STRIDE; i += blockDim.x) (&counts[0][0])[i] = 0;
    __syncthreads();
    for (int t = t_begin + lane; t < min(t_end, updates); t += 32) atomicAdd(&counts[warp][sym_row[t]], 1u);
    __syncthreads();
    for (int s = threadIdx.x; s <= EOF_SYMBOL; s += blockDim.x) {  // exclusive prefix over the tiles
        uint32_t run = 0;
        for (int w = 0; w < MODEL_WARPS; ++w) {
            const uint32_t n = counts[w][s];
            counts[w][s] = run;
            run += n;
        }
        counts[MODEL_WARPS][s] = run;
    }
    __syncthreads();
    uint32_t c[MODEL_REGS];
    if (warp == 0) {  // the model after every update: the frozen one
        reg_model_from_counts(c, lane, counts[MODEL_WARPS]);
#pragma unroll
        for (int j = 0; j < MODEL_REGS; ++j) {
            if (lane + 32 * j < NUM_CUM) frozen[lane + 32 * j] = c[j];
        }
    }
    reg_model_from_counts(c, lane, counts[warp]);  // the model before the tile's first step
    __syncthreads();

    // the tile: 32 symbols per coalesced load, handed out by shuffle; lane j keeps step t0 + j's word
    for (int t0 = t_begin; t0 < t_end; t0 += 32) {
        const int i = t0 + lane;
        const int chunk = i < updates ? sym_row[i] : 0;
        const int n = min(32, updates - t0);  // <= 0 past EOF
        uint32_t word = PAST_EOF;
        for (int j = 0; j < n; ++j) {
            const int s = __shfl_sync(FULL_MASK, chunk, j);
            uint32_t lower, upper;
            reg_model_bounds(c, s, lower, upper);
            if (lane == j) word = lower | upper << 16;
            reg_model_update(c, lane, s);
        }
        if (i < t_end) out[i] = word;
    }
    for (int t = UPDATE_STEPS + threadIdx.x; t < S; t += blockDim.x) {  // after the freeze
        const int s = t < steps ? sym_row[t] : 0;
        out[t] = t < steps ? frozen[s] | frozen[s + 1] << 16 : PAST_EOF;
    }
}

// Pass 2: the coder's chain. words[b, t] becomes nl | k << 16 for t < steps;
// slot0[b, t] the pending count carried into the step where it emits, else 0.
__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
arith_events_kernel_chain(const int32_t* __restrict__ lengths, uint32_t* __restrict__ words,
                          int32_t* __restrict__ slot0, int B, int S) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
    if (b >= B) return;  // the whole warp leaves; nothing below syncs the CTA

    const size_t row = (size_t)b * S;  // 1024 x 65537 steps fill > 2^30 slot bytes
    uint32_t* w_row = words + row;
    int32_t* s0_row = slot0 + row;
    const int steps = min(lengths[b] + 1, S);
    auto load = [&](int i) { return i < steps ? w_row[i] : 0u; };
    // the chunk of 32 bound words that holds step t (step t0 + lane's in lane `lane`), and the next
    uint32_t chunk = load(lane);
    uint32_t next = load(32 + lane);

    const uint2* magic_next = &magic_table.m[INIT_TOTAL];
    uint2 magic = __ldg(magic_next++);
    uint32_t low = 0, d = MAX_CODE + 1, pending = 0, q_lo, q_hi;
    uint32_t bounds = __shfl_sync(FULL_MASK, chunk, 0);
    encode_narrow32(d, bounds & 0xFFFF, bounds >> 16, magic, q_lo, q_hi);  // step 0's quotients
    bounds = __shfl_sync(FULL_MASK, chunk, 1);  // step t + 1's bounds
    uint32_t rec = 0, rec0 = 0;                 // lane j: step t0 + j's word and slot0

    // step t; `updates` says whether the total still grows (the first UPDATE_STEPS steps)
    auto step = [&](int t, auto updates) {
        constexpr bool UPDATES = decltype(updates)::value;
        // the interval narrowed by the quotients taken a step ahead, then renormalised: the chain
        const uint32_t nl = low + q_lo;
        const uint32_t nh = low + q_hi - 1;
        int k, m;
        renorm_counts(nl, nh, k, m, low, d);
        if constexpr (UPDATES) magic = __ldg(magic_next++);  // step t + 1's total, INIT_TOTAL + t + 1
        encode_narrow32(d, bounds & 0xFFFF, bounds >> 16, magic, q_lo, q_hi);

        // off the chain: step t + 2's bounds, step t's word and slot0, the pending count
        bounds = __shfl_sync(FULL_MASK, (t & 31) >= 30 ? next : chunk, (t + 2) & 31);
        const bool mine = lane == (t & 31);
        rec = mine ? nl | (uint32_t)k << 16 : rec;
        rec0 = mine ? (k > 0 ? pending : 0u) : rec0;
        pending = k > 0 ? (uint32_t)m : pending + m;
    };
    // at each multiple of 32 past 0: store the 32 steps before it, take the next chunk and
    // load the one after it
    auto turn = [&](int t) {
        if ((t & 31) == 0 && t > 0) {  // warp-uniform
            w_row[t - 32 + lane] = rec;
            s0_row[t - 32 + lane] = (int32_t)rec0;
            chunk = next;
            next = load(t + 32 + lane);
        }
    };
    // steps [t, t_end), STEP_GROUP at a time from a multiple of STEP_GROUP on
    int t = 0;
    auto run = [&](auto updates, int t_end) {
        for (; t < t_end && t % STEP_GROUP != 0; ++t) {
            turn(t);
            step(t, updates);
        }
        for (; t + STEP_GROUP <= t_end; t += STEP_GROUP) {
            turn(t);
#pragma unroll
            for (int u = 0; u < STEP_GROUP; ++u) step(t + u, updates);
        }
        for (; t < t_end; ++t) {
            turn(t);
            step(t, updates);
        }
    };
    run(std::true_type{}, min(steps, UPDATE_STEPS));
    run(std::false_type{}, steps);
    const int i = ((steps - 1) & ~31) + lane;  // the last chunk
    if (i < steps) {
        w_row[i] = rec;
        s0_row[i] = (int32_t)rec0;
    }
}

// Pass 3: the records, slots[b, t] from nl and k; slot0 0 past EOF.
__global__ void __launch_bounds__(RECORD_THREADS)
arith_events_kernel_records(const int32_t* __restrict__ lengths, const uint32_t* __restrict__ words,
                            uint4* __restrict__ slots, int32_t* __restrict__ slot0, int S, size_t n) {
    const size_t i = (size_t)blockIdx.x * RECORD_THREADS + threadIdx.x;
    if (i >= n) return;
    const size_t b = i / S;
    const int t = (int)(i - b * S);
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (t < min(lengths[b] + 1, S)) {
        const uint32_t w = words[i];
        const uint32_t nl = w & 0xFFFF;
        const int k = (int)(w >> 16);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const uint32_t slot = 0x80u | ((nl >> (15 - j)) & 1u) << 6 | (j == 0 ? 0x20u : 0u);
            v[j >> 2] |= j < k ? slot << (8 * (j & 3)) : 0u;
        }
    } else {
        slot0[i] = 0;
    }
    slots[i] = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// `words`: a workspace of B * S 32-bit words.
extern "C" int rsn_arith_events(const void* symbols, const void* lengths, void* slots, void* slot0, void* words,
                                int B, int S, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    arith_events_kernel_model<<<B, MODEL_WARPS * 32, 0, st>>>(
        (const int32_t*)symbols, (const int32_t*)lengths, (uint32_t*)words, S);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    arith_events_kernel_chain<<<(B + WARPS_PER_CTA - 1) / WARPS_PER_CTA, WARPS_PER_CTA * 32, 0, st>>>(
        (const int32_t*)lengths, (uint32_t*)words, (int32_t*)slot0, B, S);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const size_t n = (size_t)B * S;
    arith_events_kernel_records<<<(unsigned)((n + RECORD_THREADS - 1) / RECORD_THREADS), RECORD_THREADS, 0, st>>>(
        (const int32_t*)lengths, (const uint32_t*)words, (uint4*)slots, (int32_t*)slot0, S, n);
    return (int)cudaGetLastError();
}
