// Kernel A: adaptive arithmetic encode, one warp per block, raw bits out.
//
// Replaces raisin_tpu/ops/arithmetic_pallas.py:_pack_kernel (the coder with
// in-kernel 32-bit packing and per-chunk staging) and the concatenation done
// by _stitch_kernel. On the TPU all blocks ran in lockstep on vector lanes,
// so output had to be staged per 128-symbol chunk and stitched afterwards.
// Here each warp owns its block and writes the MSB-first bit stream straight
// into that block's contiguous row: no staging, so neither the staging
// overflow nor the 31-bit carried-pending limit of the TPU kernel exists.
// The `.rsn` prepad is applied afterwards by kernel B (arith_prepad.cu).
//
// What bounds it: the format makes each block one chain of dependent coder
// steps, and the blocks are all the parallelism there is (1024 of 64 KiB:
// ~2 warps a scheduler). So the time is steps x the latency of one step, and
// the design takes everything it can off that chain (arith_common.cuh):
// - the model lives in registers, 9 entries a lane. It does not depend on
//   the coder state, so a step's bounds are read two steps ahead (a select
//   tree and a shuffle, reg_model_bounds: the encoder knows its symbol),
//   before the update between, which adds 1 to them where the symbol lies
//   above the updating one; the update is 9 register adds. Once the model
//   freezes (after UPDATE_STEPS steps; nothing updates it again), each
//   entry's successor sits beside it (reg_pairs_*), so one select and one
//   shuffle give both bounds;
// - the coder keeps low and the range d = high - low + 1 in 32 bits, and
//   the two narrowing quotients by the total (encode_narrow32) are
//   independent multiply-highs and shifts by a magic number (div_by_total)
//   from a table that the compiler builds (make_magic_table), taken a step
//   ahead: right after the renormalisation that gives d;
// - the renormalisation is closed-form (renorm_counts): k E1/E2 shifts from
//   two leading-zero counts, then m E3 shifts, no loop and no branch;
// - a step's output is one short bit string: when k > 0, the first shared
//   bit, `pending` copies of its complement, then the other k - 1 shared
//   bits; when k = 0, none (pending grows by m). It is appended to a 64-bit
//   accumulator, and lane 0 stores a word as it fills, off the chain. A
//   string longer than 32 bits (a pending run past 32 - k) takes a
//   warp-uniform slow path that appends the run up to 32 bits at a time.
//   Pending is unbounded (uint32_t);
// - the symbols come 32 per coalesced load, the next 32 loaded a chunk
//   ahead, and a step's symbol is handed out by shuffle three steps ahead;
// - the steps are unrolled STEP_GROUP at a time (the two model phases in
//   loops of their own), so that neighbouring steps interleave.
// Probes on the H100 chose these over a warp-wide store of 32 words at
// once, symbols loaded by every lane, groups of 4 or 16, and pairs before
// the freeze too (their update costs more than they save). What is left is
// the coder's chain (two leading-zero counts, two multiply-highs and the
// shifts) and the instructions issued around it: one warp alone on an SM
// takes most of the time that two warps a scheduler take (chip_smoke.py
// times both).
//
// Row size: a renormalisation shift emits at most one bit (E1/E2 emit the
// bit and release pending bits, each of which an earlier E3 shift created
// without emitting), a step makes at most 16 shifts (the coded interval is
// at least 1 wide and doubles per shift within 16 bits), so a block of n
// symbols emits at most 16*(n+1) bits. With the 8-bit prepad the `.rsn`
// stream fits 16*(n+1)+8 bits; blocks whose stream would not fit `capw`
// words are flagged in `oflow` and their stores past the row are dropped.
#include <type_traits>

#include "arith_common.cuh"

namespace {

using namespace rsn;

constexpr int STEP_GROUP = 8;  // steps unrolled together; divides 32, where a chunk turns

// div_by_total's (m, L) for each model total t in [2, MAX_FREQ], built at compile time
__device__ const MagicTable magic_table = make_magic_table();

// The MSB-first bit stream of one block. Every lane keeps the same state;
// lane 0 alone stores (the others' end is the row's start).
struct BitWriter {
    uint32_t* wp;            // the next word's place, counting words past the row too
    uint32_t* end;           // lane 0: the row's end; the other lanes: its start
    unsigned long long acc;  // the last nb bits appended, at the bottom
    int nb;                  // < 32 between calls

    // Appends the low `len` bits of v (len <= 32, v < 2^len), MSB first;
    // stores the word that fills, if one does. No branch but the store's predicate.
    __device__ __forceinline__ void put(uint32_t v, int len) {
        acc = acc << len | v;
        nb += len;
        const bool full = nb >= 32;
        if (full && wp < end) *wp = (uint32_t)(acc >> ((nb - 32) & 31));
        wp += full ? 1 : 0;
        nb -= full ? 32 : 0;
    }

    // Appends `count` copies of `bit`, up to 32 at a time (the long-run path).
    __device__ __forceinline__ void run(uint32_t bit, uint32_t count) {
        const uint32_t fill = bit ? FULL_MASK : 0u;
        while (count > 0) {
            const int take = count < 32u ? (int)count : 32;
            put(fill >> (32 - take), take);
            count -= take;
        }
    }
};

__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
arith_encode_kernel(const int32_t* __restrict__ symbols, const int32_t* __restrict__ lengths,
                    uint32_t* __restrict__ raw, int32_t* __restrict__ bits_out,
                    int32_t* __restrict__ oflow_out, int B, int S, int capw) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
    if (b >= B) return;  // the whole warp leaves; nothing below syncs the CTA

    const int32_t* sym_row = symbols + (size_t)b * S;
    const int steps = min(lengths[b] + 1, S);  // payload symbols + EOF at n
    // the chunk of 32 symbols that holds step t (symbol t0 + lane in lane
    // `lane`), and the chunk after it
    int chunk = lane < steps ? sym_row[lane] : 0;
    int next = 32 + lane < steps ? sym_row[32 + lane] : 0;
    int s0 = __shfl_sync(FULL_MASK, chunk, 0);  // step t's symbol
    int s1 = __shfl_sync(FULL_MASK, chunk, 1);  // step t + 1's
    int s2 = __shfl_sync(FULL_MASK, chunk, 2);  // step t + 2's

    uint32_t c[MODEL_REGS];  // the model until it freezes
    uint32_t p[MODEL_REGS];  // the frozen model as pairs
    reg_model_init(c, lane);
    const uint2* magic_next = &magic_table.m[INIT_TOTAL];
    uint2 magic = __ldg(magic_next++);
    uint32_t lower, upper, q_lo, q_hi, ahead_lo, ahead_hi;
    reg_model_bounds(c, s0, lower, upper);
    reg_model_bounds(c, s1, ahead_lo, ahead_hi);  // step t + 1's bounds before step t's update
    uint32_t low = 0, d = MAX_CODE + 1, pending = 0;
    encode_narrow32(d, lower, upper, magic, q_lo, q_hi);
    uint32_t* row = raw + (size_t)b * capw;
    BitWriter w{row, lane == 0 ? row + capw : row, 0ull, 0};

    // step t; `updates` says whether the model updates (the first
    // UPDATE_STEPS steps only, arithmetic.go:184-192)
    auto step = [&](int t, auto updates) {
        constexpr bool UPDATES = decltype(updates)::value;
        // the interval narrowed by the quotients taken a step ahead, then
        // renormalised: the coder's chain
        const uint32_t nl = low + q_lo;
        const uint32_t nh = low + q_hi - 1;
        int k, m;
        renorm_counts(nl, nh, k, m, low, d);

        // step t + 1's quotients, on the new d: its bounds were read a step
        // ahead, before step t's update, which adds 1 above s0 (EOF too)
        lower = ahead_lo + (UPDATES && s1 > s0 ? 1u : 0u);
        upper = ahead_hi + (UPDATES && s1 >= s0 ? 1u : 0u);
        if constexpr (UPDATES) magic = __ldg(magic_next++);
        encode_narrow32(d, lower, upper, magic, q_lo, q_hi);

        // off the chain: step t's update, then step t + 2's bounds before
        // step t + 1's update, and step t + 3's symbol
        if constexpr (UPDATES) {
            reg_model_update(c, lane, s0);
            reg_model_bounds(c, s2, ahead_lo, ahead_hi);
        } else {
            reg_pairs_bounds(p, s2, ahead_lo, ahead_hi);
        }
        s0 = s1;
        s1 = s2;
        s2 = __shfl_sync(FULL_MASK, (t & 31) >= 29 ? next : chunk, (t + 3) & 31);

        // step t's output: bit b = nl's bit 15, `pending` copies of !b, then
        // nl's bits 14 .. 16 - k; pending becomes m (k > 0) or grows by m. As
        // one string: b, at bit k - 1 of pat, moves up to bit k - 1 + pending
        // and the bits between become !b, pat + (h << pending) - h (0 when k = 0)
        const bool emit = k > 0;
        const uint32_t h = (1u << k) >> 1;    // bit k - 1; 0 when k = 0
        const uint32_t pat = nl >> (16 - k);  // the k shared bits
        if (__builtin_expect(!emit || pending <= 32u - k, 1)) {  // warp-uniform: <= 32 bits
            w.put(pat + (h << (pending & 31)) - h, emit ? k + (int)pending : 0);
        } else {  // the long-run path
            const uint32_t bit = (pat & h) ? 1u : 0u;
            w.put(bit, 1);
            w.run(bit ^ 1u, pending);
            w.put(pat & (h - 1), k - 1);
        }
        pending = emit ? (uint32_t)m : pending + m;
    };
    // at each multiple of 32 past 0: the next chunk, and the load of the one
    // after it (32 steps ahead; symbols past the steps are never coded)
    auto turn = [&](int t) {
        if ((t & 31) == 0 && t > 0) {  // warp-uniform
            chunk = next;
            next = sym_row[min(t + 32 + lane, S - 1)];
        }
    };
    // steps [t, t_end), STEP_GROUP at a time from a multiple of STEP_GROUP on,
    // so that the compiler interleaves neighbouring steps
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
    reg_pairs_from_model(c, lane, p);
    run(std::false_type{}, steps);

    // trailing pending bits are dropped (no final flush, arithmetic_ref.py:108)
    const int words = (int)(w.wp - row);
    const int total_bits = words * 32 + w.nb;
    if (lane == 0) {
        if (w.nb > 0 && words < capw) row[words] = (uint32_t)(w.acc << (32 - w.nb));
        bits_out[b] = total_bits;
        oflow_out[b] = total_bits + 8 > 32 * capw ? 1 : 0;
    }
}

}  // namespace

extern "C" int rsn_arith_encode(const void* symbols, const void* lengths, void* raw, void* bits,
                                void* oflow, int B, int S, int capw, void* stream) {
    const int grid = (B + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
    arith_encode_kernel<<<grid, WARPS_PER_CTA * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)symbols, (const int32_t*)lengths, (uint32_t*)raw, (int32_t*)bits,
        (int32_t*)oflow, B, S, capw);
    return (int)cudaGetLastError();
}

extern "C" const char* rsn_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
