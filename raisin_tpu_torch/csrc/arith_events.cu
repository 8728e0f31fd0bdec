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
// with a (264, 8, 128) VMEM model, so it needed B % 128 == 0 and S % 128 ==
// 0 and unrolled all 16 renormalisation iterations for every block. Here
// the coder is kernel A's (one warp per block, the model in shared memory,
// arith_common.cuh): any B >= 0 and any S > max(lengths), so a single
// stream runs at B = 1 without padding, and each step loops only over the
// shifts it makes. The scalar coder state is replicated in every lane; lane
// t & 31 keeps step t's record (four 32-bit words and slot0) in registers,
// and every 32 steps the warp stores 32 records at once: 512 contiguous
// bytes of slots, one 16-byte store a lane, and 128 bytes of slot0.
//
// What bounds it: as for kernel A, the chain of coder steps of each block
// (a table read, a 258-entry update until the model freezes, a division
// and up to 16 shifts); its output is 20 bytes a step against 4 read.
#include "arith_common.cuh"

namespace {

using namespace rsn;

constexpr int SLOTS = 16;  // renormalisation shifts a step makes at most

__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
arith_events_kernel(const int32_t* __restrict__ symbols, const int32_t* __restrict__ lengths,
                    uint4* __restrict__ slots, int32_t* __restrict__ slot0, int B, int S) {
    __shared__ uint32_t cum_all[WARPS_PER_CTA][CUM_STRIDE];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS_PER_CTA + warp;
    if (b >= B) return;  // the whole warp leaves; nothing below syncs the CTA

    uint32_t* cum = cum_all[warp];
    model_init(cum, lane);

    const size_t row = (size_t)b * S;  // 1024 x 65537 steps fill > 2^30 slot bytes
    const int32_t* sym_row = symbols + row;
    const int steps = min(lengths[b] + 1, S);  // payload symbols + EOF at n
    uint32_t low = 0, high = MAX_CODE, count = 257;
    uint32_t pending = 0;
    bool frozen = false;

    for (int t0 = 0; t0 < S; t0 += 32) {
        // 32 symbols per coalesced load, handed out by shuffle
        const int i = t0 + lane;
        const int chunk = i < steps ? sym_row[i] : 0;
        const int m = min(32, steps - t0);  // <= 0 past EOF: the records stay 0
        uint4 rec = make_uint4(0u, 0u, 0u, 0u);
        uint32_t rec0 = 0;
        for (int j = 0; j < m; ++j) {
            const int s = __shfl_sync(FULL_MASK, chunk, j);
            encode_narrow(cum, lane, s, low, high, count, frozen);

            unsigned long long lo = 0, hi = 0;  // slots 0-7 and 8-15, slot k in byte k
            uint32_t carried = 0;
            bool emitted = false;
            for (int it = 0; it < SLOTS; ++it) {  // E1/E2/E3, arithmetic.go:115-163
                uint32_t v = 0;
                if (high < ONE_HALF || low >= ONE_HALF) {
                    const uint32_t bit = low >= ONE_HALF ? 1u : 0u;
                    v = 0x80u | (bit << 6) | (emitted ? pending : 0x20u);
                    if (!emitted) carried = pending;
                    emitted = true;
                    pending = 0;
                } else if (low >= ONE_FOURTH && high < THREE_FOURTHS) {
                    ++pending;  // straddle: no emission, the slot stays 0
                    low -= ONE_FOURTH;
                    high -= ONE_FOURTH;
                } else {
                    break;
                }
                if (it < 8) {
                    lo |= (unsigned long long)v << (8 * it);
                } else {
                    hi |= (unsigned long long)v << (8 * (it - 8));
                }
                high = ((high << 1) + 1) & MAX_CODE;
                low = (low << 1) & MAX_CODE;
            }
            if (lane == j) {
                rec = make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
                rec0 = carried;
            }
        }
        if (i < S) {
            slots[row + i] = rec;
            slot0[row + i] = (int32_t)rec0;
        }
    }
}

}  // namespace

extern "C" int rsn_arith_events(const void* symbols, const void* lengths, void* slots, void* slot0,
                                int B, int S, void* stream) {
    const int grid = (B + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
    arith_events_kernel<<<grid, WARPS_PER_CTA * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)symbols, (const int32_t*)lengths, (uint4*)slots, (int32_t*)slot0, B, S);
    return (int)cudaGetLastError();
}
