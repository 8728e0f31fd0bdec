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
// What bounds it: the coder is one sequential chain per block (n+1 steps of
// a table read, a 258-entry update until the model freezes, a division and
// up to 16 renormalisation shifts). The parallelism is the number of
// blocks, one warp each; the update is spread over the warp's lanes.
//
// Row size: a renormalisation shift emits at most one bit (E1/E2 emit the
// bit and release pending bits, each of which an earlier E3 shift created
// without emitting), a step makes at most 16 shifts (the coded interval is
// at least 1 wide and doubles per shift within 16 bits), so a block of n
// symbols emits at most 16*(n+1) bits. With the 8-bit prepad the `.rsn`
// stream fits 16*(n+1)+8 bits; blocks whose stream would not fit `capw`
// words are flagged in `oflow` and their stores past the row are dropped.
#include "arith_common.cuh"

namespace {

using namespace rsn;

struct BitWriter {
    uint32_t* row;
    int capw;
    bool store;     // lane 0 stores; the other lanes keep the same state
    uint32_t acc;   // bits not yet stored, from bit 31 down
    int nb;         // bits in acc
    int widx;       // words completed (stored or past the row)

    __device__ __forceinline__ void run(uint32_t bit, int count) {
        while (count > 0) {
            const int take = min(count, 32 - nb);
            if (bit) {
                const uint32_t ones = take == 32 ? FULL_MASK : ((1u << take) - 1u);
                acc |= ones << (32 - nb - take);
            }
            nb += take;
            count -= take;
            if (nb == 32) {
                if (store && widx < capw) row[widx] = acc;
                ++widx;
                acc = 0;
                nb = 0;
            }
        }
    }
};

__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
arith_encode_kernel(const int32_t* __restrict__ symbols, const int32_t* __restrict__ lengths,
                    uint32_t* __restrict__ raw, int32_t* __restrict__ bits_out,
                    int32_t* __restrict__ oflow_out, int B, int S, int capw) {
    __shared__ uint32_t cum_all[WARPS_PER_CTA][CUM_STRIDE];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS_PER_CTA + warp;
    if (b >= B) return;  // the whole warp leaves; nothing below syncs the CTA

    uint32_t* cum = cum_all[warp];
    model_init(cum, lane);

    const int32_t* sym_row = symbols + (size_t)b * S;
    const int steps = min(lengths[b] + 1, S);  // payload symbols + EOF at n
    BitWriter w{raw + (size_t)b * capw, capw, lane == 0, 0u, 0, 0};
    uint32_t low = 0, high = MAX_CODE, count = 257;
    int pending = 0;
    bool frozen = false;
    int chunk = 0;

    for (int t = 0; t < steps; ++t) {
        // 32 symbols per coalesced load, handed out by shuffle
        if ((t & 31) == 0) {
            const int i = t + lane;
            chunk = i < S ? sym_row[i] : 0;
        }
        const int s = __shfl_sync(FULL_MASK, chunk, t & 31);
        encode_narrow(cum, lane, s, low, high, count, frozen);
        for (;;) {  // E1/E2/E3 renormalisation, arithmetic.go:115-163
            if (high < ONE_HALF) {
                w.run(0, 1);
                w.run(1, pending);
                pending = 0;
            } else if (low >= ONE_HALF) {
                w.run(1, 1);
                w.run(0, pending);
                pending = 0;
            } else if (low >= ONE_FOURTH && high < THREE_FOURTHS) {
                ++pending;
                low -= ONE_FOURTH;
                high -= ONE_FOURTH;
            } else {
                break;
            }
            high = ((high << 1) + 1) & MAX_CODE;
            low = (low << 1) & MAX_CODE;
        }
    }
    // trailing pending bits are dropped (no final flush, arithmetic_ref.py:108)
    const int total_bits = w.widx * 32 + w.nb;
    if (lane == 0) {
        if (w.nb > 0 && w.widx < capw) w.row[w.widx] = w.acc;
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
