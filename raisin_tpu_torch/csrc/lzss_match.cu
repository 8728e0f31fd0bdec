// Kernel D: exact per-position greedy longest match (LZSS match search).
//
// Replaces raisin_tpu/ops/lzss_jax.py:_match_scan (an XLA lax.scan, via
// find_matches_blocks). For every position i of a block and every distance
// d in 1..window, the capped forward run c = min(run, d) obeys, walking
// positions downwards,
//     c[i][d] = (x[i] == x[i-d]) ? min(c[i+1][d] + 1, d) : 0,
// and the match is the max over d of the key (c << 16) | d: the longest
// capped run, ties to the largest distance (the leftmost occurrence). Runs
// stop at the block's length n (positions >= n never compare equal) and at
// i - d < 0 (masked; the JAX scan pads with sentinels instead).
//
// What bounds it: integer work, about n * window capped-run updates per
// block (2.7e11 for 1024 blocks of 64 KiB at window 4096). The design keeps
// every operand on chip: one CTA per block, the block's bytes in shared
// memory (an escaped 64 KiB block is at most 128 KiB; longer blocks read
// device memory through L1), each lane owning KG = 4 consecutive distances
// with their capped runs in registers, and each warp walking the positions
// of a tile downwards. Shared-memory loads were the limit, so each lane
// keeps the bytes x[i - d] of its 4 distances in one register, shifted by
// one byte per position: two loads per position (x[i] and one new byte)
// instead of five. Per position a warp folds its lanes' keys with one
// __reduce_max_sync; every 32 positions each lane merges the key of one
// position into a shared tile of per-position best keys with atomicMax, and
// the tile goes to device memory once. Windows wider than one pass of the
// CTA's distances (warps * KG * 32 = 4096) run more passes, keeping the
// best keys of earlier passes in the L output between passes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int KG = 4;          // distances per lane and pass
constexpr int MAX_WARPS = 32;  // 1024 threads: 4096 distances per pass
constexpr int TILE = 4096;     // positions per shared tile of best keys
constexpr int SMEM_LIMIT = 227 * 1024;

// One position of a warp's walk: the lanes' best keys folded into the
// shared tile, every 32 positions, by the lane that owns each position.
__device__ __forceinline__ void fold_key(uint32_t m, int i, int lo, int lane, uint32_t& mine,
                                         uint32_t* best) {
    m = __reduce_max_sync(FULL_MASK, m);
    if ((i & 31) == lane) mine = m;
    if ((i & 31) == 0 || i == lo) {
        if (mine >> 16) atomicMax(&best[(i & ~31) + lane - lo], mine);  // c > 0: a match
        mine = 0u;
    }
}

template <bool kSmemX>
__global__ void __launch_bounds__(MAX_WARPS * 32)
lzss_match_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lengths,
                  int32_t* __restrict__ L, int32_t* __restrict__ D, int S, int window) {
    extern __shared__ uint32_t smem[];
    uint32_t* best = smem;                          // TILE keys
    uint8_t* xs_shared = (uint8_t*)(smem + TILE);   // the block's bytes
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int nwarps = nthreads >> 5;
    const int n = min(max(lengths[b], 0), S);
    const uint8_t* xrow = x + (size_t)b * S;
    int32_t* Lrow = L + (size_t)b * S;
    int32_t* Drow = D + (size_t)b * S;

    const uint8_t* xs = xrow;
    if (kSmemX) {
        for (int i = tid; i < n; i += nthreads) xs_shared[i] = xrow[i];
        xs = xs_shared;
    }
    for (int i = n + tid; i < S; i += nthreads) {  // past the length: (0, 0)
        Lrow[i] = 0;
        Drow[i] = 0;
    }
    const int maxd = min(window, n - 1);
    if (maxd <= 0) {  // uniform across the CTA
        for (int i = tid; i < n; i += nthreads) {
            Lrow[i] = 0;
            Drow[i] = 0;
        }
        return;
    }
    __syncthreads();

    const int per_pass = nwarps * KG * 32;
    const int passes = (maxd + per_pass - 1) / per_pass;
    for (int pass = 0; pass < passes; ++pass) {
        const bool last = pass == passes - 1;
        // lane l of warp w owns the KG consecutive distances dbase .. dbase + KG - 1
        const int dbase = pass * per_pass + (warp * 32 + lane) * KG + 1;
        const int wtop = pass * per_pass + (warp + 1) * 32 * KG;  // the warp's largest distance
        const bool idle = pass * per_pass + warp * 32 * KG + 1 > maxd;
        uint32_t cap[KG];  // the run cap: d, or 0 for distances past maxd (never match)
        uint32_t c[KG];
#pragma unroll
        for (int k = 0; k < KG; ++k) {
            cap[k] = dbase + k <= maxd ? (uint32_t)(dbase + k) : 0u;
            c[k] = 0u;
        }

        for (int hi = n; hi > 0; hi -= TILE) {
            const int lo = max(0, hi - TILE);
            for (int i = lo + tid; i < hi; i += nthreads) best[i - lo] = pass == 0 ? 0u : (uint32_t)Lrow[i];
            __syncthreads();
            if (!idle) {
                // the best key of position (i & ~31) + lane; a key below
                // 1 << 16 has c = 0, no match
                uint32_t mine = 0u;
                int i = hi - 1;
                // positions i >= wtop: i - d >= 0 for all the warp's
                // distances, and byte k of w is x[i - dbase - k], so each
                // position loads one new byte per lane instead of KG
                const int fast_lo = max(lo, wtop);
                if (i >= fast_lo) {
                    uint32_t w = 0u;
#pragma unroll
                    for (int k = 1; k < KG; ++k) w |= (uint32_t)xs[hi - dbase - k] << (8 * k);
                    for (; i >= fast_lo; --i) {
                        w = (w >> 8) | ((uint32_t)xs[i - dbase - (KG - 1)] << (8 * (KG - 1)));
                        const uint32_t diff = w ^ (xs[i] * 0x01010101u);  // byte k zero: x[i] == x[i - d]
                        uint32_t m = 0u;
#pragma unroll
                        for (int k = 0; k < KG; ++k) {
                            const bool eq = ((diff >> (8 * k)) & 0xFFu) == 0u;
                            c[k] = eq ? min(c[k] + 1u, cap[k]) : 0u;
                            m = max(m, (c[k] << 16) | (uint32_t)(dbase + k));
                        }
                        fold_key(m, i, lo, lane, mine, best);
                    }
                }
                for (; i >= lo; --i) {  // near the block start: check i - d >= 0
                    const uint32_t xi = xs[i];
                    uint32_t m = 0u;
#pragma unroll
                    for (int k = 0; k < KG; ++k) {
                        const int j = i - dbase - k;
                        const bool eq = j >= 0 && xs[j] == xi;
                        c[k] = eq ? min(c[k] + 1u, cap[k]) : 0u;
                        m = max(m, (c[k] << 16) | (uint32_t)(dbase + k));
                    }
                    fold_key(m, i, lo, lane, mine, best);
                }
            }
            __syncthreads();
            for (int i = lo + tid; i < hi; i += nthreads) {
                const uint32_t key = best[i - lo];
                if (last) {
                    Lrow[i] = (int32_t)(key >> 16);
                    Drow[i] = (int32_t)(key & 0xFFFFu);
                } else {
                    Lrow[i] = (int32_t)key;
                }
            }
            __syncthreads();
        }
    }
}

}  // namespace

extern "C" int rsn_lzss_match(const void* x, const void* lengths, void* L, void* D, int B, int S,
                              int window, void* stream) {
    const int reach = window < S - 1 ? window : S - 1;  // distances any position can use
    int warps = (reach + KG * 32 - 1) / (KG * 32);
    warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
    const size_t tile_bytes = TILE * sizeof(uint32_t);
    const size_t x_bytes = ((size_t)S + 15) / 16 * 16;
    const bool smem_x = tile_bytes + x_bytes <= (size_t)SMEM_LIMIT;
    const size_t smem = tile_bytes + (smem_x ? x_bytes : 0);
    cudaError_t err;
    if (smem_x) {
        err = cudaFuncSetAttribute(lzss_match_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        lzss_match_kernel<true><<<B, warps * 32, smem, (cudaStream_t)stream>>>(
            (const uint8_t*)x, (const int32_t*)lengths, (int32_t*)L, (int32_t*)D, S, window);
    } else {
        err = cudaFuncSetAttribute(lzss_match_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        lzss_match_kernel<false><<<B, warps * 32, smem, (cudaStream_t)stream>>>(
            (const uint8_t*)x, (const int32_t*)lengths, (int32_t*)L, (int32_t*)D, S, window);
    }
    return (int)cudaGetLastError();
}
