// Kernel B: prepend the `.rsn` prepad and lay each row out as bytes, loading each row's live words only.
//
// Replaces the XLA epilogue raisin_tpu/ops/arithmetic_pallas.py:_assemble_rows
// (the prepad shift, the final partial word and the byte swap). The stream
// of T raw bits gets pad = 8 - T%8 bits (1..8, pattern 0..01) in front
// (raisin_tpu/bitkit/packing.py:pack_prepad_sentinel), so every output word
// is a funnel shift of two neighbouring raw words; word -1 is the pattern 1.
//
// What bounds it: bytes. A row holds capw words, the worst case of 16 bits a
// coder step, but its stream fills only the first ceil((T + pad) / 32) (the
// live words; ~28% of the row on the corpus). The grid is 2D, a row a
// blockIdx.y (rows beyond the grid's height in strides) and chunks of the row
// along x, so no thread divides. Each thread takes a quad of four output
// words, aligned to 16 bytes in the output row: one 16-byte load of the four
// raw words where the raw row is aligned alike and the quad is live, one
// more load for the word before them, four funnel shifts and byte swaps, one
// 16-byte store. Quads at or past the live end are stored as zeros without a
// load, and no raw word at or past ceil(T / 32) is read; bits past T in the
// last live word are cleared. Quads cut by the row's ends take word by word
// loads and stores.
#include "arith_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int QUAD = 4;            // output words a thread: one 16-byte store
constexpr int MAX_GRID_Y = 65535;  // rows a launch's y dimension covers; the rest in strides

__device__ __forceinline__ uint32_t swapped(uint32_t prev, uint32_t cur, int pad) {
    return __byte_perm((prev << (32 - pad)) | (cur >> pad), 0, 0x0123);  // stream order = byte order
}

__global__ void __launch_bounds__(THREADS)
arith_prepad_kernel(const uint32_t* __restrict__ raw, const int32_t* __restrict__ bits,
                    uint32_t* __restrict__ rows, int32_t* __restrict__ byte_lens, int B, int capw) {
    for (int b = blockIdx.y; b < B; b += gridDim.y) {
        const int T = bits[b];
        const int pad = 8 - (T & 7);  // 8 when the stream is byte-aligned
        const uint32_t* src = raw + (size_t)b * capw;
        uint32_t* dst = rows + (size_t)b * capw;
        const int skew = (int)(((uintptr_t)dst >> 2) & 3);  // the row's words before its first 16-byte boundary
        const int q = blockIdx.x * THREADS + threadIdx.x;
        const int j0 = QUAD * q - skew;  // the quad's first word in the row
        if (j0 >= capw) continue;
        if (q == 0) byte_lens[b] = (T + pad) >> 3;
        // raw words that hold stream bits, and output words that do
        const long long live_raw = T > 0 ? min((T + 31LL) >> 5, (long long)capw) : 0;
        const long long live_out = min(max((T + pad + 31LL) >> 5, 1LL), (long long)capw);
        // raw word i with the bits at and past T cleared; word -1 is the pattern
        auto word = [&](long long i) -> uint32_t {
            if (i < 0) return i == -1 ? 1u : 0u;
            if (i >= live_raw) return 0u;
            const uint32_t w = src[i];
            const long long keep = T - 32 * i;
            return keep < 32 ? w & ~(0xFFFFFFFFu >> keep) : w;
        };
        uint32_t out[QUAD] = {0u, 0u, 0u, 0u};
        if (j0 < live_out) {
            uint32_t cur[QUAD];
            if (j0 >= 0 && j0 + QUAD <= live_raw && (((uintptr_t)(src + j0) & 15) == 0)) {
                const uint4 v = *reinterpret_cast<const uint4*>(src + j0);
                cur[0] = v.x;
                cur[1] = v.y;
                cur[2] = v.z;
                cur[3] = v.w;
                const long long keep = T - 32LL * (j0 + QUAD - 1);  // only the quad's last word can hold T
                if (keep < 32) cur[QUAD - 1] &= ~(0xFFFFFFFFu >> keep);
            } else {
#pragma unroll
                for (int k = 0; k < QUAD; ++k) cur[k] = j0 + k < live_out ? word(j0 + k) : 0u;
            }
            uint32_t prev = word(j0 - 1);
#pragma unroll
            for (int k = 0; k < QUAD; ++k) {
                out[k] = j0 + k < live_out ? swapped(prev, cur[k], pad) : 0u;
                prev = cur[k];
            }
        }
        if (j0 >= 0 && j0 + QUAD <= capw) {
            *reinterpret_cast<uint4*>(dst + j0) = make_uint4(out[0], out[1], out[2], out[3]);
        } else {
#pragma unroll
            for (int k = 0; k < QUAD; ++k)
                if (j0 + k >= 0 && j0 + k < capw) dst[j0 + k] = out[k];
        }
    }
}

}  // namespace

extern "C" int rsn_arith_prepad(const void* raw, const void* bits, void* rows, void* byte_lens,
                                int B, int capw, void* stream) {
    const long long quads = (capw + 3LL + QUAD - 1) / QUAD;  // a row's quads at the largest skew
    const dim3 grid((unsigned)((quads + THREADS - 1) / THREADS), (unsigned)(B < MAX_GRID_Y ? B : MAX_GRID_Y));
    arith_prepad_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)raw, (const int32_t*)bits, (uint32_t*)rows, (int32_t*)byte_lens, B, capw);
    return (int)cudaGetLastError();
}
