// Kernel G: Huffman encode of B blocks into `.rsn` payload rows, one CTA per block.
//
// Replaces raisin_tpu/ops/huffman_pallas.py:_henc_kernel (via
// encode_rows_huffman) and its stitch and zero-prepad epilogue. Huffman
// encoding is no chain: symbol i's code starts at bit pad + (the sum of
// the code lengths before i), pad = (8 - bits % 8) % 8 zero bits in front
// (huffman.go:245-249). So the CTA first sums its block's code lengths
// (pass 1: the total, hence the pad), then walks the block in tiles of
// 4096 symbols (pass 2): a block-wide exclusive scan of the tile's code
// lengths gives every code's bit offset, each thread ORs its codes' bits
// into a shared-memory image of the tile's output words, and the words
// that the tile completed go to the row as big-endian words (stream bit 0
// is the most significant bit of byte 0). The last, partial word carries
// over to the next tile.
//
// The TPU kernel staged 64 words per 128 symbols, packed 26-bit table
// entries and flagged staging overflows; none of that carries over. Codes
// take up to 32 bits (a code of length L needs Fib(L + 2) symbols, so
// blocks under ~9.2 M symbols never exceed 32 bits; the host raises above).
// A byte >= 128 has no code here: the container sends non-ASCII blocks to
// the host oracle, as the JAX package does.
//
// What bounds it: bytes. It reads the block twice (~2 x 45 MB at the main
// path's shapes, the second time mostly from L2) and writes the payload
// once; per symbol a table lookup in shared memory, a scan step and one or
// two shared-memory atomics.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 8;
constexpr int TILE = THREADS * PER_THREAD;  // symbols per tile
constexpr int TILE_WORDS = TILE + 2;        // a tile's <= 32 * TILE bits span <= TILE + 1 words
constexpr int NSYM = 128;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t big_endian(uint32_t w) { return __byte_perm(w, 0, 0x0123); }

__global__ void __launch_bounds__(THREADS)
huffman_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ codes, const int32_t* __restrict__ code_lens,
                      uint32_t* __restrict__ rows, int32_t* __restrict__ byte_lens,
                      int32_t* __restrict__ pads, int S, int capw) {
    __shared__ uint32_t code_s[NSYM];
    __shared__ uint32_t len_s[NSYM];
    __shared__ uint32_t buf[TILE_WORDS];
    __shared__ long long warp_total[WARPS];
    __shared__ int warp_scan[WARPS];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int b = blockIdx.x;
    const int n = min(max(lengths[b], 0), S);
    const uint8_t* xb = x + (size_t)b * S;
    uint32_t* row = rows + (size_t)b * capw;

    for (int i = tid; i < NSYM; i += THREADS) {
        const int len = min(max(code_lens[b * NSYM + i], 0), 32);
        const uint32_t mask = len == 32 ? 0xFFFFFFFFu : ((1u << len) - 1u);
        len_s[i] = (uint32_t)len;
        code_s[i] = (uint32_t)codes[b * NSYM + i] & mask;
    }
    for (int i = tid; i < TILE_WORDS; i += THREADS) buf[i] = 0u;
    __syncthreads();

    // pass 1: the block's bit count, hence its pad
    long long local = 0;
    for (int i = tid; i < n; i += THREADS) {
        const int c = xb[i];
        local += c < NSYM ? len_s[c] : 0u;
    }
    for (int o = 16; o > 0; o >>= 1) local += __shfl_down_sync(FULL_MASK, local, o);
    if (lane == 0) warp_total[warp] = local;
    __syncthreads();
    long long total = 0;
    for (int w = 0; w < WARPS; ++w) total += warp_total[w];
    const int pad = (int)((8 - (total & 7)) & 7);
    if (tid == 0) {
        byte_lens[b] = (int32_t)((total + pad) >> 3);
        pads[b] = pad;
    }

    // pass 2: tiles of TILE symbols; buf[0] is row word (bitpos >> 5)
    long long bitpos = pad;
    for (int t0 = 0; t0 < n; t0 += TILE) {
        const long long base_word = bitpos >> 5;
        const int i0 = t0 + tid * PER_THREAD;
        uint32_t len[PER_THREAD], code[PER_THREAD];
        int mine = 0;
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
            const int i = i0 + k;
            const int c = i < n ? xb[i] : NSYM;
            len[k] = c < NSYM ? len_s[c] : 0u;
            code[k] = c < NSYM ? code_s[c] : 0u;
            mine += (int)len[k];
        }
        // block-wide exclusive scan of the threads' sums
        int incl = mine;
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(FULL_MASK, incl, o);
            if (lane >= o) incl += v;
        }
        if (lane == 31) warp_scan[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            const int v = lane < WARPS ? warp_scan[lane] : 0;
            int s = v;
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(FULL_MASK, s, o);
                if (lane >= o) s += u;
            }
            if (lane < WARPS) warp_scan[lane] = s - v;  // exclusive prefix of the warps
            if (lane == WARPS - 1) warp_total[0] = s;     // the tile's bits
        }
        __syncthreads();
        long long pos = bitpos + warp_scan[warp] + (incl - mine);
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
            const uint32_t l = len[k];
            if (l) {
                const int w = (int)((pos >> 5) - base_word);
                const int s = (int)(pos & 31);
                const unsigned long long v = (unsigned long long)code[k] << (64 - s - (int)l);
                atomicOr(&buf[w], (uint32_t)(v >> 32));
                const uint32_t lo = (uint32_t)v;
                if (lo) atomicOr(&buf[w + 1], lo);
                pos += l;
            }
        }
        const long long end = bitpos + warp_total[0];
        __syncthreads();
        // the words this tile completed go to the row; the partial one carries over
        const int full = (int)((end >> 5) - base_word);
        for (int j = tid; j < full; j += THREADS) {
            if (base_word + j < capw) row[base_word + j] = big_endian(buf[j]);
        }
        const uint32_t carry = (end & 31) ? buf[full] : 0u;
        __syncthreads();
        for (int j = tid; j <= full && j < TILE_WORDS; j += THREADS) buf[j] = 0u;
        __syncthreads();
        if (tid == 0) buf[0] = carry;
        __syncthreads();
        bitpos = end;
    }
    if (tid == 0 && (bitpos & 31) && (bitpos >> 5) < capw) row[bitpos >> 5] = big_endian(buf[0]);
}

}  // namespace

extern "C" int rsn_huffman_encode(const void* x, const void* lengths, const void* codes,
                                  const void* code_lens, void* rows, void* byte_lens, void* pads,
                                  int B, int S, int capw, void* stream) {
    huffman_encode_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const int32_t*)lengths, (const int32_t*)codes,
        (const int32_t*)code_lens, (uint32_t*)rows, (int32_t*)byte_lens, (int32_t*)pads, S, capw);
    return (int)cudaGetLastError();
}
