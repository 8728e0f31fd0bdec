// Kernel H: bit-serial Huffman decode of B payload rows, one CTA of one thread per block.
//
// Replaces raisin_tpu/ops/huffman_pallas.py:_hdec_kernel (via
// decode_rows_huffman) and its stitch. Each thread walks its block's tree
// one payload bit at a time, from bit `pad` (the leading pad bits are
// skipped) to the end of the payload: child = table[2 * node + bit]; a
// child >= 128 is a leaf, whose symbol (child - 128) goes out and sends the
// walk back to the root. The table is the JAX package's packed child table
// (64 words, read as 256 bytes), copied to shared memory. The decoded
// bytes go straight into the block's row, four to a word; symbols past the
// row's capacity are counted and not written. `ok` says whether the last
// bit completed a code (the walk ended at the root).
//
// The TPU kernel walked all blocks in lockstep with a masked sum over the
// table and read the payload from VMEM; here each block's bits come from
// device memory, one word ahead of the walk, so there is no payload-size
// gate.
//
// What bounds it: the latency of the walk, one dependent shared-memory load
// per bit (~4.4 bits a symbol on the main path's token streams). Blocks are
// independent; each gets a warp of its own, so no lane waits on another's
// leaf branch and the warps of an SM hide each other's latency (eight
// blocks in lockstep in one warp were slower on an H100).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TABLE_WORDS = 64;  // 128 internal nodes x 2 one-byte children
constexpr int NSYM = 128;

__device__ __forceinline__ uint32_t big_endian(uint32_t w) { return __byte_perm(w, 0, 0x0123); }

__global__ void __launch_bounds__(1)
huffman_decode_kernel(const uint8_t* __restrict__ payload, const int32_t* __restrict__ pads,
                      const int32_t* __restrict__ byte_lens, const int32_t* __restrict__ tables,
                      uint8_t* __restrict__ rows, int32_t* __restrict__ counts,
                      int32_t* __restrict__ ok, int capb, int cap) {
    __shared__ __align__(16) uint32_t table[TABLE_WORDS];
    const int b = blockIdx.x;
    for (int j = 0; j < TABLE_WORDS; ++j) table[j] = (uint32_t)tables[(size_t)b * TABLE_WORDS + j];
    const uint8_t* child = reinterpret_cast<const uint8_t*>(table);

    const long long pad = pads[b];
    const long long nbits = max(0LL, 8LL * min(max(byte_lens[b], 0), capb) - pad);
    const long long end = pad + nbits;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(payload + (size_t)b * capb);
    uint32_t* out = reinterpret_cast<uint32_t*>(rows + (size_t)b * cap);
    const long long out_words = cap / 4;

    uint32_t node = 0;
    bool at_root = true;
    long long cnt = 0;
    uint32_t acc = 0;
    long long t = pad;
    long long w = t >> 5;
    const long long last_word = (end - 1) >> 5;
    uint32_t cur = t < end ? words[w] : 0u;
    while (t < end) {
        const uint32_t next = w < last_word ? words[w + 1] : 0u;  // in flight during this word's walk
        const uint32_t bits = big_endian(cur);
        const int hi = (int)min(32LL, end - (w << 5));
        for (int k = (int)(t & 31); k < hi; ++k) {
            const uint32_t bit = (bits >> (31 - k)) & 1u;
            const uint32_t ch = child[2 * node + bit];
            if (ch >= NSYM) {
                acc |= (ch - NSYM) << (8 * (cnt & 3));
                if ((cnt & 3) == 3) {
                    if ((cnt >> 2) < out_words) out[cnt >> 2] = acc;
                    acc = 0;
                }
                ++cnt;
                node = 0;
                at_root = true;
            } else {
                node = ch;
                at_root = false;
            }
        }
        t = (w + 1) << 5;
        ++w;
        cur = next;
    }
    if ((cnt & 3) && (cnt >> 2) < out_words) out[cnt >> 2] = acc;
    counts[b] = (int32_t)cnt;
    ok[b] = at_root ? 1 : 0;
}

}  // namespace

extern "C" int rsn_huffman_decode(const void* payload, const void* pads, const void* byte_lens,
                                  const void* tables, void* rows, void* counts, void* ok, int B,
                                  int capb, int cap, void* stream) {
    huffman_decode_kernel<<<B, 1, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)payload, (const int32_t*)pads, (const int32_t*)byte_lens,
        (const int32_t*)tables, (uint8_t*)rows, (int32_t*)counts, (int32_t*)ok, capb, cap);
    return (int)cudaGetLastError();
}
