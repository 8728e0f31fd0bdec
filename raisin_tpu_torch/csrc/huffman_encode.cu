// Kernel G: Huffman encode of B blocks into `.rsn` payload rows, every tile of every block at once.
//
// Replaces raisin_tpu/ops/huffman_pallas.py:_henc_kernel (via
// encode_rows_huffman) and its stitch and zero-prepad epilogue. Huffman
// encoding is no chain: symbol i's code starts at bit pad + (the sum of
// the code lengths before i), pad = (8 - bits % 8) % 8 zero bits in front
// (huffman.go:245-249), and the caller already knows each block's bit total
// `bits` from the counts it built the tree from. So the grid covers every
// (block, tile) of TILE symbols at once, each block is read once, and a
// tile's bit offset within its block comes from a chained scan over the
// block's tiles, a single-pass decoupled look-back: a tile publishes its own
// bit count (its aggregate) as soon as it has summed its code lengths, then
// its inclusive prefix once it knows its offset; a tile that looks back sums
// aggregates until it meets an inclusive prefix. Tiles take their (block,
// tile) from an atomic ticket in block-major order, so every tile one waits
// on has started; a tile past its block's last symbol returns at once.
//
// Inside a tile each thread loads PER_THREAD consecutive symbols with 16-byte
// loads (byte loads where the row is not 16-byte aligned, or where the block
// ends), looks up their lengths in the block's tables in shared memory (256
// entries, so a byte >= 128 reads a zero entry; lengths as bytes and codes as
// words, so that a warp's lookups of text hit distinct banks), and a scan of
// the threads' bit counts gives each thread its first bit within the tile.
// Each thread builds its codes, left-aligned in the table, in a 64-bit
// register window into an image of the tile's bits in shared memory that
// starts on a word boundary. A word of the image belongs to the thread whose
// bits include its first bit, which stores it whole, zeros past its own bits
// included; a thread whose first bit lies inside a word keeps its bits there
// (its head) and ORs them in after a barrier, so the image is never zeroed.
// The image needs no offset from the look-back, so warps 1.. build while
// warp 0 looks back. Then the
// CTA writes the image to the row, shifted right by the tile's offset within
// its first word and byte-swapped to big-endian words (stream bit 0 is the
// most significant bit of byte 0): inner words by plain coalesced stores,
// the first and the last word, which the neighbouring tiles share, by global
// atomicOr into the zeroed row (OR commutes with the byte swap). Words past
// `capw` are dropped. The last tile of a block writes byte_lens and pads
// from the scan's own total, that total, and counts the blocks whose total
// differs from `bits`; the wrapper reads that count and raises.
//
// The TPU kernel staged 64 words per 128 symbols, packed 26-bit table
// entries and flagged staging overflows; none of that carries over. Codes
// take up to 32 bits (a code of length L needs Fib(L + 2) symbols, so
// blocks under ~9.2 M symbols never exceed 32 bits; the host raises above).
// A byte >= 128 has no code here: the container sends non-ASCII blocks to
// the host oracle, as the JAX package does. Bit positions are 64-bit: a
// block of 2^27 symbols of 32-bit codes passes 2^32 bits.
//
// What bounds it: bytes, ~70 MB at the main path's shapes (the blocks read
// once, the payload written once). What sets its pace on the H100 is
// instructions, ~20 a symbol: two passes of table lookups, the window's
// 64-bit shift and OR, and the store of a finished word, which some lane of
// each warp makes at almost every step. Taking the look-back and the ticket
// away moved its time little (PERF.md). CTAs of 128 threads, 12 an SM.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MIN_CTAS = 12;                // CTAs an SM that the registers must allow: <= 42 registers a thread
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 32;              // symbols a thread: two 16-byte loads
constexpr int TILE = THREADS * PER_THREAD;  // symbols a tile
constexpr int IMAGE_WORDS = TILE;          // a tile's <= 32 * TILE bits
constexpr int NSYM = 128;
constexpr int TABLE = 256;                  // a byte's entry; those >= NSYM have no code
constexpr uint8_t NO_CODE = 0x80;           // the byte that stands for a position past the block
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
// a tile's status word: a flag in the top two bits, a bit count below them
constexpr unsigned long long AGGREGATE = 1ull << 62;  // the tile's own bits
constexpr unsigned long long INCLUSIVE = 2ull << 62;  // the bits of the block's tiles up to this one
constexpr unsigned long long VALUE = AGGREGATE - 1;

__device__ __forceinline__ uint32_t big_endian(uint32_t w) { return __byte_perm(w, 0, 0x0123); }

__device__ __forceinline__ void publish(unsigned long long* status, unsigned long long v) {
    *(volatile unsigned long long*)status = v;
}

// The bits of the block's tiles before tile t (one warp): the status words of
// tiles t - 1, t - 2, ... 32 at a time, each lane spinning until its tile has
// published; the nearest inclusive prefix ends the walk.
__device__ long long look_back(unsigned long long* block_status, int t, int lane) {
    long long prefix = 0;
    for (int look = t - 1;; look -= 32) {
        const int i = look - lane;
        unsigned long long s = INCLUSIVE;  // before the block's first tile: 0 bits
        if (i >= 0) {
            do {
                s = *(volatile unsigned long long*)(block_status + i);
            } while (s < AGGREGATE);
        }
        const unsigned done = __ballot_sync(FULL_MASK, s >= INCLUSIVE);
        const int upto = done ? __ffs((int)done) - 1 : 31;  // lanes 0..upto count
        unsigned long long v = lane <= upto ? (s & VALUE) : 0ull;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
        prefix += (long long)v;
        if (done) return prefix;
    }
}

__device__ __forceinline__ uint32_t symbol(const uint32_t* w, int k) { return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu; }

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
huffman_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ codes, const int32_t* __restrict__ code_lens,
                      const long long* __restrict__ bits, uint32_t* rows, int32_t* __restrict__ byte_lens,
                      int32_t* __restrict__ pads, long long* __restrict__ totals,
                      unsigned long long* status, unsigned* ticket, int S, int capw, int tiles) {
    __shared__ uint32_t code_of[TABLE];  // each byte's code, left-aligned in its word (0: no code)
    __shared__ uint8_t len_of[TABLE];    // and its length
    __shared__ uint32_t image[IMAGE_WORDS];
    __shared__ int warp_bits[WARPS];
    __shared__ int tile_id;
    __shared__ long long tile_start;  // the row bit of the image's bit 0 (pad included)

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) tile_id = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    const int b = tile_id / tiles;
    const int t = tile_id - b * tiles;
    const long long n = min(max(lengths[b], 0), S);
    const int last = n > 0 ? (int)((n - 1) / TILE) : 0;  // the block's last tile with symbols
    if (t > last) return;  // past the block: no tile waits on this one

    // this thread's PER_THREAD symbols, four to a word, little-endian
    const long long i0 = (long long)t * TILE + tid * PER_THREAD;
    const uint8_t* src = x + (size_t)b * S + i0;
    uint32_t w[PER_THREAD / 4];
    if (i0 + PER_THREAD <= n && ((uintptr_t)src & 15) == 0) {
#pragma unroll
        for (int q = 0; q < PER_THREAD / 16; ++q) {
            const uint4 v = reinterpret_cast<const uint4*>(src)[q];
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < PER_THREAD / 4; ++q) {
            uint32_t word = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const long long i = i0 + 4 * q + k;
                word |= (uint32_t)(i < n ? src[4 * q + k] : NO_CODE) << (8 * k);
            }
            w[q] = word;
        }
    }
    for (int i = tid; i < TABLE; i += THREADS) {
        const int len = i < NSYM ? min(max(code_lens[b * NSYM + i], 0), 32) : 0;
        code_of[i] = len ? (uint32_t)codes[b * NSYM + i] << (32 - len) : 0u;
        len_of[i] = (uint8_t)len;
    }
    __syncthreads();

    int mine = 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) mine += len_of[symbol(w, k)];
    // the tile's scan of the threads' bit counts
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) warp_bits[warp] = incl;
    __syncthreads();
    int first = incl - mine;  // the thread's first bit in the image
    int tile_bits = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
        const int s = warp_bits[k];
        first += k < warp ? s : 0;
        tile_bits += s;
    }

    if (warp == 0) {
        unsigned long long* block_status = status + (size_t)b * tiles;
        long long prefix = 0;
        if (t == 0) {
            if (lane == 0) publish(block_status, INCLUSIVE | (unsigned long long)tile_bits);
        } else {
            if (lane == 0) publish(block_status + t, AGGREGATE | (unsigned long long)tile_bits);
            prefix = look_back(block_status, t, lane);
            if (lane == 0) publish(block_status + t, INCLUSIVE | (unsigned long long)(prefix + tile_bits));
        }
        if (lane == 0) {
            tile_start = ((8 - (bits[b] & 7)) & 7) + prefix;
            if (t == last) {
                const long long total = prefix + tile_bits;
                const int pad = (int)((8 - (total & 7)) & 7);
                byte_lens[b] = (int32_t)((total + pad) >> 3);
                pads[b] = pad;
                totals[b] = total;
                if (total != bits[b]) atomicAdd(ticket + 1, 1u);  // the wrapper reads this count
            }
        }
    }

    // the thread's codes into the image. A word belongs to the thread whose
    // bits include its first bit: that thread stores it, zeros past its own
    // bits included; a thread whose first bit lies inside a word keeps its
    // bits there (its head) and ORs them in once every word is stored
    uint32_t head = 0;
    if (mine) {
        int wi = first >> 5;
        int fill = first & 31;  // bits in the window, the zeros before the thread's first
        bool owned = fill == 0;
        unsigned long long acc = 0;  // the window, its first bit the most significant
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
            const uint32_t c = symbol(w, k);
            acc |= ((unsigned long long)code_of[c] << 32) >> fill;
            fill += len_of[c];
            if (fill >= 32) {
                const uint32_t word = (uint32_t)(acc >> 32);
                if (owned) image[wi] = word;
                else head = word;
                owned = true;
                acc <<= 32;
                fill -= 32;
                ++wi;
            }
        }
        if (fill) {
            if (owned) image[wi] = (uint32_t)(acc >> 32);
            else head = (uint32_t)(acc >> 32);
        }
    }
    __syncthreads();
    if (mine && (first & 31)) atomicOr(&image[first >> 5], head);
    __syncthreads();

    // the image to the row, shifted right by the tile's offset in its first word
    if (tile_bits == 0) return;
    const long long start = tile_start;
    const int s = (int)(start & 31);
    const long long g0 = start >> 5;
    const int used = (tile_bits + 31) >> 5;  // the image's words
    const int words = (s + tile_bits + 31) >> 5;
    const bool open_end = ((s + tile_bits) & 31) != 0;  // the next tile's bits share the last word
    uint32_t* row = rows + (size_t)b * capw;
    for (int j = tid; j < words && g0 + j < capw; j += THREADS) {
        const uint32_t lo = j < used ? image[j] : 0u;
        const uint32_t v = s ? (j ? image[j - 1] << (32 - s) : 0u) | (lo >> s) : lo;
        if ((j == 0 && s) || (j == words - 1 && open_end)) atomicOr(row + g0 + j, big_endian(v));
        else row[g0 + j] = big_endian(v);
    }
}

}  // namespace

extern "C" int rsn_huffman_encode(const void* x, const void* lengths, const void* codes,
                                  const void* code_lens, const void* bits, void* rows,
                                  void* byte_lens, void* pads, void* totals, void* work, int B,
                                  int S, int capw, void* stream) {
    // work: a zeroed status word for each of the B * tiles tiles, then a word
    // of two counts: the ticket, and the blocks whose total differs from bits
    const int tiles = S > 0 ? (S + TILE - 1) / TILE : 1;
    const long long grid = (long long)B * tiles;
    unsigned long long* status = (unsigned long long*)work;
    huffman_encode_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const int32_t*)lengths, (const int32_t*)codes,
        (const int32_t*)code_lens, (const long long*)bits, (uint32_t*)rows, (int32_t*)byte_lens,
        (int32_t*)pads, (long long*)totals, status, (unsigned*)(status + grid), S, capw, tiles);
    return (int)cudaGetLastError();
}
