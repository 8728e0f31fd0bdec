// Kernel H: Huffman decode of B payload rows, each row's bits decoded in parallel.
//
// Replaces raisin_tpu/ops/huffman_pallas.py:_hdec_kernel (:211, via
// decode_rows_huffman) and its stitch. Row b's payload bits run MSB-first
// from bit pads[b] for nbits = 8 * min(byte_lens[b], capb) - pads[b] bits;
// each code is a walk of the block's tree from the root, child =
// table[2 * node + bit] over the JAX package's packed child table (64
// words, read as 256 bytes), a child >= 128 the leaf of symbol child - 128.
// Outputs: the decoded bytes (those at or past the row's capacity are
// counted and not written), their count, and ok = 1 when the walk from bit
// 0 ends exactly at nbits on a code boundary. A code that has no leaf
// within MAX_CODE bits, or runs past nbits, ends the walk (not counted).
//
// The parent kernel was one thread a block walking the tree a bit at a
// time: a dependent shared-memory load per bit, one SM for a single stream.
// Here the dependent chain is one table load a code, and a block's bits are
// split into subsequences of SUB_BITS bits, one thread each, SPAN_SUBS
// subsequences a CTA (a span), so a block runs on many threads and a
// single stream on many SMs. Huffman codes resynchronise: two walks from
// different bits soon reach a common code boundary, after which they are
// the same walk. So a call launches three kernels over a workspace of a
// few words a subsequence:
// 1. huffman_decode_kernel_spec, a CTA a span: each thread walks its
//    subsequence from the first multiple of the block's code lattice (the
//    gcd of its code lengths, so every code boundary is one) at its first
//    bit: the speculation. It keeps the exit (the end of the last code that
//    starts inside it), its code count and its entry. Then, inside the CTA,
//    each subsequence whose entry differs from the exit of the one before
//    re-walks from that exit, in lockstep with its previous walk, until the
//    two meet on a boundary (the rest and the exit stand, the count is
//    corrected) or the subsequence ends; in rounds until no entry changes.
//    The span's first entry is itself a speculation for every span but a
//    block's first.
// 2. huffman_decode_kernel_chain, a CTA a block: over the block's spans in
//    order, a span whose first entry differs from the previous span's true
//    exit repeats that repair from the true exit; an exclusive scan of the
//    true counts gives each subsequence's output offset; the total is the
//    block's count and ok compares the last exit with nbits.
// 3. huffman_decode_kernel_write, a CTA a span: each thread decodes its
//    true codes again and stores its symbols at its offset, sixteen to a
//    store (atomicOr into the two chunks it shares with its neighbours).
// A step takes the top LUT_BITS bits of a 64-bit buffer (refilled a word
// at a time from a word loaded ahead) and loads one entry of a per-CTA
// table built from the child table: a leaf's symbol and depth, or the
// internal node reached after LUT_BITS bits, from which a longer code goes
// on bit by bit. Bit positions are 32-bit, counted from the span's first
// word. Passes 1 and 3 stage their span's payload words in shared
// memory (one padding word every 32, so that lanes SUB_BITS apart read
// distinct banks); reads past the staged words go to device memory.
//
// What bounds it: each thread's chain from one code to the next, a table
// load and a shift (~4.4 bits a code on the main path's token streams,
// nearly all within LUT_BITS), and at the container's shape the issue slots
// that ~40 warps an SM share; passes 1 and 3 each decode every code once,
// the write also storing. A single stream's pass 2 walks its spans one
// after another in one CTA, each repair meeting the old walk within a few
// codes. Codes of one length k > 1 never resynchronise (uniform random
// ASCII's 7 bits): the lattice puts every speculation on a true boundary,
// so they need no repair. Other codes that never resynchronise would cost
// up to a round a subsequence of their span, each a walk of SUB_BITS bits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TABLE_WORDS = 64;  // 128 internal nodes x 2 one-byte children
constexpr int NSYM = 128;
constexpr int MAX_CODE = 128;           // longest code the walk takes (the plain version's bound)
constexpr int LUT_BITS = 10;            // bits a table step peeks
constexpr int SUB_BITS = 1024;          // bits a subsequence, one thread's
constexpr int SPAN_SUBS = 256;          // subsequences a span, one CTA's threads
constexpr int SPAN_BITS = SUB_BITS * SPAN_SUBS;
constexpr int STAGE_WORDS = SPAN_BITS / 32 + 16;  // the span's words, plus codes running past its end
constexpr int STAGE_SLOTS = STAGE_WORDS + STAGE_WORDS / 32 + 1;
constexpr uint32_t DEAD = 0xFFFFFFFFu;  // the walk ended inside a code
constexpr uint32_t FAR = 0x7FFFFFFFu;   // past every bit a span reads

// A CTA's tables and staged words. Declared here and not behind pointers, so that
// their loads are plain shared-memory loads with constant addresses.
__shared__ __align__(16) uint8_t child[4 * TABLE_WORDS];  // the packed child table's bytes
__shared__ uint16_t lut[1 << LUT_BITS];  // depth << 8 | symbol, or an internal node after LUT_BITS bits
__shared__ uint32_t stage[STAGE_SLOTS];  // the span's words, byte-swapped, word k at slot k + k / 32
__shared__ uint32_t exits[SPAN_SUBS];    // the repair's exits, a subsequence each

__device__ __forceinline__ uint32_t big_endian(uint32_t w) { return __byte_perm(w, 0, 0x0123); }

// Span c of block b. Bit positions inside a span are 32-bit and count from the
// row's word lo = (pad + c * SPAN_BITS) / 32: block bit p is span bit
// p - c * SPAN_BITS + (pad & 31), so the span's bits start at `skew` = pad & 31.
struct Span {
    const uint32_t* row;  // the row's words from word lo
    uint32_t row_words;   // how many there are
    uint32_t skew;
    uint32_t nbits;       // the block's end in span bits, at most FAR
    long long first;      // block bit of the span's first bit
};

__device__ Span span_of(const uint8_t* payload, const int32_t* pads, const int32_t* byte_lens, int b, int capb,
                        int c, long long& nbits) {
    const long long pad = pads[b];
    nbits = max(0LL, 8LL * min(max(byte_lens[b], 0), capb) - pad);
    const long long first = (long long)c * SPAN_BITS;
    const long long lo = (pad + first) >> 5;
    const uint32_t skew = (uint32_t)(pad + first - 32 * lo);
    const long long words = capb / 4;
    return {reinterpret_cast<const uint32_t*>(payload + (size_t)b * capb) + lo, (uint32_t)max(0LL, words - lo), skew,
            (uint32_t)min(max(nbits - first + skew, 0LL), (long long)FAR), first};
}

// A span's decoder: its words, the first n of them staged (one padding slot every 32
// words, so that lanes SUB_BITS apart read distinct banks), and the CTA's tables.
struct Decoder {
    Span sp;
    uint32_t n;

    __device__ __forceinline__ uint32_t word(uint32_t k) const {
        if (k < n) return stage[k + (k >> 5)];
        return k < sp.row_words ? big_endian(__ldg(sp.row + k)) : 0u;
    }

    // 64 bits from span bit r, the first the most significant
    __device__ __forceinline__ unsigned long long window(uint32_t r) const {
        const uint32_t w = r >> 5;
        const unsigned long long v = ((unsigned long long)word(w) << 32) | word(w + 1);
        return v << (r & 31);
    }

    // A code at span bit r with no leaf within LUT_BITS bits, from the node they reach, a
    // bit at a time: the bit after it and its symbol, or DEAD
    __device__ uint32_t long_code(uint32_t r, uint32_t node, uint32_t& sym) const {
        for (uint32_t d = LUT_BITS;; ++d) {
            if (d >= MAX_CODE || r + d >= sp.nbits) return DEAD;
            const uint32_t ch = child[2 * node + (uint32_t)(window(r + d) >> 63)];
            if (ch >= NSYM) {
                sym = ch - NSYM;
                return r + d + 1;
            }
            node = ch;
        }
    }
};

// A walk's bit supply: the bits from span bit r at the top of buf, `have` of them
// (at least 32 between codes), and the word after them loaded ahead, so that the
// chain from one code to the next is a table load and a shift.
struct Reader {
    uint32_t r, have, next, ahead;  // next: the index of the word after `ahead`
    unsigned long long buf;

    __device__ __forceinline__ void start(const Decoder& dec, uint32_t at) {
        const uint32_t w = at >> 5;
        r = at;
        buf = (((unsigned long long)dec.word(w) << 32) | dec.word(w + 1)) << (at & 31);
        have = 64 - (at & 31);
        ahead = dec.word(w + 2);
        next = w + 3;
    }

    // The code at r < dec.sp.nbits: r moves past it (to DEAD if it runs off), sym is its symbol
    __device__ __forceinline__ void code(const Decoder& dec, uint32_t& sym) {
        const uint32_t e = lut[buf >> (64 - LUT_BITS)];
        const uint32_t len = e >> 8;
        if (len == 0) {  // longer than LUT_BITS: the supply restarts after it
            const uint32_t q = dec.long_code(r, e, sym);
            if (q == DEAD) {
                r = DEAD;
            } else {
                start(dec, q);
            }
            return;
        }
        sym = e & 0xFFu;
        r = r + len <= dec.sp.nbits ? r + len : DEAD;
        buf <<= len;
        have -= len;
        if (have < 32) {
            buf |= (unsigned long long)ahead << (32 - have);
            have += 32;
            ahead = dec.word(next++);
        }
    }
};

// Block b's packed child table and LUT_BITS table, built by the CTA. With `lattice`,
// returns the greatest common divisor of the depths of the leaves reached from the root
// (0 when none is): every code boundary of the block is a multiple of it.
__device__ uint32_t build_tables(const int32_t* tables, int b, bool lattice) {
    __shared__ uint8_t depth[NSYM];      // of the internal nodes reached so far, 0xFF: not yet
    __shared__ uint32_t leaf_depths[5];  // bit d: a leaf at depth d (d <= MAX_CODE)
    const unsigned t = threadIdx.x;
    if (t < TABLE_WORDS) reinterpret_cast<uint32_t*>(child)[t] = (uint32_t)tables[(size_t)b * TABLE_WORDS + t];
    if (t < NSYM) depth[t] = t == 0 ? 0 : 0xFF;
    if (t < 5) leaf_depths[t] = 0;
    __syncthreads();
    for (int i = t; i < (1 << LUT_BITS); i += blockDim.x) {
        uint32_t node = 0;
        uint16_t ent = 0;
        int d = 0;
        for (; d < LUT_BITS; ++d) {
            const uint32_t ch = child[2 * node + ((i >> (LUT_BITS - 1 - d)) & 1)];
            if (ch >= NSYM) {
                ent = (uint16_t)((d + 1) << 8 | (ch - NSYM));
                break;
            }
            node = ch;
        }
        lut[i] = d == LUT_BITS ? (uint16_t)node : ent;
    }
    if (!lattice) return 0;
    for (int level = 0; level < NSYM; ++level) {  // the tree from the root, a level a round
        bool grew = false;
        if (t < NSYM && depth[t] == level) {
            for (int bit = 0; bit < 2; ++bit) {
                const uint32_t ch = child[2 * t + bit];
                if (ch >= NSYM) {
                    atomicOr(&leaf_depths[(level + 1) >> 5], 1u << ((level + 1) & 31));
                } else if (depth[ch] == 0xFF) {
                    depth[ch] = (uint8_t)(level + 1);
                    grew = true;
                }
            }
        }
        if (!__syncthreads_or(grew)) break;
    }
    uint32_t g = 0;
    for (int k = 0; k < 5; ++k) {
        for (uint32_t m = leaf_depths[k]; m; m &= m - 1) {
            uint32_t a = 32 * k + __ffs(m) - 1, r = g;
            while (r) {
                const uint32_t q = a % r;
                a = r;
                r = q;
            }
            g = a;
        }
    }
    return g;
}

// Span bit of the first multiple of the code lattice at or after block bit p (p itself without a lattice)
__device__ __forceinline__ uint32_t on_lattice(const Span& sp, long long p, uint32_t lattice) {
    if (lattice > 1) p = (p + lattice - 1) / lattice * lattice;
    return (uint32_t)(p - sp.first + sp.skew);
}

// Stage the span's words (and a few past them) into shared memory
__device__ void stage_span(Decoder& dec) {
    dec.n = min((uint32_t)STAGE_WORDS, dec.sp.row_words);
#pragma unroll 4
    for (uint32_t k = threadIdx.x; k < dec.n; k += blockDim.x) stage[k + (k >> 5)] = big_endian(__ldg(dec.sp.row + k));
}

// A subsequence's walk: entry e, exit x (the bit after its last code), codes n
struct Walk {
    uint32_t e, x;
    int n;
};

// The walk from e_new over [.., end): in lockstep with the old walk w until the two
// meet on a code boundary (from there the old walk stands), or to the end
__device__ void rewalk(const Decoder& dec, uint32_t e_new, uint32_t end, Walk& w) {
    Reader p, q;
    p.start(dec, e_new);
    q.start(dec, w.e);
    uint32_t s;
    int cn = 0, co = 0;
    while (p.r < end) {
        if (p.r == q.r) {
            w.e = e_new;
            w.n += cn - co;
            return;
        }
        if (q.r < p.r) {
            q.code(dec, s);
            ++co;
        } else {
            p.code(dec, s);
            cn += p.r != DEAD;
        }
    }
    w = {e_new, p.r, cn};
}

// Inside a CTA: entries from the exits before them, the first from `first`, until none changes
__device__ void repair_span(const Decoder& dec, uint32_t first, uint32_t end, bool real, Walk& w) {
    for (;;) {
        if (real) exits[threadIdx.x] = w.x;
        __syncthreads();
        const uint32_t e_new = threadIdx.x == 0 ? first : exits[threadIdx.x - 1];
        const bool changed = real && e_new != w.e;
        if (changed) rewalk(dec, e_new, end, w);
        if (!__syncthreads_or(changed)) break;
    }
}

// Per subsequence, in span bits: its entry and exit, its code count and output offset
struct Workspace {
    uint32_t* entry;
    uint32_t* exit;
    int32_t* count;
    int32_t* offset;
};

__global__ void __launch_bounds__(SPAN_SUBS)
huffman_decode_kernel_spec(const uint8_t* __restrict__ payload, const int32_t* __restrict__ pads,
                           const int32_t* __restrict__ byte_lens, const int32_t* __restrict__ tables, Workspace ws,
                           int capb, int spans) {
    const int b = blockIdx.x / spans, c = blockIdx.x % spans;
    long long nbits;
    Decoder dec = {span_of(payload, pads, byte_lens, b, capb, c, nbits), 0};
    if (dec.sp.first >= nbits) return;
    const uint32_t lattice = build_tables(tables, b, true);
    stage_span(dec);
    __syncthreads();

    const uint32_t lo = dec.sp.skew + threadIdx.x * SUB_BITS;  // the codes that start in [lo, end)
    const uint32_t end = min(lo + SUB_BITS, dec.sp.nbits);
    const bool real = lo < dec.sp.nbits;
    const uint32_t start = on_lattice(dec.sp, dec.sp.first + threadIdx.x * SUB_BITS, lattice);  // the speculation
    Walk w = {start, start, 0};
    uint32_t s;
    if (real) {
        Reader rd;
        rd.start(dec, start);
        while (rd.r < end) {
            rd.code(dec, s);
            w.n += rd.r != DEAD;
        }
        w.x = rd.r;
    }
    repair_span(dec, on_lattice(dec.sp, dec.sp.first, lattice), end, real, w);
    const size_t g = (size_t)blockIdx.x * SPAN_SUBS + threadIdx.x;
    ws.entry[g] = w.e;
    ws.exit[g] = w.x;
    ws.count[g] = real ? w.n : 0;
}

__global__ void __launch_bounds__(SPAN_SUBS)
huffman_decode_kernel_chain(const uint8_t* __restrict__ payload, const int32_t* __restrict__ pads,
                            const int32_t* __restrict__ byte_lens, const int32_t* __restrict__ tables, Workspace ws,
                            int32_t* __restrict__ counts, int32_t* __restrict__ ok, int capb, int spans) {
    __shared__ uint32_t warp_sums[SPAN_SUBS / 32];
    __shared__ uint32_t span_exit;
    const int b = blockIdx.x;
    long long nbits;
    Decoder dec = {span_of(payload, pads, byte_lens, b, capb, 0, nbits), 0};
    const long long used = (nbits + SPAN_BITS - 1) / SPAN_BITS;  // spans holding bits
    const uint32_t lattice = used > 1 ? build_tables(tables, b, true) : 0u;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t true_exit = dec.sp.skew;  // in the bits of span c - 1, then of span c
    uint32_t base = 0;
    for (int c = 0; c < used; ++c) {
        if (c > 0) {
            dec.sp = span_of(payload, pads, byte_lens, b, capb, c, nbits);
            true_exit = true_exit == DEAD ? DEAD : true_exit - SPAN_BITS;
        }
        const uint32_t lo = dec.sp.skew + threadIdx.x * SUB_BITS;
        const uint32_t end = min(lo + SUB_BITS, dec.sp.nbits);
        const bool real = lo < dec.sp.nbits;
        const size_t g = ((size_t)b * spans + c) * SPAN_SUBS + threadIdx.x;
        Walk w = {lo, lo, 0};
        if (real) w = {ws.entry[g], ws.exit[g], ws.count[g]};
        if (true_exit != on_lattice(dec.sp, dec.sp.first, lattice)) {  // pass 1 guessed wrong (every thread alike)
            if (true_exit == DEAD) {
                w = {DEAD, DEAD, 0};  // the walk ended in a code before this span
            } else {
                repair_span(dec, true_exit, end, real, w);
            }
            if (real) {
                ws.entry[g] = w.e;
                ws.count[g] = w.n;
            }
        }
        // the span's exclusive scan of the counts
        const uint32_t n = real ? (uint32_t)w.n : 0u;
        uint32_t incl = n;
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
            if (lane >= d) incl += up;
        }
        if (lane == 31) warp_sums[warp] = incl;
        const uint32_t last = min((uint32_t)SPAN_SUBS, (dec.sp.nbits - dec.sp.skew + SUB_BITS - 1) / SUB_BITS) - 1;
        if (threadIdx.x == last) span_exit = w.x;
        __syncthreads();
        uint32_t before = base, total = base;
        for (int k = 0; k < SPAN_SUBS / 32; ++k) {
            before += k < warp ? warp_sums[k] : 0u;
            total += warp_sums[k];
        }
        if (real) ws.offset[g] = (int32_t)(before + incl - n);
        base = total;
        true_exit = span_exit;
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        counts[b] = (int32_t)base;
        ok[b] = true_exit == dec.sp.nbits ? 1 : 0;
    }
}

__global__ void __launch_bounds__(SPAN_SUBS)
huffman_decode_kernel_write(const uint8_t* __restrict__ payload, const int32_t* __restrict__ pads,
                            const int32_t* __restrict__ byte_lens, const int32_t* __restrict__ tables, Workspace ws,
                            uint8_t* __restrict__ rows, int capb, int cap, int spans) {
    const int b = blockIdx.x / spans, c = blockIdx.x % spans;
    long long nbits;
    Decoder dec = {span_of(payload, pads, byte_lens, b, capb, c, nbits), 0};
    if (dec.sp.first >= nbits) return;
    build_tables(tables, b, false);
    stage_span(dec);
    __syncthreads();

    if (dec.sp.skew + threadIdx.x * SUB_BITS >= dec.sp.nbits) return;
    const size_t g = (size_t)blockIdx.x * SPAN_SUBS + threadIdx.x;
    const int off = ws.offset[g];
    const int stop = (int)min((long long)off + ws.count[g], (long long)cap);  // the row keeps what fits
    const size_t row = (size_t)b * cap;  // the row's first byte; the rows start 16-byte aligned and zeroed
    Reader rd;
    rd.start(dec, ws.entry[g]);
    unsigned long long lo = 0, hi = 0;  // the 16 bytes of the current chunk of the rows
    uint32_t s = 0;
    for (int i = off; i < stop; ++i) {
        rd.code(dec, s);
        const size_t at = row + i;
        const uint32_t k = at & 15;
        const unsigned long long v = (unsigned long long)s << (8 * (k & 7));
        lo |= k < 8 ? v : 0;
        hi |= k < 8 ? 0 : v;
        if (k == 15 || i + 1 == stop) {
            uint4* chunk = reinterpret_cast<uint4*>(rows + (at & ~(size_t)15));
            const uint4 bytes = make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
            if (k == 15 && i - 15 >= off) {
                *chunk = bytes;  // a chunk of this thread's alone
            } else {  // shared with a neighbour: this thread's bytes only
                uint32_t* w = reinterpret_cast<uint32_t*>(chunk);
                if (bytes.x) atomicOr(w, bytes.x);
                if (bytes.y) atomicOr(w + 1, bytes.y);
                if (bytes.z) atomicOr(w + 2, bytes.z);
                if (bytes.w) atomicOr(w + 3, bytes.w);
            }
            lo = hi = 0;
        }
    }
}

}  // namespace

// The workspace holds 16 bytes for each of B * spans * SPAN_SUBS subsequences, where
// spans = ceil(ceil(8 * capb / SUB_BITS) / SPAN_SUBS) (huffman_rows.workspace_bytes).
extern "C" int rsn_huffman_decode(const void* payload, const void* pads, const void* byte_lens,
                                  const void* tables, void* rows, void* counts, void* ok, void* workspace, int B,
                                  int capb, int cap, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const long long subs = (8LL * capb + SUB_BITS - 1) / SUB_BITS;
    const int spans = (int)max(1LL, (subs + SPAN_SUBS - 1) / SPAN_SUBS);
    const size_t n = (size_t)B * spans * SPAN_SUBS;
    uint32_t* w = (uint32_t*)workspace;
    const Workspace ws = {w, w + n, (int32_t*)(w + 2 * n), (int32_t*)(w + 3 * n)};
    const auto* pl = (const uint8_t*)payload;
    const auto *pd = (const int32_t*)pads, *bl = (const int32_t*)byte_lens, *tb = (const int32_t*)tables;
    huffman_decode_kernel_spec<<<B * spans, SPAN_SUBS, 0, st>>>(pl, pd, bl, tb, ws, capb, spans);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    huffman_decode_kernel_chain<<<B, SPAN_SUBS, 0, st>>>(pl, pd, bl, tb, ws, (int32_t*)counts, (int32_t*)ok, capb,
                                                         spans);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    huffman_decode_kernel_write<<<B * spans, SPAN_SUBS, 0, st>>>(pl, pd, bl, tb, ws, (uint8_t*)rows, capb, cap,
                                                                 spans);
    return (int)cudaGetLastError();
}
