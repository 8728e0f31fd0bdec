// Kernel F: LZSS token walk, a CTA a block: the tokens parsed by scans, the output staged in
// shared memory, and the copies resolved in rounds of ready tokens.
//
// Replaces raisin_tpu/ops/lzss_decode_pallas.py:_decode_kernel (:42, via lzss_decode_blocks).
// It follows the reference state machine (lzss.go:323): outside a token every byte but '<' is
// a literal; '<' opens a token whose bytes up to ',' are D and up to '>' are L (a number that
// is not all decimal digits counts as 0, values saturate at 2^30); the token copies
// out[len - D : len - D + L]. A stream that ends inside a token drops it. Faults: a reference
// with D > len or L > D (err 1), or output past cap (err 2); the first in stream order wins,
// and a faulty row is all zeros with out_len 0. The TPU kernel read a (toklen, L, D) side
// table that an XLA pass built beforehand and packed D and L in 13 bits; here the CTA parses
// the stream itself, so no side table and no 13-bit limit.
//
// The kernel before this one walked a block with one warp: a chain of dependent loads from
// device memory a token (~2,000 cycles). Here a CTA of THREADS threads takes a block, TILE
// token bytes at a time (each thread's CHUNK of the next tile loaded while this one is
// walked), in passes split by __syncthreads:
// A. each thread composes its chunk's map of the three states (0 outside a token, 1 in D,
//    2 in L) from its bytes in registers; an exclusive scan of the maps gives each chunk its
//    state on entry;
// B. each thread walks its chunk from that state, counting a byte a literal and L a token
//    that opens in it (its numbers read as the walk goes on past the chunk); a scan of the
//    counts gives each chunk's output offset and its first index in the tile's list of
//    copying tokens (L > 0);
// C. each thread walks its chunk again, places its literals, lists its tokens
//    (destination, source, L) and notes its first fault; a reduction finds the tile's
//    first fault, which ends the block before any copy;
// D. the copies, in rounds over the tile's tokens: a token whose source bytes are all
//    final (no pending token of the tile writes into them) copies; one whose source lies
//    wholly inside a single pending token's output takes that token's source instead
//    (which makes chains of tokens that copy the one before, as on zeros, ~log rounds
//    deep). Copies up to SHORT bytes are their thread's; longer ones are spread over the
//    CTA. When a round moves fewer than FEW tokens, or after MAX_ROUNDS rounds, one warp
//    walks the tile's pending tokens in order: lane 0 copies the short ones alone, the
//    lanes share a long one.
// The output lives in shared memory up to STAGE bytes (a block of 64 KiB escapes to at most
// ~66 KB on random bytes); bytes past it go straight to the row in device memory, which the
// same code reads back after __syncthreads. Readiness is tracked a token, not a byte, so it
// needs only the tile's token list whatever the output's size. At the end the CTA stores
// the row once, 16 bytes a store, with zeros from out_len up to cap (the wrapper's rows are
// not zeroed first).
//
// What bounds it: not bytes (a corpus block moves ~44 KB of tokens in and 128 KiB of row
// out) but instructions and barriers. Passes A-C walk every token byte three times, a
// branchy step each, with every scheduler of the SM busy; a corpus tile's copies take ~8
// rounds, in each of which only a fifth or so of the pending tokens turn ready, so each
// token is checked ~3 times; a chain of tokens that no move shortens is one thread's walk.
// STAGE and the token list fit two CTAs an SM. PERF.md gives the cycles of each phase
// (tests/cuda_host/phase_clock_lzss_decode.py).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int THREADS = 512;                                // a CTA, one block
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16;                                   // token bytes a thread parses, one 16-byte load
constexpr int TILE = THREADS * CHUNK;                       // token bytes parsed at once
constexpr int MIN_COPY = 5;                                 // the shortest token that copies: "<1,1>"
constexpr int MAX_TOKENS = TILE / MIN_COPY + 1;             // copying tokens that open in a tile
constexpr int PER_THREAD = (MAX_TOKENS + THREADS - 1) / THREADS;
constexpr int STAGE = 72 * 1024;                            // output bytes staged in shared memory
constexpr int SHORT = 32;                                   // a copy up to this long is one thread's
constexpr int WIDE = 64;                                    // a copy this long goes in 16-byte words if it can
constexpr int FEW = 8;                                      // a round that moves fewer tokens ends the CTA's rounds
constexpr int MAX_ROUNDS = 64;                              // as does this many rounds in a tile
constexpr int SMEM_BYTES = STAGE + 16 + TILE + MAX_TOKENS * (3 * 4 + 2 * 2 + 1);
constexpr unsigned SATURATE = 1u << 30;                     // numbers and output offsets saturate here
constexpr unsigned NO_FAULT = 0xFFFFFFFFu;
constexpr unsigned IDENTITY = 0u | 1u << 2 | 2u << 4;       // the state map s -> s, 2 bits a state
static_assert(PER_THREAD <= 32, "a thread's tokens fit a bit mask");
static_assert(MAX_TOKENS < 65536, "token indices fit 16 bits");
static_assert(CHUNK == 16, "a chunk is one 16-byte load");

__shared__ unsigned warp_a[WARPS], warp_b[WARPS];  // the scans' and the reduction's warp totals
__shared__ unsigned counters[4];                   // by round parity: tokens moved, long copies queued

// A tile's token list and the staged output, carved from dynamic shared memory
struct Shared {
    uint8_t* stage;    // output byte o < STAGE at stage[skew + o], lined up with the row's 16-byte words
    uint8_t* tile;     // the tile's token bytes
    int* dst;          // the tile's copying tokens in stream order: destination,
    int* src;          //   source (moved back through the tokens it lies in),
    int* len;          //   length
    uint16_t* dep;     // the first token whose output may overlap its source
    uint16_t* queue;   // a round's long copies
    uint8_t* done;
};

__device__ __forceinline__ Shared carve(uint8_t* smem) {
    Shared sh;
    sh.stage = smem;
    sh.tile = smem + STAGE + 16;
    sh.dst = (int*)(sh.tile + TILE);
    sh.src = sh.dst + MAX_TOKENS;
    sh.len = sh.src + MAX_TOKENS;
    sh.dep = (uint16_t*)(sh.len + MAX_TOKENS);
    sh.queue = sh.dep + MAX_TOKENS;
    sh.done = (uint8_t*)(sh.queue + MAX_TOKENS);
    return sh;
}

// The block's output: the stage below STAGE, the row in device memory from STAGE on
struct Out {
    uint8_t* stage;  // already offset by the skew
    uint8_t* row;
    __device__ __forceinline__ uint8_t get(int o) const { return o < STAGE ? stage[o] : row[o]; }
    __device__ __forceinline__ void put(int o, uint8_t c) const {
        if (o < STAGE) stage[o] = c;
        else row[o] = c;
    }
};

// The block's token bytes, a tile of them staged
struct Stream {
    const uint8_t* t;
    const uint8_t* tile;
    int n, p0;
    __device__ __forceinline__ int at(int q) const { return q - p0 < TILE ? tile[q - p0] : t[q]; }
};

__device__ __forceinline__ unsigned step(unsigned s, int c) {
    return s == 0 ? (c == '<' ? 1u : 0u) : s == 1 ? (c == ',' ? 2u : 1u) : (c == '>' ? 0u : 2u);
}

__device__ __forceinline__ unsigned apply(unsigned m, unsigned s) { return m >> 2 * s & 3; }

// The map a, then b
__device__ __forceinline__ unsigned compose(unsigned a, unsigned b) {
    return apply(b, a & 3) | apply(b, a >> 2 & 3) << 2 | apply(b, a >> 4 & 3) << 4;
}

__device__ __forceinline__ unsigned sat_add(unsigned a, unsigned b) { return min(a + b, SATURATE); }

// Exclusive scan of the threads' state maps in thread order; `total` the CTA's composition
__device__ __forceinline__ unsigned scan_maps(unsigned m, unsigned& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned x = m;
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(FULL_MASK, x, d);
        if (lane >= d) x = compose(y, x);
    }
    const unsigned prev = __shfl_up_sync(FULL_MASK, x, 1);
    if (lane == 31) warp_a[warp] = x;
    __syncthreads();
    unsigned before = IDENTITY;
    total = IDENTITY;
    for (int w = 0; w < WARPS; ++w) {
        if (w == warp) before = total;
        total = compose(total, warp_a[w]);
    }
    __syncthreads();
    return lane ? compose(before, prev) : before;
}

// Exclusive scan of (output bytes, saturating; tokens) in thread order, and their totals
__device__ __forceinline__ void scan_counts(unsigned& out, unsigned& toks, unsigned& out_total,
                                            unsigned& tok_total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned x = out, y = toks;
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned px = __shfl_up_sync(FULL_MASK, x, d), py = __shfl_up_sync(FULL_MASK, y, d);
        if (lane >= d) {
            x = sat_add(px, x);
            y += py;
        }
    }
    const unsigned prev_x = __shfl_up_sync(FULL_MASK, x, 1), prev_y = __shfl_up_sync(FULL_MASK, y, 1);
    if (lane == 31) {
        warp_a[warp] = x;
        warp_b[warp] = y;
    }
    __syncthreads();
    unsigned bx = 0, by = 0;
    out_total = tok_total = 0;
    for (int w = 0; w < WARPS; ++w) {
        if (w == warp) {
            bx = out_total;
            by = tok_total;
        }
        out_total = sat_add(out_total, warp_a[w]);
        tok_total += warp_b[w];
    }
    __syncthreads();
    out = lane ? sat_add(bx, prev_x) : bx;
    toks = lane ? by + prev_y : by;
}

__device__ __forceinline__ unsigned block_min(unsigned v) {
    v = __reduce_min_sync(FULL_MASK, v);
    if ((threadIdx.x & 31) == 0) warp_a[threadIdx.x >> 5] = v;
    __syncthreads();
    unsigned m = NO_FAULT;
    for (int w = 0; w < WARPS; ++w) m = min(m, warp_a[w]);
    __syncthreads();
    return m;
}

// Passes B and C over the chunk [lo, hi) from state s, a byte a step, and on past hi to the
// end of a token that opens in it (its numbers read as the walk goes): B (PLACE false) counts
// in o the output bytes (saturated) and in k the copying tokens; C places the literals from
// output offset o, lists the copying tokens from index k and returns the first fault as
// 2 * position + code - 1 (NO_FAULT if none). The chunk's own bytes come from registers w;
// only the overhang past hi reads the tile (or device memory).
template <bool PLACE>
__device__ __forceinline__ unsigned walk_chunk(const Stream& st, const Shared& sh, const Out& out,
                                               const unsigned (&w)[4], int lo, int hi, unsigned s, unsigned& o,
                                               unsigned& k, unsigned cap) {
    unsigned v = 0, D = 0, fault = NO_FAULT;
    bool digits = true, mine = false;  // the numbers so far are all digits; the token opened here
    // one byte; false where it faults
    auto step_byte = [&](int p, int c) -> bool {
        const unsigned digit = (unsigned)(c - '0');
        if (s == 0) {
            if (c == '<') {
                s = 1;
                v = 0;
                digits = mine = true;
            } else if (!PLACE) {
                o = sat_add(o, 1);
            } else if (o >= cap) {
                fault = 2u * p + 1;  // capacity
                return false;
            } else {
                out.put((int)o++, (uint8_t)c);
            }
        } else if (c == (s == 1 ? ',' : '>')) {
            const unsigned value = digits ? v : 0u;
            v = 0;
            digits = true;
            if (s == 1) {
                D = value;
                s = 2;
                return true;
            }
            s = 0;
            if (!mine) return true;
            mine = false;
            const unsigned L = value;
            if (!PLACE) {
                o = sat_add(o, L);
                k += L > 0;
                return true;
            }
            if (D > o || L > D) {
                fault = 2u * p;  // a reference outside the output
                return false;
            }
            if (o + L > cap) {
                fault = 2u * p + 1;  // capacity
                return false;
            }
            if (L > 0) {
                if (k < (unsigned)MAX_TOKENS) {  // past it only in a tile that faults
                    sh.dst[k] = (int)o;
                    sh.src[k] = (int)(o - D);
                    sh.len[k] = (int)L;
                }
                ++k;
            }
            o += L;
        } else if (digit < 10) {
            v = v < SATURATE / 10 + 1 ? min(v * 10 + digit, SATURATE) : SATURATE;  // no 32-bit overflow
        } else {
            digits = false;
        }
        return true;
    };
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
        if (lo + i < hi && !step_byte(lo + i, (int)(w[i / 4] >> 8 * (i % 4) & 0xFF))) return fault;
    for (int p = hi; mine && p < st.n; ++p)
        if (!step_byte(p, st.at(p))) return fault;
    return NO_FAULT;
}

// Copies a token's L bytes, the part of one of `stride` threads, the `start`-th: in 16-byte
// words inside the stage when D is a multiple of 16 (zeros' tokens), else bytes eight at a time
__device__ __forceinline__ void copy_token(const Out& out, int d, int s, int L, int start, int stride) {
    if (d + L > STAGE) {
        for (int k = start; k < L; k += stride) out.put(d + k, out.get(s + k));
        return;
    }
    int k0 = 0;
    if (L >= WIDE && ((d - s) & 15) == 0) {
        k0 = (int)(-(uintptr_t)(out.stage + d) & 15);
        const int words = (L - k0) >> 4;
        uint4* const to = (uint4*)(out.stage + d + k0);
        const uint4* const from = (const uint4*)(out.stage + s + k0);
        for (int k = start; k < words; k += stride) to[k] = from[k];
        for (int k = start; k < k0; k += stride) out.stage[d + k] = out.stage[s + k];
        k0 += words << 4;
    }
    // eight loads before their stores, which a copy never overlaps (L <= D); the tail as one
    // such batch
    for (int k = k0 + start; k < L; k += 8 * stride) {
        uint8_t b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
            if (k + i * stride < L) b[i] = out.stage[s + k + i * stride];
#pragma unroll
        for (int i = 0; i < 8; ++i)
            if (k + i * stride < L) out.stage[d + k + i * stride] = b[i];
    }
}

// The first token in [0, hi) whose output ends past s (hi if none)
__device__ __forceinline__ int first_end_after(const Shared& sh, int hi, int s) {
    int lo = 0;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sh.dst[mid] + sh.len[mid] > s) hi = mid;
        else lo = mid + 1;
    }
    return lo;
}

// The first pending token of the tile whose output overlaps token j's source, or -1 (ready);
// passes on j's mark over the tokens that are done or end before the source
__device__ __forceinline__ int first_pending(const Shared& sh, int j) {
    const int s = sh.src[j], e = s + sh.len[j];
    int i = sh.dep[j];
    while (i < j && sh.dst[i] < e && (sh.done[i] || sh.dst[i] + sh.len[i] <= s)) ++i;
    sh.dep[j] = (uint16_t)i;
    return i < j && sh.dst[i] < e ? i : -1;
}

// One thread copies the short tokens [lo, hi) that are pending: all of them when `todo` is all
// ones, else those whose bit (from lo) is set; each token's fields are loaded before the copy
// ahead of it
__device__ __forceinline__ void short_walk(const Shared& sh, const Out& out, int lo, int hi, unsigned todo,
                                           int& steps) {
    const bool all = todo == ~0u;
    int d = sh.dst[lo], s = sh.src[lo], L = sh.len[lo];
    bool p = all ? !sh.done[lo] : todo & 1;
    for (int i = lo; i < hi; ++i) {
        const int n = min(i + 1, hi - 1);
        const int dn = sh.dst[n], sn = sh.src[n], Ln = sh.len[n];
        const bool pn = all ? !sh.done[n] : todo >> (n - lo) & 1;
        if (p) {
            copy_token(out, d, s, L, 0, 1);
            ++steps;
        }
        d = dn, s = sn, L = Ln, p = pn;
    }
}

// Pass D: the tile's `count` copies
__device__ __forceinline__ void resolve(const Shared& sh, const Out& out, int count, int& rounds, int& steps) {
    const int tid = threadIdx.x, lane = tid & 31;
    for (int j = tid; j < count; j += THREADS) {
        sh.done[j] = 0;
        sh.dep[j] = (uint16_t)first_end_after(sh, j, sh.src[j]);
    }
    if (tid == 0) counters[0] = counters[1] = counters[2] = counters[3] = 0;
    unsigned pending = 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k)
        if (tid + k * THREADS < count) pending |= 1u << k;
    __syncthreads();
    for (int round = 0;; ++round) {
        unsigned ready = 0, moved = 0, progress = 0;
        unsigned* const queued = counters + 2 + (round & 1);
        int to[PER_THREAD], to_dep[PER_THREAD];
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
            to[k] = to_dep[k] = 0;
            if (!(pending >> k & 1)) continue;
            const int j = tid + k * THREADS;
            const int i = first_pending(sh, j);
            const int s = sh.src[j], L = sh.len[j];
            if (i < 0) {
                ready |= 1u << k;
                ++progress;
                if (L <= SHORT) copy_token(out, sh.dst[j], s, L, 0, 1);
                else sh.queue[atomicAdd(queued, 1u)] = (uint16_t)j;
            } else if (sh.dst[i] <= s && s + L <= sh.dst[i] + sh.len[i]) {
                // inside token i's output: take its source. Every token before i's dependence
                // mark that overlaps i's source is done, so the mark serves j's new source too
                to[k] = sh.src[i] + (s - sh.dst[i]);
                to_dep[k] = sh.dep[i];
                moved |= 1u << k;
                ++progress;
            }
        }
        progress = __reduce_add_sync(FULL_MASK, progress);
        if (lane == 0 && progress) atomicAdd(counters + (round & 1), progress);
        __syncthreads();
        const unsigned nq = *queued;
        if (tid == 0) counters[(round + 1) & 1] = counters[2 + ((round + 1) & 1)] = 0;
        for (unsigned q = 0; q < nq; ++q) {
            const int j = sh.queue[q];
            copy_token(out, sh.dst[j], sh.src[j], sh.len[j], tid, THREADS);
        }
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
            const int j = tid + k * THREADS;
            if (ready >> k & 1) sh.done[j] = 1;
            if (moved >> k & 1) {
                sh.src[j] = to[k];
                sh.dep[j] = (uint16_t)to_dep[k];
            }
        }
        pending &= ~ready;
        const int left = __syncthreads_or(pending != 0);
        ++rounds;
        if (!left) return;
        if (counters[round & 1] < (unsigned)FEW || round + 1 >= MAX_ROUNDS) break;
    }
    // the rest of the tile: one warp walks the pending tokens in order. Lane 0 copies a short
    // one alone, so that a chain of them waits on no barrier, with the next one's fields
    // loaded before the copy's stores (which they would otherwise wait behind); the lanes
    // share a long one. Where most of the tile is pending and none is long (a chain), lane 0
    // walks the whole tile alone; else the warp takes it 32 tokens at a time, skipping those
    // that are done, and hands lane 0 the groups that hold no long token.
    if (tid < 32) {
        unsigned waiting = 0;
        bool any_long = false;
        for (int w = 0; w < count; w += 32) {
            const int j = w + lane;
            const bool pend = j < count && !sh.done[j];
            waiting += __popc(__ballot_sync(FULL_MASK, pend));
            any_long |= __any_sync(FULL_MASK, pend && sh.len[j] > SHORT);
        }
        if (!any_long && 2 * waiting >= (unsigned)count) {
            if (lane == 0) short_walk(sh, out, 0, count, ~0u, steps);
        } else {
            for (int w = 0; w < count; w += 32) {
                const int j = w + lane;
                const bool pend = j < count && !sh.done[j];
                unsigned todo = __ballot_sync(FULL_MASK, pend);
                if (!__any_sync(FULL_MASK, pend && sh.len[j] > SHORT)) {
                    if (lane == 0 && todo) short_walk(sh, out, w, min(w + 32, count), todo, steps);
                } else {
                    for (; todo; todo &= todo - 1) {
                        const int i = w + __ffs((int)todo) - 1;
                        copy_token(out, sh.dst[i], sh.src[i], sh.len[i], lane, 32);
                        __syncwarp();
                        ++steps;
                    }
                }
                __syncwarp();
            }
        }
    }
    __syncthreads();
}

// Stores the row [0, cap): the output below min(total, STAGE) from the stage, zeros from total
// on; [STAGE, total) is already in the row
__device__ __forceinline__ void write_row(const Out& out, int skew, int total, int cap) {
    const int tid = threadIdx.x;
    const int staged = min(total, STAGE);
    const int head = min((16 - skew) & 15, cap);
    const int words = (cap - head) / 16;
    uint8_t* const row = out.row;
    auto put = [&](int o) {
        if (o < STAGE || o >= total) row[o] = o < staged ? out.stage[o] : 0;
    };
    for (int o = tid; o < head; o += THREADS) put(o);
    for (int w = tid; w < words; w += THREADS) {
        const int lo = head + 16 * w;
        if (lo + 16 <= staged) {
            *(uint4*)(row + lo) = *(const uint4*)(out.stage + lo);
        } else if (lo >= total) {
            *(uint4*)(row + lo) = make_uint4(0, 0, 0, 0);
        } else if (lo < STAGE || lo + 16 > total) {
            for (int o = lo; o < lo + 16; ++o) put(o);
        }
    }
    for (int o = head + 16 * words + tid; o < cap; o += THREADS) put(o);
}

// Token bytes [lo, lo + 16) of a row, as they lie in memory (what lies past n is not looked
// at): from the two aligned 16-byte words around them when both lie inside the tensor,
// else a byte at a time
__device__ __forceinline__ uint4 load_chunk(const uint8_t* base, const uint8_t* t, int lo, int n, int S) {
    if (lo >= n) return make_uint4(0, 0, 0, 0);
    const int m = (int)((uintptr_t)(t + lo) & 15);
    if (lo + 32 <= S && t + lo - m >= base) {
        const uint4 w0 = *(const uint4*)(t + lo - m), w1 = *(const uint4*)(t + lo - m + 16);
        const unsigned a[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const unsigned sel = 0x3210u + 0x1111u * (unsigned)(m & 3);
        unsigned x[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) {  // the words from m >> 2 on, without indexing by a variable
            const int q = m >> 2;
            x[i] = q == 0 ? a[i] : q == 1 ? a[i + 1] : q == 2 ? a[i + 2] : a[i + 3];
        }
        return make_uint4(__byte_perm(x[0], x[1], sel), __byte_perm(x[1], x[2], sel), __byte_perm(x[2], x[3], sel),
                          __byte_perm(x[3], x[4], sel));
    }
    unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 16; ++k)
        if (lo + k < n) w[k >> 2] |= (unsigned)t[lo + k] << 8 * (k & 3);
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(THREADS, 2)
lzss_decode_kernel(const uint8_t* __restrict__ tok, const int32_t* __restrict__ tok_len, uint8_t* rows,
                   int32_t* __restrict__ out_len, int32_t* __restrict__ err, int32_t* __restrict__ stats, int S,
                   int cap) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int b = blockIdx.x, tid = threadIdx.x;
    const Shared sh = carve(smem);
    uint8_t* const row = rows + (size_t)b * cap;
    const int skew = (int)((uintptr_t)row & 15);
    const Out out{sh.stage + skew, row};
    Stream st{tok + (size_t)b * S, sh.tile, min(max(tok_len[b], 0), S), 0};
    unsigned state = 0, base = 0, fault = NO_FAULT;  // carried from tile to tile
    int rounds = 0, steps = 0;
    uint4 next = load_chunk(tok, st.t, tid * CHUNK, st.n, S);
    for (int p0 = 0; p0 < st.n; p0 += TILE) {
        st.p0 = p0;
        const int lo = p0 + tid * CHUNK, hi = min(lo + CHUNK, st.n);
        const unsigned w[4] = {next.x, next.y, next.z, next.w};
        *(uint4*)(sh.tile + tid * CHUNK) = next;                // for B and C
        next = load_chunk(tok, st.t, lo + TILE, st.n, S);  // in flight while this tile is walked
        // A: the chunk's state map, from its bytes in registers
        unsigned s0 = 0, s1 = 1, s2 = 2;
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {
            const int c = w[i / 4] >> 8 * (i % 4) & 0xFF;
            if (lo + i < hi) {
                s0 = step(s0, c);
                s1 = step(s1, c);
                s2 = step(s2, c);
            }
        }
        unsigned all;
        const unsigned entry = apply(scan_maps(s0 | s1 << 2 | s2 << 4, all), state);
        state = apply(all, state);
        // B: output offsets and token indices
        unsigned o = 0, k = 0, tile_out, tile_toks;
        walk_chunk<false>(st, sh, out, w, lo, hi, entry, o, k, (unsigned)cap);
        scan_counts(o, k, tile_out, tile_toks);
        // C: literals, the token list, the first fault
        o = sat_add(base, o);
        fault = block_min(walk_chunk<true>(st, sh, out, w, lo, hi, entry, o, k, (unsigned)cap));
        if (fault != NO_FAULT) break;
        base = sat_add(base, tile_out);
        // D: the copies
        if (tile_toks) resolve(sh, out, min((int)tile_toks, MAX_TOKENS), rounds, steps);
    }
    const int total = fault == NO_FAULT ? (int)base : 0;
    write_row(out, skew, total, cap);
    if (tid == 0) {
        out_len[b] = total;
        err[b] = fault == NO_FAULT ? 0 : (int)(fault & 1) + 1;
        if (stats) {
            stats[2 * b] = rounds;
            stats[2 * b + 1] = steps;
        }
    }
}

}  // namespace

extern "C" int rsn_lzss_decode(const void* tok, const void* tok_len, void* rows, void* out_len, void* err,
                               void* stats, int B, int S, int cap, void* stream) {
    const cudaError_t e =
        cudaFuncSetAttribute(lzss_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    lzss_decode_kernel<<<B, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint8_t*)tok, (const int32_t*)tok_len, (uint8_t*)rows, (int32_t*)out_len, (int32_t*)err,
        (int32_t*)stats, S, cap);
    return (int)cudaGetLastError();
}
