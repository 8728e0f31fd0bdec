// Kernel E: greedy LZSS commit and ASCII token emission, each block's positions walked in
// parallel segments.
//
// Replaces raisin_tpu/ops/lzss_commit_pallas.py:_commit_kernel (:41, via
// commit_emit_words). The walk is the reference's (lzss.go:134-151): at position i of a
// block of n positions, with match (L, D) and Lq = min(L, n - i), Lq <= 1 is one literal;
// otherwise the token "<D,Lq>" is written when strictly shorter than Lq, else the Lq
// matched bytes are copied, and Lq positions are consumed either way. The committed
// positions are the orbit of 0 under f(i) = i + max(Lq, 1). D and L take up to 5 digits
// (windows above 9999), so a commit writes at most 13 bytes; the TPU kernel packed 4.
//
// The parent kernel walked a whole block with one warp: a chain of two dependent loads
// from device memory a commit (~1,500 cycles), one SM for a single stream. Here a block's
// positions are split into segments of SEG positions, one thread each, SPAN_SEGS segments
// a CTA (a span), so a block runs on many threads and a single stream on many SMs. Greedy
// walks from different positions soon land on a common position, after which they are
// the same walk (on the corpus within 1-10 commits). So a call launches three kernels
// over a workspace of four words a segment:
// 1. lzss_commit_kernel_spec, a CTA a span: each thread walks from its segment's first
//    position, whether the true parse commits there or not (the speculation), to the
//    first position at or past the segment's end (its exit), adding up the bytes its
//    commits write. A segment that the first commit of its warp's first segment jumps
//    over takes that commit's exit instead (zeros: a load a warp, not one a segment).
//    Then the span repairs: a segment's entry must be the exit of the segment before it;
//    one whose entry changes walks again from it, in lockstep with its old walk, until
//    the two land on one position (the exit stands, the count is corrected by the two
//    prefixes) or the new walk leaves the segment. Rounds run inside each warp (a vote
//    and a shuffle a round: a segment takes the exit of the nearest one before it that
//    holds commits, so the segments that a long match jumps over take its exit in one
//    round), then across the span's warps (a warp takes the exit of the warps before it
//    in order, passing over those that a value jumps), until no entry changes. The
//    span's first entry is itself a speculation for every span but a block's first.
// 2. lzss_commit_kernel_chain, a CTA a block: over the block's spans in order (each
//    span's state loaded a span ahead), a span whose first entry differs from the
//    previous span's true exit repeats that repair from the true exit; an exclusive scan
//    of the true byte counts gives each segment's output offset, their total tok_len.
// 3. lzss_commit_kernel_write, a CTA a span: each thread walks its true commits again and
//    writes their bytes (literals and copies from x, tokens' digits by constant division)
//    into the span's output staged in shared memory, which the CTA stores sixteen bytes a
//    store (atomicOr on the two chunks it may share with a neighbour; tok starts zeroed).
// A walk reads L and D only at the positions it commits, both at once so that a step waits
// on one load, straight from device memory: a block whose matches are long costs a load a
// warp, not a pass over every position.
//
// What bounds it: passes 1 and 3 read L and D a 32-byte sector at a time, 32 lanes on 32
// lines, ~5 commits a segment on the corpus: at the container's shape each pass moves the
// ~400 MB of sectors that its walks touch at ~1 TB/s, a third of the card's rate for
// whole lines. Staging each span's matches in shared memory, loaded whole, was measured
// slower (64 KB a CTA cuts the CTAs an SM holds), as were 128-position segments and a
// 256-byte L2 prefetch hint. A single stream's pass 2 walks its 64 spans one after
// another in one CTA, ~1.7 us a span. Walks that never meet (L = 2 everywhere after an
// odd start) cost a round a segment, each a walk of SEG positions: the block is then
// walked in order once more, in pass 2 at an L1 hit a commit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int SEG = 64;                      // positions a segment, one thread's
constexpr int SPAN_SEGS = 256;               // segments a span, one CTA's threads
constexpr int SPAN = SEG * SPAN_SEGS;        // positions a span
constexpr int WARPS = SPAN_SEGS / 32;
constexpr int MAX_OUT = 13;                  // the longest commit: "<99999,99999>"
constexpr int STAGE_BYTES = SPAN + 2 * 16;   // a span's output (< SPAN + MAX_OUT) and its skew to 16 bytes
constexpr int MIN_TOKEN_L = 6;               // a token has at least 5 bytes: shorter matches are copied
static_assert(STAGE_BYTES >= SPAN + MAX_OUT - 1 + 15, "a span's output and its skew fit the stage");

__shared__ __align__(16) uint8_t stage[STAGE_BYTES];  // pass 3: the span's output from a 16-byte boundary

// One block's matches and bytes
struct Block {
    const uint8_t* x;
    const int32_t* L;
    const int32_t* D;
    int n;  // its length, in 0..S
};

__device__ __forceinline__ Block block_of(const uint8_t* x, const int32_t* L, const int32_t* D,
                                          const int32_t* lengths, int b, int S) {
    const size_t row = (size_t)b * S;
    return {x ? x + row : nullptr, L + row, D + row, min(max(lengths[b], 0), S)};
}

__device__ __forceinline__ int ndigits(int v) {
    return 1 + (v >= 10) + (v >= 100) + (v >= 1000) + (v >= 10000);
}

// A commit with match (l, d) and `room` positions left in the block: the positions it
// consumes; `out` the bytes it writes
__device__ __forceinline__ int commit_of(int l, int d, int room, int& out) {
    const int lq = min(l, room);
    if (lq < MIN_TOKEN_L) {  // a literal, or a copy: no token is shorter
        out = max(lq, 1);
        return out;
    }
    const int tl = 3 + ndigits(d) + ndigits(lq);
    out = tl < lq ? tl : lq;
    return lq;
}

// The commit at position i < n. D is loaded beside L, whether a token needs it or not, so
// that a step waits on one load.
__device__ __forceinline__ int commit_at(const Block& bk, int i, int& out) {
    return commit_of(__ldg(bk.L + i), __ldg(bk.D + i), bk.n - i, out);
}

// A segment's walk: entry e, exit x (the first position at or past its end), bytes c
struct Walk {
    int e, x, c;
};

__device__ __forceinline__ void walk(const Block& bk, int p, int end, Walk& w) {
    int c = 0, out;
    w.e = p;
    while (p < end) {
        p += commit_at(bk, p, out);
        c += out;
    }
    w.x = p;
    w.c = c;
}

// The walk from e_new over [.., end): in lockstep with the old walk w until the two land
// on one position (from there the old walk stands), or to the end
__device__ void rewalk(const Block& bk, int e_new, int end, Walk& w) {
    int p = e_new, q = w.e, cn = 0, co = 0, out;
    while (p < end) {
        if (p == q) {
            w.e = e_new;
            w.c += cn - co;
            return;
        }
        if (q < p) {
            q += commit_at(bk, q, out);
            co += out;
        } else {
            p += commit_at(bk, p, out);
            cn += out;
        }
    }
    w = {e_new, p, cn};
}

// Inside a warp, in rounds until no entry changes: each entry is the exit of the nearest lane
// before it that holds commits (its entry inside its segment), lane 0's and that of a lane
// with none before it `first`, once `first` has reached the lane's segment (lo, its first
// position). The lanes between are passed over (entry at or past their end, exit = entry),
// so a match that jumps over many segments costs a round, not one each.
__device__ void repair_warp(const Block& bk, int first, int lo, int end, Walk& w) {
    const int lane = threadIdx.x & 31;
    for (;;) {
        const unsigned before = __ballot_sync(FULL_MASK, w.e < end) & ((1u << lane) - 1u);
        const int up = (int)__shfl_sync(FULL_MASK, (unsigned)w.x, before ? 31 - __clz(before) : 0);
        const int e_new = before ? up : first >= lo ? first : w.e;
        const bool changed = e_new != w.e;
        if (changed) rewalk(bk, e_new, end, w);
        if (!__any_sync(FULL_MASK, changed)) return;
    }
}

// Inside a CTA, in rounds until no warp's first entry changes: the warps' repairs, then each
// warp's first entry from the warps before it in order, starting from `first`: a value at or
// past a warp's end passes over it, any other takes the warp's exit (the exit stands if the
// warp's repair from that value meets its walks, as it mostly does; the next round checks).
// So a match that jumps over several warps costs a round, not one each.
__device__ void repair_span(const Block& bk, int first, int lo, int end, Walk& w) {
    __shared__ int warp_exit[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int span_lo = lo - (int)threadIdx.x * SEG;
    int e0 = warp == 0 ? first : (int)__shfl_sync(FULL_MASK, (unsigned)w.e, 0);
    for (;;) {
        repair_warp(bk, e0, lo, end, w);
        if (lane == 31) warp_exit[warp] = w.x;
        __syncthreads();
        int e0_new = first;
        for (int k = 0; k < warp; ++k) {
            const int k_end = min(span_lo + (k + 1) * 32 * SEG, bk.n);
            e0_new = e0_new >= k_end ? e0_new : warp_exit[k];
        }
        const bool changed = e0_new != e0;
        e0 = e0_new;
        if (!__syncthreads_or(changed)) return;
    }
}

// Per segment: its entry, exit, byte count and output offset in the row
struct Workspace {
    int32_t* entry;
    int32_t* exit;
    int32_t* count;
    int32_t* offset;
};

// The end of segment t of span c; a segment past n (end n, entry and exit n) is passed through
__device__ __forceinline__ int segment_end(const Block& bk, int c, int& lo) {
    lo = c * SPAN + (int)threadIdx.x * SEG;
    return min(lo + SEG, bk.n);
}

__global__ void __launch_bounds__(SPAN_SEGS)
lzss_commit_kernel_spec(const int32_t* __restrict__ L, const int32_t* __restrict__ D,
                        const int32_t* __restrict__ lengths, Workspace ws, int S, int spans) {
    const int b = blockIdx.x / spans, c = blockIdx.x % spans;
    const int lane = threadIdx.x & 31;
    int lo;
    // the speculation. Lane 0 commits first: a segment that this commit jumps over takes its
    // exit (passed over, no walk of its own), so that long matches cost a load a warp. Its
    // match is loaded beside the block's length.
    int l0 = 0, d0 = 0;
    const size_t row = (size_t)b * S;
    if (lane == 0 && c * SPAN + (int)threadIdx.x * SEG < S) {
        l0 = __ldg(L + row + c * SPAN + threadIdx.x * SEG);
        d0 = __ldg(D + row + c * SPAN + threadIdx.x * SEG);
    }
    const Block bk = block_of(nullptr, L, D, lengths, b, S);
    if (c * SPAN >= bk.n) return;
    const int end = segment_end(bk, c, lo);
    int out = 0, p = lo;
    if (lane == 0 && lo < bk.n) p += commit_of(l0, d0, bk.n - lo, out);
    const int jump = (int)__shfl_sync(FULL_MASK, (unsigned)p, 0);
    Walk w = {bk.n, bk.n, 0};  // a segment past n
    if (lo >= bk.n) {
    } else if (lane == 0) {
        walk(bk, p, end, w);
        w.e = lo;
        w.c += out;
    } else if (jump >= end) {
        w = {jump, jump, 0};
    } else {
        walk(bk, lo, end, w);
    }
    repair_span(bk, c * SPAN, lo, end, w);
    const size_t g = (size_t)blockIdx.x * SPAN_SEGS + threadIdx.x;
    ws.entry[g] = w.e;
    ws.exit[g] = w.x;
    ws.count[g] = w.c;
}

__global__ void __launch_bounds__(SPAN_SEGS)
lzss_commit_kernel_chain(const int32_t* __restrict__ L, const int32_t* __restrict__ D,
                         const int32_t* __restrict__ lengths, Workspace ws, int32_t* __restrict__ tok_len, int S,
                         int spans) {
    __shared__ int warp_sums[WARPS];
    __shared__ int span_exit;
    const int b = blockIdx.x;
    const Block bk = block_of(nullptr, L, D, lengths, b, S);
    const int used = (int)(((long long)bk.n + SPAN - 1) / SPAN);  // spans holding positions
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int true_exit = 0, base = 0;
    const size_t g0 = (size_t)b * spans * SPAN_SEGS + threadIdx.x;
    Walk next = {0, 0, 0};  // the next span's state, loaded a span ahead
    if (used > 0) next = {ws.entry[g0], ws.exit[g0], ws.count[g0]};
    for (int c = 0; c < used; ++c) {
        int lo;
        const int end = segment_end(bk, c, lo);
        const size_t g = g0 + (size_t)c * SPAN_SEGS;
        Walk w = next;
        if (c + 1 < used) next = {ws.entry[g + SPAN_SEGS], ws.exit[g + SPAN_SEGS], ws.count[g + SPAN_SEGS]};
        if (true_exit != c * SPAN) {  // pass 1 guessed wrong (every thread alike)
            repair_span(bk, true_exit, lo, end, w);
            ws.entry[g] = w.e;
            ws.count[g] = w.c;
        }
        // the span's exclusive scan of the counts
        int incl = w.c;
        for (int d = 1; d < 32; d <<= 1) {
            const int up = (int)__shfl_up_sync(FULL_MASK, (unsigned)incl, d);
            if (lane >= d) incl += up;
        }
        if (lane == 31) warp_sums[warp] = incl;
        if (threadIdx.x == SPAN_SEGS - 1) span_exit = w.x;
        __syncthreads();
        int before = base, total = base;
        for (int k = 0; k < WARPS; ++k) {
            before += k < warp ? warp_sums[k] : 0;
            total += warp_sums[k];
        }
        ws.offset[g] = before + incl - w.c;
        base = total;
        true_exit = span_exit;
        __syncthreads();
    }
    if (threadIdx.x == 0) tok_len[b] = base;
}

// The decimal digits of v, nd of them (v >= 0: its last nd digits; v < 0: nd is 1 and the
// digit is v's floor modulo 10, as in the plain version)
__device__ __forceinline__ void put_digits(uint8_t* dst, int v, int nd) {
    if (v < 0) {
        dst[0] = (uint8_t)('0' + (v % 10 + 10) % 10);
        return;
    }
    uint32_t u = (uint32_t)v;
    for (int k = nd - 1; k >= 0; --k) {
        const uint32_t q = u / 10u;
        dst[k] = (uint8_t)('0' + (u - 10u * q));
        u = q;
    }
}

__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src, int k) {
    for (int j = 0; j < k; ++j) dst[j] = __ldg(src + j);
}

// The commit at position i < n into out: the positions it consumes; o moves past its bytes
__device__ __forceinline__ int emit_at(const Block& bk, int i, uint8_t* out, int& o) {
    const int d = __ldg(bk.D + i);
    const int lq = min(__ldg(bk.L + i), bk.n - i);
    if (lq < MIN_TOKEN_L) {
        const int k = max(lq, 1);
        copy_bytes(out + o, bk.x + i, k);
        o += k;
        return k;
    }
    const int nd_d = ndigits(d), nd_l = ndigits(lq), tl = 3 + nd_d + nd_l;
    if (tl >= lq) {
        copy_bytes(out + o, bk.x + i, lq);
        o += lq;
        return lq;
    }
    uint8_t* t = out + o;
    t[0] = '<';
    put_digits(t + 1, d, nd_d);
    t[1 + nd_d] = ',';
    put_digits(t + 2 + nd_d, lq, nd_l);
    t[tl - 1] = '>';
    o += tl;
    return lq;
}

__global__ void __launch_bounds__(SPAN_SEGS)
lzss_commit_kernel_write(const uint8_t* __restrict__ x, const int32_t* __restrict__ L,
                         const int32_t* __restrict__ D, const int32_t* __restrict__ lengths, Workspace ws,
                         uint8_t* __restrict__ tok, int S, int spans) {
    __shared__ int span_first, span_end;
    const int b = blockIdx.x / spans, c = blockIdx.x % spans;
    // the segment's state, loaded beside the block's length (a span past it never reads them)
    const size_t g = (size_t)blockIdx.x * SPAN_SEGS + threadIdx.x;
    const int off = ws.offset[g], entry = ws.entry[g];
    const int count = threadIdx.x == SPAN_SEGS - 1 ? ws.count[g] : 0;
    const Block bk = block_of(x, L, D, lengths, b, S);
    if (c * SPAN >= bk.n) return;
    if (threadIdx.x == 0) span_first = off;
    if (threadIdx.x == SPAN_SEGS - 1) span_end = off + count;
    __syncthreads();

    uint8_t* const row = tok + (size_t)b * S;
    const int skew = (int)(reinterpret_cast<uintptr_t>(row + span_first) & 15);  // the stage starts 16-byte aligned
    const int len = span_end - span_first;
    const int chunks = (skew + len + 15) / 16;
    // the threads write the stage's bytes [skew, skew + len); the rest of its first and last chunks is zero
    if (threadIdx.x < skew) stage[threadIdx.x] = 0;
    if (threadIdx.x < 16 * chunks - skew - len) stage[skew + len + threadIdx.x] = 0;
    int lo;
    const int end = segment_end(bk, c, lo);
    int o = skew + off - span_first;
    for (int p = entry; p < end;) p += emit_at(bk, p, stage, o);
    __syncthreads();

    uint4* dst = reinterpret_cast<uint4*>(row + span_first - skew);
    for (int k = threadIdx.x; k < chunks; k += SPAN_SEGS) {
        const uint4 v = reinterpret_cast<const uint4*>(stage)[k];
        if (16 * k >= skew && 16 * k + 16 <= skew + len) {
            dst[k] = v;  // a chunk of this span's alone
        } else {  // shared with a neighbour: this span's bytes only
            unsigned* w = reinterpret_cast<unsigned*>(dst + k);
            if (v.x) atomicOr(w, v.x);
            if (v.y) atomicOr(w + 1, v.y);
            if (v.z) atomicOr(w + 2, v.z);
            if (v.w) atomicOr(w + 3, v.w);
        }
    }
}

}  // namespace

// The workspace holds 16 bytes for each of B * spans * SPAN_SEGS segments, where
// spans = max(1, ceil(S / SPAN)) (lzss_commit.workspace_bytes); tok starts zeroed.
extern "C" int rsn_lzss_commit(const void* x, const void* L, const void* D, const void* lengths, void* tok,
                               void* tok_len, void* workspace, int B, int S, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int spans = (int)max(1LL, ((long long)S + SPAN - 1) / SPAN);
    const size_t n = (size_t)B * spans * SPAN_SEGS;
    int32_t* w = (int32_t*)workspace;
    const Workspace ws = {w, w + n, w + 2 * n, w + 3 * n};
    const auto *Lm = (const int32_t*)L, *Dm = (const int32_t*)D, *len = (const int32_t*)lengths;
    lzss_commit_kernel_spec<<<B * spans, SPAN_SEGS, 0, st>>>(Lm, Dm, len, ws, S, spans);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    lzss_commit_kernel_chain<<<B, SPAN_SEGS, 0, st>>>(Lm, Dm, len, ws, (int32_t*)tok_len, S, spans);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    lzss_commit_kernel_write<<<B * spans, SPAN_SEGS, 0, st>>>((const uint8_t*)x, Lm, Dm, len, ws, (uint8_t*)tok, S,
                                                            spans);
    return (int)cudaGetLastError();
}
