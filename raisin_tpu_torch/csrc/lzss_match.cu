// Kernel D: exact per-position greedy longest match (LZSS match search).
//
// Replaces raisin_tpu/ops/lzss_jax.py:_match_scan (an XLA lax.scan, via
// find_matches_blocks). For position i of a block of length n and each
// distance d in 1..min(window, i), the capped forward run is
// c_d = min(run_d(i), d), where run_d(i) is the longest k with
// x[i + t] == x[i + t - d] for all t < k and i + t < n. The match is the max
// over d of the key (c_d << 16) | d: the longest capped run, ties to the
// largest distance (the leftmost occurrence). Positions with no match, and
// positions at or past n, get (0, 0).
//
// The search may be restricted to the distances d_lo < d <= d_hi, the
// JAX scan's sub-range (d0, d0 + wl] that one rank of the tensor-parallel
// match search takes (parallel/lzss_sharded.py); the full window is
// d_lo = 0, d_hi = window, and "window" below means d_hi. Where the range
// enters: each tile's span reaches d_hi back; the chain walk passes over
// candidates at d <= d_lo on their link alone (each still a step of the
// budget); the one-byte rule looks for the earliest occurrence at
// distances in the range only; and the sweep runs the recurrence over
// d_lo + 1 .. d_hi.
//
// What bounds it. Trying every distance at every position is n * window
// capped-run updates (2.7e11 for 1024 blocks of 64 KiB at window 4096),
// while on text a position shares its first two bytes with only ~45
// earlier positions of its window. So the kernel walks those candidates,
// and sweeps all distances only where candidates are too many. The walk is
// bound by shared-memory loads at scattered addresses (one to three a
// candidate), so it keeps them few: a candidate's link and two of its bytes
// in one word, a 4-byte check before any compare, and no compare at all for
// a candidate that can only tie.
//
// - Tiles. One CTA takes TILE_POS positions [p, p + TILE_POS) of one block
//   (grid = blocks x tiles), with the span [p - window, p + TILE_POS +
//   window) of its bytes in shared memory: the left part is the window of
//   its first position, the right part what a capped run can reach
//   (c <= d <= window).
// - Chain path (windows <= CHAIN_MAX_WINDOW). BUILDERS warps link every
//   position of the span to the previous one with the same hash of its
//   2-gram (each warp a segment, __match_any_sync over 32 positions at a
//   time, a head table of its own; a chain starting in a later segment is
//   then linked to the heads of the earlier ones). A position's 32-bit
//   entry holds its link (a uint16 span offset) and its bytes 2 and 3.
//   Thread t takes positions p + t, p + t + blockDim.x, ... and walks its
//   chain nearest first while d <= min(window, i). Every d with c_d >= 2
//   shares the 2-gram, so it is on the chain. Once the best run so far is
//   4 or more, a candidate whose bytes 2, 3 differ cannot reach it and is
//   passed over on its entry alone. Otherwise a candidate whose bytes
//   best - 3 .. best - 1 match may tie the best (if its earlier bytes match
//   too); one whose byte best matches as well may beat it, and only that
//   one is compared (4 bytes a step) at once. A tie moves D to the larger
//   d, so the walk only remembers the farthest possible tie and compares it
//   at the end; if it is no tie, the chain is walked again, comparing every
//   possible tie past the best's distance. With no candidate of c >= 2, L
//   is 1 and D the distance of the earliest occurrence of x[i] in the
//   window (a 16-byte scan), or (0, 0) if the byte does not occur there.
// - Sweep path. A thread whose position takes more than BUDGET chain and
//   compare steps raises a flag; the CTA then drops its chain results and
//   runs the capped-run recurrence over all distances,
//       c[i][d] = (x[i] == x[i-d]) ? min(c[i+1][d] + 1, d) : 0,
//   walking positions down from min(n, p + TILE_POS + window) to p. That
//   start is exact because c <= d <= window. Each lane owns KG = 4
//   consecutive distances with their runs and bytes in registers; per
//   position a warp folds its lanes' keys with __reduce_max_sync into a
//   shared tile of best keys (positions above the tile only advance the
//   runs). Windows wider than one pass of the CTA's distances run more
//   passes, keeping earlier passes' keys in the L output.
// - Windows above CHAIN_MAX_WINDOW take the sweep path with one tile per
//   block, as before the chain path existed (their span, the whole block,
//   sits in shared memory when it fits and is read from device memory
//   otherwise).
//
// A chain tile holds 112 KiB of shared memory at window 4096 (bytes 24 KiB,
// entries 80 KiB, heads 8 KiB) and the kernel at most 32 registers, so two
// CTAs of 1024 threads share an SM. Each CTA adds one to counts[0] (chain)
// or counts[1] (sweep) when its tile holds a position below n.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int THREADS = 1024;
constexpr int KG = 4;                   // sweep: distances per lane and pass
constexpr int TILE = 4096;              // sweep: positions per shared tile of best keys
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int TILE_POS = 16384;         // positions per CTA on windows that may take the chain path
constexpr int CHAIN_MAX_WINDOW = 8191;  // the chain path's span and offsets fit shared memory and uint16
constexpr int HASH_BITS = 11;
constexpr int HASH_SIZE = 1 << HASH_BITS;
constexpr int BUILDERS = 2;             // warps that link the chains, a head table each
constexpr int BUDGET = 1024;            // chain and compare steps a position may take
constexpr int PAD = 16;                 // bytes read past the span by the word loads
constexpr uint16_t NIL = 0xFFFFu;

__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
    return ((a | (b << 8)) * 0x9E3779B1u) >> (32 - HASH_BITS);
}

// Bytes xs[k .. k + 3] as a little-endian word (xs is 16-byte aligned).
__device__ __forceinline__ uint32_t load4(const uint8_t* xs, int k) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(xs);
    return __funnelshift_r(w[k >> 2], w[(k >> 2) + 1], (k & 3) * 8);
}

// 0x80 in byte t of the result for the bytes t of w that are zero, at least
// in the lowest such byte (exact there; a flag above a zero byte may be false).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t w) { return (w - 0x01010101u) & ~w & 0x80808080u; }

// The earliest k in [a, b) with xs[k] == byte, or -1: 16 bytes a step
// (xs is 16-byte aligned and readable 16 bytes past b).
__device__ __forceinline__ int first_occurrence(const uint8_t* xs, int a, int b, uint32_t byte) {
    const uint32_t v = byte * 0x01010101u;
    int base = a & ~15;
    uint4 q = *reinterpret_cast<const uint4*>(xs + base);
    // bytes of the first 16 below a are no candidates: make them differ
    const int skip = a - base;
    const uint32_t below[4] = {
        skip >= 4 ? FULL_MASK : ~(FULL_MASK << (8 * skip)),
        skip >= 8 ? FULL_MASK : skip <= 4 ? 0u : ~(FULL_MASK << (8 * (skip - 4))),
        skip >= 12 ? FULL_MASK : skip <= 8 ? 0u : ~(FULL_MASK << (8 * (skip - 8))),
        skip <= 12 ? 0u : ~(FULL_MASK << (8 * (skip - 12))),
    };
    q.x = (q.x ^ v) | below[0];
    q.y = (q.y ^ v) | below[1];
    q.z = (q.z ^ v) | below[2];
    q.w = (q.w ^ v) | below[3];
    while (true) {
        const uint32_t z[4] = {zero_bytes(q.x), zero_bytes(q.y), zero_bytes(q.z), zero_bytes(q.w)};
        if (z[0] | z[1] | z[2] | z[3]) {
            const int t = z[0] ? 0 : z[1] ? 1 : z[2] ? 2 : 3;
            const int k = base + 4 * t + ((__ffs(z[t]) - 1) >> 3);
            return k < b ? k : -1;
        }
        base += 16;
        if (base >= b) return -1;
        q = *reinterpret_cast<const uint4*>(xs + base);
        q.x ^= v;
        q.y ^= v;
        q.z ^= v;
        q.w ^= v;
    }
}

// One position of a warp's sweep: the lanes' best keys folded into the
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

// A warp's sweep down positions [lo, hi) of the span: the capped runs of the
// lane's KG distances dbase .. dbase + KG - 1, and with kFold the keys
// folded into best (indexed from lo). Span index 0 is either the block's
// start or the window's start of the tile's first position, so i - d >= 0
// is the block-start mask in both cases.
template <bool kFold>
__device__ __forceinline__ void sweep_segment(const uint8_t* xs, int hi, int lo, int dbase, int wtop,
                                              int lane, uint32_t (&c)[KG], const uint32_t (&cap)[KG],
                                              uint32_t* best) {
    uint32_t mine = 0u;
    int i = hi - 1;
    // positions i >= wtop: i - d >= 0 for all the warp's distances, and
    // byte k of w is x[i - dbase - k], so each position loads one new byte
    // per lane instead of KG
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
                if (kFold) m = max(m, (c[k] << 16) | (uint32_t)(dbase + k));
            }
            if (kFold) fold_key(m, i, lo, lane, mine, best);
        }
    }
    for (; i >= lo; --i) {  // near the span's start: check i - d >= 0
        const uint32_t xi = xs[i];
        uint32_t m = 0u;
#pragma unroll
        for (int k = 0; k < KG; ++k) {
            const int j = i - dbase - k;
            const bool eq = j >= 0 && xs[j] == xi;
            c[k] = eq ? min(c[k] + 1u, cap[k]) : 0u;
            if (kFold) m = max(m, (c[k] << 16) | (uint32_t)(dbase + k));
        }
        if (kFold) fold_key(m, i, lo, lane, mine, best);
    }
}

// The sweep path: keys of span positions [keep_lo, keep_hi) over distances
// d_lo + 1 .. maxd, the runs started at span position top (all from this CTA).
__device__ void sweep_tile(const uint8_t* xs, int top, int keep_lo, int keep_hi, int d_lo, int maxd,
                           int32_t* Lrow, int32_t* Drow, uint32_t* best) {
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int per_pass = (nthreads >> 5) * KG * 32;
    if (maxd <= d_lo) {  // uniform across the CTA: no distance of the range fits
        for (int i = keep_lo + tid; i < keep_hi; i += nthreads) {
            Lrow[i] = 0;
            Drow[i] = 0;
        }
        return;
    }
    const int passes = (maxd - d_lo + per_pass - 1) / per_pass;
    for (int pass = 0; pass < passes; ++pass) {
        const bool last = pass == passes - 1;
        const int d0 = d_lo + pass * per_pass;  // the pass's distances are d0 + 1 .. d0 + per_pass
        // lane l of warp w owns the KG consecutive distances dbase .. dbase + KG - 1
        const int dbase = d0 + (warp * 32 + lane) * KG + 1;
        const int wtop = d0 + (warp + 1) * 32 * KG;  // the warp's largest distance
        const bool idle = d0 + warp * 32 * KG + 1 > maxd;
        uint32_t cap[KG];  // the run cap: d, or 0 for distances past maxd (never match)
        uint32_t c[KG];
#pragma unroll
        for (int k = 0; k < KG; ++k) {
            cap[k] = dbase + k <= maxd ? (uint32_t)(dbase + k) : 0u;
            c[k] = 0u;
        }
        if (!idle) sweep_segment<false>(xs, top, keep_hi, dbase, wtop, lane, c, cap, best);
        for (int hi = keep_hi; hi > keep_lo; hi -= TILE) {
            const int lo = max(keep_lo, hi - TILE);
            for (int i = lo + tid; i < hi; i += nthreads) best[i - lo] = pass == 0 ? 0u : (uint32_t)Lrow[i];
            __syncthreads();
            if (!idle) sweep_segment<true>(xs, hi, lo, dbase, wtop, lane, c, cap, best);
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

// The run of span positions a and b (a > b), up to lim bytes, four a step.
__device__ __forceinline__ int run_length(const uint8_t* xs, int a, int b, int lim, int& steps) {
    int run = 0;
    while (run < lim) {
        ++steps;
        const uint32_t diff = load4(xs, a + run) ^ load4(xs, b + run);
        if (diff) {
            run += (__ffs(diff) - 1) >> 3;
            break;
        }
        run += 4;
    }
    return min(run, lim);
}

// The chain path over span positions [keep_lo, keep_hi) (Lrow, Drow in span
// coordinates; i = li + s0 in the block) and distances (d_lo, d_hi]; the
// first m span positions have a 2-gram (i + 1 < n). Returns false when a
// position passed BUDGET steps (the CTA then sweeps; what was written here
// is overwritten).
__device__ bool chain_tile(const uint8_t* xs, uint32_t* links, uint16_t* head, volatile int* flag, int m,
                           int keep_lo, int keep_hi, int s0, int n, int d_lo, int d_hi, int32_t* Lrow,
                           int32_t* Drow) {
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    for (int k = tid; k < BUILDERS * HASH_SIZE / 2; k += nthreads) reinterpret_cast<uint32_t*>(head)[k] = FULL_MASK;
    // entry k: its link (the hash until it is linked) and bytes k + 2, k + 3
    for (int k = tid; k < m; k += nthreads)
        links[k] = hash2(xs[k], xs[k + 1]) | ((uint32_t)xs[k + 2] << 16) | ((uint32_t)xs[k + 3] << 24);
    uint16_t* prev = reinterpret_cast<uint16_t*>(links);  // the link of entry k is prev[2 * k]
    __syncthreads();
    // BUILDERS warps link the chains of consecutive segments, each in
    // position order with a head table of its own
    const int seg = (m + BUILDERS * 32 - 1) / (BUILDERS * 32) * 32;
    if (tid < BUILDERS * 32) {
        const int lane = tid & 31;
        const int hi = min(m, (tid / 32 + 1) * seg);
        uint16_t* heads = head + (tid / 32) * HASH_SIZE;
        for (int base = tid / 32 * seg; base < hi; base += 32) {
            const int k = base + lane;
            const bool valid = k < hi;
            const uint32_t h = valid ? prev[2 * k] : HASH_SIZE + lane;  // idle lanes match no one
            const uint32_t same = __match_any_sync(FULL_MASK, h);
            const uint32_t below = same & ((1u << lane) - 1u);
            const uint16_t link = below ? (uint16_t)(base + 31 - __clz(below)) : valid ? heads[h] : NIL;
            __syncwarp();
            if (valid) {
                prev[2 * k] = link;
                if ((same >> lane) == 1u) heads[h] = (uint16_t)k;  // the group's last position
            }
            __syncwarp();
        }
    }
    __syncthreads();
    // a chain that starts in a later segment continues at the last position
    // with its hash in the segments before
    for (int k = seg + tid; k < m; k += nthreads) {
        if (prev[2 * k] != NIL) continue;
        const uint32_t h = hash2(xs[k], xs[k + 1]);
        for (int s = k / seg - 1; s >= 0; --s) {
            const uint16_t last = head[s * HASH_SIZE + h];
            if (last != NIL) {
                prev[2 * k] = last;
                break;
            }
        }
    }
    __syncthreads();

    for (int li = keep_lo + tid; li < keep_hi; li += nthreads) {
        if (*flag) break;
        const int maxd = min(d_hi, li + s0);
        const int room = n - s0 - li;  // bytes from i to the block's end
        int best = 1, best_d = 0, steps = 0;  // runs of 2 or more count here
        if (li < m) {
            // Candidates j = li - d, nearest first. Once best >= 4, a
            // candidate that ties or beats it shares bytes 0 .. 3 with li,
            // so one whose bytes 2, 3 (in its entry, loaded with its link)
            // differ is passed over. The word at off = max(best - 3, 0)
            // holds byte best at index k = best - off: bytes off .. best - 1
            // equal means a tie is possible (if bytes 0 .. off - 1 are equal
            // too), byte best as well means a longer run is. A longer run is
            // measured at once; a tie, which moves D to the larger d, is only
            // remembered, and the farthest one is checked at the end.
            // Candidates at d <= d_lo lie outside the range: passed over
            // (the re-walk below only looks past best_d > d_lo).
            const uint32_t own = links[li] >> 16;
            const int jmin = li - maxd;  // NIL lies above li, so one compare ends the walk
            int off = 0, tie = NIL;
            uint32_t ref = load4(xs, li), tie_mask = 0xFFu, more_mask = 0xFFFFu;
            for (int j = links[li] & 0xFFFFu; (unsigned)(j - jmin) <= (unsigned)maxd;) {
                ++steps;
                const uint32_t entry = links[j];
                const int d = li - j;
                if (d > d_lo && (best < 4 || entry >> 16 == own)) {
                    const uint32_t diff = load4(xs, j + off) ^ ref;
                    if ((diff & tie_mask) == 0u && d >= best) {
                        if ((diff & more_mask) == 0u && d > best && room > best) {
                            const int run = run_length(xs, li, j, min(d, room), steps);
                            if (run > best) {
                                best = run;
                                best_d = d;
                                tie = NIL;
                                off = max(best - 3, 0);
                                ref = load4(xs, li + off);
                                const int k = best - off;
                                tie_mask = ~(FULL_MASK << (8 * k));
                                more_mask = k == 3 ? FULL_MASK : ~(FULL_MASK << (8 * (k + 1)));
                            }
                        } else if (best >= 2) {
                            tie = j;
                        }
                    }
                }
                if (steps > BUDGET) break;
                j = entry & 0xFFFFu;
            }
            if (tie != NIL && steps <= BUDGET) {
                if (run_length(xs, li, tie, min(li - tie, room), steps) >= best) {
                    best_d = li - tie;
                } else {  // not a tie: walk again, measuring every possible tie past best_d
                    for (int j = links[li] & 0xFFFFu; (unsigned)(j - jmin) <= (unsigned)maxd && steps <= BUDGET;) {
                        ++steps;
                        const uint32_t entry = links[j];
                        const int d = li - j;
                        if (d > best_d && d >= best && (best < 4 || entry >> 16 == own) &&
                            ((load4(xs, j + off) ^ ref) & tie_mask) == 0u &&
                            run_length(xs, li, j, min(d, room), steps) >= best)
                            best_d = d;
                        j = entry & 0xFFFFu;
                    }
                }
            }
            if (steps > BUDGET) {
                *flag = 1;
                break;
            }
        }
        if (best < 2) {  // no 2-gram match: the earliest occurrence of the byte in the range, if any
            best = best_d = 0;
            if (maxd > d_lo) {
                const int k = first_occurrence(xs, li - maxd, li - d_lo, xs[li]);
                if (k >= 0) {
                    best = 1;
                    best_d = li - k;
                }
            }
        }
        Lrow[li] = best;
        Drow[li] = best_d;
    }
    __syncthreads();
    return *flag == 0;
}

template <bool kSmemSpan>
__global__ void __launch_bounds__(THREADS, 2)  // two CTAs an SM: at most 32 registers
lzss_match_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lengths, int32_t* __restrict__ L,
                  int32_t* __restrict__ D, int* __restrict__ counts, int S, int d_lo, int d_hi, int tile_pos,
                  int tiles, bool chain, int span_bytes, int prev_bytes) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int b = blockIdx.x / tiles;
    const int p = (blockIdx.x % tiles) * tile_pos;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int n = min(max(lengths[b], 0), S);
    const uint8_t* xrow = x + (size_t)b * S;
    int32_t* Lrow = L + (size_t)b * S;
    int32_t* Drow = D + (size_t)b * S;

    const int p_end = min(p + tile_pos, S);
    for (int i = max(p, n) + tid; i < p_end; i += nthreads) {  // past the length: (0, 0)
        Lrow[i] = 0;
        Drow[i] = 0;
    }
    const int pe = min(p_end, n);
    if (p >= pe) return;  // uniform: no position below n
    const int s0 = max(0, p - d_hi);
    const int e = min(n, p + tile_pos + d_hi);  // no capped run of [p, pe) reaches past e
    uint8_t* region = smem + (kSmemSpan ? span_bytes : 0);
    uint32_t* best = reinterpret_cast<uint32_t*>(region);
    uint32_t* links = reinterpret_cast<uint32_t*>(region);
    uint16_t* head = reinterpret_cast<uint16_t*>(region + prev_bytes);
    volatile int* flag = reinterpret_cast<volatile int*>(region + prev_bytes + 2 * BUILDERS * HASH_SIZE);

    const uint8_t* xs = xrow + s0;
    if (kSmemSpan) {
        for (int k = tid; k < e - s0 + PAD; k += nthreads) smem[k] = k < e - s0 ? xrow[s0 + k] : 0;
        xs = smem;
    }
    if (tid == 0 && chain) *flag = 0;
    __syncthreads();

    // span coordinates from here on
    Lrow += s0;
    Drow += s0;
    const int keep_lo = p - s0, keep_hi = pe - s0;
    const bool chained =
        chain &&
        chain_tile(xs, links, head, flag, min(pe, n - 1) - s0, keep_lo, keep_hi, s0, n, d_lo, d_hi, Lrow, Drow);
    if (!chained) sweep_tile(xs, e - s0, keep_lo, keep_hi, d_lo, min(d_hi, pe - 1), Lrow, Drow, best);
    if (tid == 0) atomicAdd(&counts[chained ? 0 : 1], 1);
}

size_t round16(size_t v) { return (v + 15) / 16 * 16; }

}  // namespace

// Distances (d_lo, d_hi], 0 <= d_lo < d_hi; the whole window is d_lo = 0, d_hi = window.
extern "C" int rsn_lzss_match(const void* x, const void* lengths, void* L, void* D, void* counts, int B, int S,
                              int d_lo, int d_hi, void* stream) {
    if (d_lo < 0 || d_hi <= d_lo) return (int)cudaErrorInvalidValue;
    const bool chain = d_hi <= CHAIN_MAX_WINDOW;
    const int tile_pos = chain ? TILE_POS : S;
    const int tiles = (S + tile_pos - 1) / tile_pos;
    if ((long long)B * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    const long long span = chain ? (long long)TILE_POS + 2LL * d_hi : (long long)S;
    const size_t span_bytes = round16((size_t)(span < S ? span : S) + PAD);
    size_t prev_bytes = 0, region = TILE * sizeof(uint32_t);
    if (chain) {
        const long long linked = (long long)TILE_POS + d_hi;  // positions that carry a link
        prev_bytes = round16(4 * (size_t)(linked < S ? linked : S));
        const size_t chain_bytes = prev_bytes + 2 * BUILDERS * HASH_SIZE + 16;  // links, heads, the flag
        region = chain_bytes > region ? chain_bytes : region;
    }
    const bool smem_span = span_bytes + region <= (size_t)SMEM_LIMIT;
    if (chain && !smem_span) return (int)cudaErrorInvalidConfiguration;  // cannot happen: <= 129 KiB
    const size_t smem = region + (smem_span ? span_bytes : 0);
    const dim3 grid((unsigned)(B * tiles));
    cudaError_t err;
    if (smem_span) {
        err = cudaFuncSetAttribute(lzss_match_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute(lzss_match_kernel<true>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
        lzss_match_kernel<true><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const uint8_t*)x, (const int32_t*)lengths, (int32_t*)L, (int32_t*)D, (int*)counts, S, d_lo, d_hi,
            tile_pos, tiles, chain, (int)span_bytes, (int)prev_bytes);
    } else {
        err = cudaFuncSetAttribute(lzss_match_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute(lzss_match_kernel<false>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
        lzss_match_kernel<false><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const uint8_t*)x, (const int32_t*)lengths, (int32_t*)L, (int32_t*)D, (int*)counts, S, d_lo, d_hi,
            tile_pos, tiles, chain, (int)span_bytes, (int)prev_bytes);
    }
    return (int)cudaGetLastError();
}
