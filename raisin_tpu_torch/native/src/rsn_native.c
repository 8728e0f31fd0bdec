/* Native host runtime for the `.rsn` wire formats.
 *
 * The port's copy of raisin_tpu/native/src/rsn_native.c. Exact-format C
 * implementations of the sequential hot paths that have no parallelism to
 * give a card (whole-file decode of formats that carry no length metadata)
 * and do not run acceptably in Python. Formats match raisin_tpu_torch.formats
 * byte-for-byte (which in turn match the Go reference; citations inline).
 *
 * One change from the original, which alters no byte it writes correctly:
 * the "<D,L>" token buffers hold two longs of 20 digits each (the original's
 * 16 bytes overflow once D and L have 14 digits between them, at windows of
 * about 10^6). Additions, the port's own (the last two sections): Go's
 * Huffman tree of a byte-count table (hf_tree), and the text codec of the
 * container's Huffman block headers with each block's tree, a batch a call
 * (rsn_huffman_encode_tables, rsn_huffman_headers, rsn_huffman_read_headers).
 *
 * Exported ABI (ctypes): every function returns the number of bytes written
 * to *out, or a negative error code. `rsn_buf` outputs are malloc'd and
 * must be released with rsn_free.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define RSN_ERR_ALLOC -1
#define RSN_ERR_FORMAT -2

/* ------------------------------------------------------------------ */
/* growable output buffer                                              */

typedef struct {
    uint8_t *p;
    size_t len;
    size_t cap;
} buf_t;

static int buf_init(buf_t *b, size_t cap) {
    b->p = (uint8_t *)malloc(cap ? cap : 64);
    b->len = 0;
    b->cap = cap ? cap : 64;
    return b->p ? 0 : -1;
}

static int buf_reserve(buf_t *b, size_t extra) {
    if (b->len + extra <= b->cap) return 0;
    size_t cap = b->cap;
    while (cap < b->len + extra) cap *= 2;
    uint8_t *np = (uint8_t *)realloc(b->p, cap);
    if (!np) return -1;
    b->p = np;
    b->cap = cap;
    return 0;
}

static int buf_push(buf_t *b, uint8_t v) {
    if (buf_reserve(b, 1)) return -1;
    b->p[b->len++] = v;
    return 0;
}

static int buf_append(buf_t *b, const uint8_t *src, size_t n) {
    if (buf_reserve(b, n)) return -1;
    memcpy(b->p + b->len, src, n);
    b->len += n;
    return 0;
}

void rsn_free(uint8_t *p) { free(p); }

/* ------------------------------------------------------------------ */
/* LZSS (compressor/lz/lzss.go semantics)                              */

#define LZ_OPENING 0x3C
#define LZ_CLOSING 0x3E
#define LZ_SEP 0x2C
#define LZ_ENC_OPENING 0xFF
#define LZ_ESCAPE 0x5C

/* escape pre-pass (lzss.go:369) */
static int lz_escape(const uint8_t *in, long n, buf_t *out) {
    for (long i = 0; i < n; i++) {
        uint8_t v = in[i];
        if (v == LZ_OPENING) {
            if (buf_push(out, LZ_ENC_OPENING)) return -1;
        } else if (v == LZ_ENC_OPENING || v == LZ_ESCAPE) {
            if (buf_push(out, LZ_ESCAPE) || buf_push(out, v)) return -1;
        } else {
            if (buf_push(out, v)) return -1;
        }
    }
    return 0;
}

/* escape decode pass (lzss.go:391) */
static int lz_unescape(const uint8_t *in, size_t n, buf_t *out) {
    int esc = 0;
    for (size_t i = 0; i < n; i++) {
        uint8_t v = in[i];
        if (v == LZ_ENC_OPENING && !esc) {
            if (buf_push(out, LZ_OPENING)) return -1;
        } else if (v == LZ_ESCAPE && !esc) {
            esc = 1;
        } else {
            esc = 0;
            if (buf_push(out, v)) return -1;
        }
    }
    return 0;
}

/* "<", ",", ">" and two longs of at most 20 digits each */
#define LZ_TOKEN_MAX 43

static int lz_token(uint8_t *tmp, long d, long l) {
    /* "<D,L>" — decimal ASCII (lzss.go:318); returns length */
    int k = 0;
    tmp[k++] = LZ_OPENING;
    char num[20];
    int m = 0;
    long v = d;
    do { num[m++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (m) tmp[k++] = (uint8_t)num[--m];
    tmp[k++] = LZ_SEP;
    v = l;
    do { num[m++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (m) tmp[k++] = (uint8_t)num[--m];
    tmp[k++] = LZ_CLOSING;
    return k;
}

/* exact greedy match search + commit (CompressAsync semantics, lzss.go:109):
 * per position, the longest k with enc[i:i+k] a substring of the trailing
 * window and the LEFTMOST occurrence (bytes.Index). Hash chains over 3-byte
 * prefixes enumerate all >=3 candidates (every occurrence of the final
 * longest string shares the 3-byte prefix, so the walk is complete); 1- and
 * 2-byte existence comes from small recency tables. Tokens shorter than 6
 * bytes are never emitted (min token length 5), so D only matters when the
 * chain produced it.
 *
 * Search and commit run FUSED in one pass: the greedy commit consumes L
 * positions per match (lzss.go:136-151), and the L/D values of consumed
 * positions are never read, so the chain walk is skipped there (only the
 * O(1) table advances run). On long uniform runs — where every position
 * shares one hash bucket and every candidate extends to the window — this
 * is the difference between O(n * window^2) and O(commits * window). */
#define HASH_BITS 16
#define HASH_SIZE (1 << HASH_BITS)

static inline uint32_t hash3(const uint8_t *p) {
    return ((uint32_t)p[0] * 506832829u + (uint32_t)p[1] * 2654435761u +
            (uint32_t)p[2] * 40503u) >> (32 - HASH_BITS);
}

long rsn_lzss_compress(const uint8_t *in, long n_in, int window,
                       uint8_t **out_p, long *out_len) {
    buf_t enc;
    if (buf_init(&enc, (size_t)n_in + 16)) return RSN_ERR_ALLOC;
    if (lz_escape(in, n_in, &enc)) { free(enc.p); return RSN_ERR_ALLOC; }
    long n = (long)enc.len;
    const uint8_t *x = enc.p;

    int32_t *head = (int32_t *)malloc(sizeof(int32_t) * HASH_SIZE);
    int32_t *next = (int32_t *)malloc(sizeof(int32_t) * (size_t)(n > 0 ? n : 1));
    int32_t last1[256];
    int32_t last2[65536][2]; /* two most recent starts per pair */
    buf_t out;
    if (!head || !next || buf_init(&out, (size_t)n + 16)) {
        free(enc.p); free(head); free(next);
        return RSN_ERR_ALLOC;
    }
    memset(head, -1, sizeof(int32_t) * HASH_SIZE);
    for (int i = 0; i < 256; i++) last1[i] = -1;
    memset(last2, -1, sizeof(last2));

    uint8_t tok[LZ_TOKEN_MAX];
    long ignore = 0; /* positions consumed by the last commit */
    int oom = 0;
    for (long i = 0; i < n && !oom; i++) {
        if (ignore == 0) {
            long lo = i - window;
            if (window <= 0) lo = 0;
            if (lo < 0) lo = 0;

            long bestl = 0, bests = -1;
            /* 1-byte existence: any s in [lo, i-1] with x[s] == x[i] */
            if (last1[x[i]] >= lo) bestl = 1;
            /* 2-byte existence: any s in [lo, i-2] */
            if (i + 1 < n) {
                uint32_t pair = ((uint32_t)x[i] << 8) | x[i + 1];
                int32_t s0 = last2[pair][0], s1 = last2[pair][1];
                if ((s0 >= lo && s0 <= i - 2) || (s1 >= lo && s1 <= i - 2)) bestl = 2;
            }
            /* >=3: walk the chain (most-recent first), track longest +
             * leftmost. A candidate's usable length is capped by i-s (match
             * fully in the prefix) and n-i; the D candidate set is exactly
             * the occurrences whose capped length equals the best length. */
            if (i + 2 < n) {
                for (int32_t s = head[hash3(x + i)]; s >= 0 && s >= lo; s = next[s]) {
                    long cap = i - s;
                    long maxl = n - i < cap ? n - i : cap;
                    if (maxl < bestl) continue; /* can't match or tie */
                    long l = 0;
                    while (l < maxl && x[s + l] == x[i + l]) l++;
                    if (l > bestl) {
                        bestl = l;
                        bests = s;
                    } else if (l == bestl && l > 0 && (bests < 0 || s < bests)) {
                        bests = s; /* leftmost occurrence at the best length */
                    }
                }
            }

            /* commit (lzss.go:134-151) */
            if (bestl > 0) {
                ignore = bestl - 1;
                int tl = lz_token(tok, bests >= 0 ? (int32_t)(i - bests) : 0,
                                  bestl);
                if (tl < bestl) {
                    oom = buf_append(&out, tok, (size_t)tl);
                } else {
                    oom = buf_append(&out, x + i, (size_t)bestl);
                }
            } else {
                oom = buf_push(&out, x[i]);
            }
        } else {
            ignore--;
        }

        /* advance tables with position i */
        last1[x[i]] = (int32_t)i;
        if (i + 1 < n) {
            uint32_t pair = ((uint32_t)x[i] << 8) | x[i + 1];
            last2[pair][1] = last2[pair][0];
            last2[pair][0] = (int32_t)i;
        }
        if (i + 2 < n) {
            uint32_t h = hash3(x + i);
            next[i] = head[h];
            head[h] = (int32_t)i;
        }
    }

    free(enc.p); free(head); free(next);
    if (oom) { free(out.p); return RSN_ERR_ALLOC; }
    *out_p = out.p;
    *out_len = (long)out.len;
    return 0;
}

long rsn_lzss_decompress(const uint8_t *in, long n, uint8_t **out_p, long *out_len) {
    /* token state machine (lzss.go:332) over the escaped stream, then the
     * escape decode pass */
    buf_t search;
    if (buf_init(&search, (size_t)n + 16)) return RSN_ERR_ALLOC;
    long pointer = 0, offset = 0;
    long num = 0;
    int state = 0; /* 0: literal/looking-for '<', 1: pointer, 2: offset */
    int err = 0;
    for (long i = 0; i < n && !err; i++) {
        uint8_t v = in[i];
        if (state == 0) {
            if (v == LZ_OPENING) { state = 1; num = 0; }
            else err = buf_push(&search, v) ? RSN_ERR_ALLOC : 0;
        } else if (state == 1) {
            if (v == LZ_SEP) { pointer = num; num = 0; state = 2; }
            else if (v >= '0' && v <= '9') num = num * 10 + (v - '0');
            /* non-digits: Go's Atoi would yield 0; digits-only in valid data */
        } else {
            if (v == LZ_CLOSING) {
                offset = num; num = 0; state = 0;
                long abs = (long)search.len - pointer;
                if (abs < 0 || abs + offset > (long)search.len) { err = RSN_ERR_FORMAT; break; }
                if (buf_reserve(&search, (size_t)offset)) { err = RSN_ERR_ALLOC; break; }
                memcpy(search.p + search.len, search.p + abs, (size_t)offset);
                search.len += (size_t)offset;
            } else if (v >= '0' && v <= '9') num = num * 10 + (v - '0');
        }
    }
    if (err) { free(search.p); return err; }
    buf_t out;
    if (buf_init(&out, search.len + 16)) { free(search.p); return RSN_ERR_ALLOC; }
    if (lz_unescape(search.p, search.len, &out)) {
        free(search.p); free(out.p); return RSN_ERR_ALLOC;
    }
    free(search.p);
    *out_p = out.p;
    *out_len = (long)out.len;
    return 0;
}

/* ------------------------------------------------------------------ */
/* adaptive arithmetic coder (compressor/arithmetic semantics)         */

#define AR_MAX_CODE 0xFFFFu
#define AR_ONE_FOURTH 0x4000u
#define AR_ONE_HALF 0x8000u
#define AR_THREE_FOURTHS 0xC000u
#define AR_MAX_FREQ 16383
#define AR_EOF 256

typedef struct {
    uint32_t cum[258];
    int frozen;
} ar_model_t;

static void ar_model_init(ar_model_t *m) {
    for (int i = 0; i < 258; i++) m->cum[i] = (uint32_t)i;
    m->frozen = 0;
}

static void ar_model_update(ar_model_t *m, int s) {
    if (m->frozen) return;
    for (int j = s + 1; j < 258; j++) m->cum[j]++;
    if (m->cum[257] >= AR_MAX_FREQ) m->frozen = 1;
}

typedef struct {
    buf_t bits; /* one byte per bit; packed at the end */
} ar_bits_t;

static inline int ar_emit(buf_t *b, int bit, long pending) {
    if (buf_push(b, (uint8_t)bit)) return -1;
    if (buf_reserve(b, (size_t)pending)) return -1;
    memset(b->p + b->len, bit ? 0 : 1, (size_t)pending);
    b->len += (size_t)pending;
    return 0;
}

long rsn_arith_compress(const uint8_t *in, long n, uint8_t **out_p, long *out_len) {
    ar_model_t m;
    ar_model_init(&m);
    buf_t bits;
    if (buf_init(&bits, (size_t)n + 64)) return RSN_ERR_ALLOC;

    uint32_t low = 0, high = AR_MAX_CODE;
    long pending = 0;
    int oom = 0;
    for (long k = 0; k <= n && !oom; k++) {
        int s = (k < n) ? in[k] : AR_EOF;
        uint32_t difference = high - low + 1;
        uint32_t lower = m.cum[s], upper = m.cum[s + 1], count = m.cum[257];
        ar_model_update(&m, s);
        high = low + (difference * upper) / count - 1;
        low = low + (difference * lower) / count;
        for (;;) {
            if (high < AR_ONE_HALF) {
                oom = ar_emit(&bits, 0, pending);
                pending = 0;
            } else if (low >= AR_ONE_HALF) {
                oom = ar_emit(&bits, 1, pending);
                pending = 0;
            } else if (low >= AR_ONE_FOURTH && high < AR_THREE_FOURTHS) {
                pending++;
                low -= AR_ONE_FOURTH;
                high -= AR_ONE_FOURTH;
            } else break;
            if (oom) break;
            high = ((high << 1) + 1) & AR_MAX_CODE;
            low = (low << 1) & AR_MAX_CODE;
        }
        /* NB: no final flush — trailing pending bits drop (format quirk) */
    }
    if (oom) { free(bits.p); return RSN_ERR_ALLOC; }

    /* prepad sentinel (bits.go:48) + MSB pack */
    long pad = 8 - ((long)bits.len % 8);
    long total = (long)bits.len + pad;
    buf_t out;
    if (buf_init(&out, (size_t)(total / 8))) { free(bits.p); return RSN_ERR_ALLOC; }
    uint32_t acc = 0;
    int nb = 0;
    for (long i = 0; i < total; i++) {
        int bit = (i < pad) ? (i == pad - 1) : bits.p[i - pad];
        acc = (acc << 1) | (uint32_t)bit;
        if (++nb == 8) {
            if (buf_push(&out, (uint8_t)acc)) { free(bits.p); free(out.p); return RSN_ERR_ALLOC; }
            acc = 0; nb = 0;
        }
    }
    free(bits.p);
    *out_p = out.p;
    *out_len = (long)out.len;
    return 0;
}

long rsn_arith_decompress(const uint8_t *in, long n, uint8_t **out_p, long *out_len) {
    /* unpack prepad-sentinel bits */
    long total_bits = n * 8;
    long start = -1;
    for (long i = 0; i < total_bits; i++) {
        if ((in[i / 8] >> (7 - (i % 8))) & 1) { start = i + 1; break; }
    }
    if (start < 0) return RSN_ERR_FORMAT;
    long nbits = total_bits - start + 2; /* appended [1,0] tail */

    ar_model_t m;
    ar_model_init(&m);
    uint32_t low = 0, high = AR_MAX_CODE, value = 0;
    long pos = 0;
#define AR_BIT(j) ((j) < nbits ? (((j) < nbits - 2) \
        ? ((in[(start + (j)) / 8] >> (7 - ((start + (j)) % 8))) & 1u) \
        : ((j) == nbits - 2 ? 1u : 0u)) : 0u)
    for (int i = 0; i < 16; i++) value = (value << 1) | AR_BIT(pos), pos++;

    buf_t out;
    if (buf_init(&out, (size_t)(n * 2 + 64))) return RSN_ERR_ALLOC;
    long exhausted = 0;
    for (;;) {
        uint32_t difference = high - low + 1;
        uint32_t count = m.cum[257];
        uint32_t scaled = ((value - low + 1) * count - 1) / difference;
        /* binary search: first s with scaled < cum[s+1] (arithmetic.go:206) */
        int lo_i = 0, hi_i = 257;
        while (lo_i < hi_i) {
            int mid = (lo_i + hi_i) / 2;
            if (scaled < m.cum[mid + 1]) hi_i = mid; else lo_i = mid + 1;
        }
        int s = lo_i;
        uint32_t lower = m.cum[s], upper = m.cum[s + 1];
        ar_model_update(&m, s);
        if (s == AR_EOF) break;
        if (buf_push(&out, (uint8_t)s)) { free(out.p); return RSN_ERR_ALLOC; }
        high = low + (difference * upper) / count - 1;
        low = low + (difference * lower) / count;
        for (;;) {
            if (high < AR_ONE_HALF) {
            } else if (low >= AR_ONE_HALF) {
                value -= AR_ONE_HALF; low -= AR_ONE_HALF; high -= AR_ONE_HALF;
            } else if (low >= AR_ONE_FOURTH && high < AR_THREE_FOURTHS) {
                value -= AR_ONE_FOURTH; low -= AR_ONE_FOURTH; high -= AR_ONE_FOURTH;
            } else break;
            low <<= 1;
            high = (high << 1) + 1;
            value = (value << 1) | AR_BIT(pos);
            if (pos >= nbits) {
                if (++exhausted > 256) { free(out.p); return RSN_ERR_FORMAT; }
            }
            pos++;
        }
    }
#undef AR_BIT
    *out_p = out.p;
    *out_len = (long)out.len;
    return 0;
}

/* ------------------------------------------------------------------ */
/* MCC "Markov chain compressor" (formats/mcc_ref.py; reference
 * compressor/mcc/mcc.go:212,321). Adaptive state machine over
 * byte-labelled states; wire format = ASCII comma-separated transition
 * indices + '\' (0x5C) + literal bytes in first-occurrence order
 * (mcc.go:389-392). Transition lists are re-sorted stably by descending
 * frequency after every hit; stable-sort output is canonical, so the
 * adaptive insertion sort below is byte-exact vs the oracle's list.sort. */

#define MCC_SEP 0x5C
#define MCC_HIGHEST_UP 8 /* 2^8 = 256 (mcc.go:161) */
#define MCC_NTOK (MCC_HIGHEST_UP + 2)

typedef struct mcc_state {
    struct mcc_state *parent;
    struct mcc_state **tr;
    int n_tr, cap_tr;
    int32_t freq;
    int16_t token;
    uint8_t is_tok, is_root, symbol;
} mcc_state_t;

typedef struct mcc_chunk {
    struct mcc_chunk *next;
    int used;
    mcc_state_t states[1024];
} mcc_chunk_t;

typedef struct {
    mcc_chunk_t *head;
    int oom;
} mcc_arena_t;

static mcc_state_t *mcc_alloc(mcc_arena_t *a) {
    if (!a->head || a->head->used == 1024) {
        mcc_chunk_t *c = (mcc_chunk_t *)malloc(sizeof(mcc_chunk_t));
        if (!c) { a->oom = 1; return NULL; }
        c->next = a->head;
        c->used = 0;
        a->head = c;
    }
    mcc_state_t *s = &a->head->states[a->head->used++];
    memset(s, 0, sizeof(*s));
    return s;
}

static void mcc_arena_free(mcc_arena_t *a) {
    mcc_chunk_t *c = a->head;
    while (c) {
        for (int i = 0; i < c->used; i++) free(c->states[i].tr);
        mcc_chunk_t *n = c->next;
        free(c);
        c = n;
    }
    a->head = NULL;
}

static int mcc_tr_push(mcc_state_t *s, mcc_state_t *child) {
    if (s->n_tr == s->cap_tr) {
        int cap = s->cap_tr ? s->cap_tr * 2 : MCC_NTOK;
        mcc_state_t **np = (mcc_state_t **)realloc(s->tr, cap * sizeof(*np));
        if (!np) return -1;
        s->tr = np;
        s->cap_tr = cap;
    }
    s->tr[s->n_tr++] = child;
    return 0;
}

/* the reference's quirky token frequency ramp: Read=900, Up1=800,
 * Up2=-100, ... Up256=-800 (mcc.go:172) */
static int mcc_add_tokens(mcc_arena_t *a, mcc_state_t *s) {
    int freq = 1000;
    for (int i = 0; i < MCC_NTOK; i++) {
        if (i == 2) freq = 0;
        freq -= 100;
        mcc_state_t *t = mcc_alloc(a);
        if (!t) return -1;
        t->is_tok = 1;
        t->token = (int16_t)(i == 0 ? 0 : (1 << (i - 1)));
        t->parent = s;
        t->freq = freq;
        if (mcc_tr_push(s, t)) return -1;
    }
    return 0;
}

static mcc_state_t *mcc_create_state(mcc_arena_t *a, uint8_t symbol, mcc_state_t *parent) {
    mcc_state_t *s = mcc_alloc(a);
    if (!s) return NULL;
    s->symbol = symbol;
    s->parent = parent;
    s->freq = 1;
    if (mcc_add_tokens(a, s)) return NULL;
    if (mcc_tr_push(parent, s)) return NULL;
    return s;
}

/* stable descending insertion sort (canonical stable-sort result) */
static void mcc_sort(mcc_state_t *s) {
    for (int i = 1; i < s->n_tr; i++) {
        mcc_state_t *x = s->tr[i];
        int j = i;
        while (j > 0 && s->tr[j - 1]->freq < x->freq) {
            s->tr[j] = s->tr[j - 1];
            j--;
        }
        s->tr[j] = x;
    }
}

static int mcc_index_in_parent(const mcc_state_t *s) {
    const mcc_state_t *p = s->parent;
    for (int i = 0; i < p->n_tr; i++)
        if (p->tr[i] == s) return i;
    return -1;
}

static mcc_state_t *mcc_tok_state(mcc_state_t *s, int tok) {
    for (int i = 0; i < s->n_tr; i++)
        if (s->tr[i]->is_tok && s->tr[i]->token == tok) return s->tr[i];
    return NULL;
}

static int mcc_parent_with_symbol(mcc_state_t *s, uint8_t symbol) {
    int dist = 0;
    for (;;) {
        if (!s->is_tok && !s->is_root && symbol == s->symbol) return dist;
        if (!s->parent) return -1;
        s = s->parent;
        dist++;
    }
}

static mcc_state_t *mcc_get_parent(mcc_state_t *s, int up) {
    for (int i = 0; i < up; i++) s = s->parent;
    return s;
}

static int mcc_emit_index(buf_t *b, int idx, int *first) {
    char tmp[16];
    int len = 0;
    if (!*first && buf_push(b, ',')) return -1;
    *first = 0;
    if (idx == 0) return buf_push(b, '0');
    while (idx > 0) { tmp[len++] = (char)('0' + idx % 10); idx /= 10; }
    while (len > 0) if (buf_push(b, (uint8_t)tmp[--len])) return -1;
    return 0;
}

long rsn_mcc_compress(const uint8_t *in, long n, uint8_t **out_p, long *out_len) {
    mcc_arena_t arena = {0};
    buf_t stream, literals;
    if (buf_init(&stream, (size_t)n * 2 + 64)) return RSN_ERR_ALLOC;
    if (buf_init(&literals, 256)) { free(stream.p); return RSN_ERR_ALLOC; }
#define MCC_FAIL(code) do { mcc_arena_free(&arena); free(stream.p); free(literals.p); return (code); } while (0)
    mcc_state_t *root = mcc_alloc(&arena);
    if (!root) MCC_FAIL(RSN_ERR_ALLOC);
    root->is_root = 1;
    if (mcc_add_tokens(&arena, root)) MCC_FAIL(RSN_ERR_ALLOC);
    mcc_state_t *state = root;
    int first = 1;

    for (long pos = 0; pos < n; pos++) {
        uint8_t b = in[pos];
        mcc_state_t *match = NULL;
        for (int i = 0; i < state->n_tr; i++)
            if (!state->tr[i]->is_tok && state->tr[i]->symbol == b)
                match = state->tr[i]; /* last match wins (Go loop) */

        if (match) {
            state = match;
            if (mcc_emit_index(&stream, mcc_index_in_parent(state), &first))
                MCC_FAIL(RSN_ERR_ALLOC);
            state->freq++;
            mcc_sort(state->parent);
            continue;
        }

        int up = mcc_parent_with_symbol(state, b);
        if (up == -1) {
            mcc_state_t *ns = mcc_create_state(&arena, b, state);
            if (!ns) MCC_FAIL(RSN_ERR_ALLOC);
            mcc_state_t *rd = mcc_tok_state(state, 0);
            if (!rd) MCC_FAIL(RSN_ERR_FORMAT);
            if (mcc_emit_index(&stream, mcc_index_in_parent(rd), &first))
                MCC_FAIL(RSN_ERR_ALLOC);
            if (buf_push(&literals, b)) MCC_FAIL(RSN_ERR_ALLOC);
            state = ns;
        } else {
            mcc_state_t *orig = state;
            state = mcc_get_parent(state, up);
            state->freq++;
            mcc_sort(state->parent);
            up += 1;
            int encoded = 0;
            for (int i = MCC_HIGHEST_UP; i >= 0; i--) {
                int magnitude = 1 << i;
                if (up - magnitude >= 0) {
                    int divisible = up / magnitude;
                    for (int k = 0; k < divisible; k++) {
                        mcc_state_t *ts = mcc_tok_state(orig, magnitude);
                        if (!ts) MCC_FAIL(RSN_ERR_FORMAT);
                        if (mcc_emit_index(&stream, mcc_index_in_parent(ts), &first))
                            MCC_FAIL(RSN_ERR_ALLOC);
                        up -= magnitude;
                        /* first "up" enters the current state, so one less */
                        orig = mcc_get_parent(orig, encoded ? magnitude : magnitude - 1);
                        encoded = 1;
                    }
                }
            }
            mcc_state_t *rd = mcc_tok_state(state, 0);
            if (!rd) MCC_FAIL(RSN_ERR_FORMAT);
            if (mcc_emit_index(&stream, mcc_index_in_parent(rd), &first))
                MCC_FAIL(RSN_ERR_ALLOC);
        }
    }
#undef MCC_FAIL

    mcc_arena_free(&arena);
    if (buf_push(&stream, MCC_SEP) ||
        buf_append(&stream, literals.p, literals.len)) {
        free(stream.p);
        free(literals.p);
        return RSN_ERR_ALLOC;
    }
    free(literals.p);
    *out_p = stream.p;
    *out_len = (long)stream.len;
    return 0;
}

long rsn_mcc_decompress(const uint8_t *in, long n, uint8_t **out_p, long *out_len) {
    long sep = -1;
    for (long i = 0; i < n; i++)
        if (in[i] == MCC_SEP) { sep = i; break; }
    if (sep < 0) return RSN_ERR_FORMAT;
    /* Go strings.Split yields an empty piece for an empty head or a
     * trailing comma; Atoi("") then panics (mcc.go:401) */
    if (sep == 0 || in[sep - 1] == ',') return RSN_ERR_FORMAT;
    const uint8_t *literals = in + sep + 1;
    long n_lit = n - sep - 1, lit_pos = 0;

    mcc_arena_t arena = {0};
    buf_t out;
    if (buf_init(&out, (size_t)n * 2 + 64)) return RSN_ERR_ALLOC;
#define MCC_DFAIL(code) do { mcc_arena_free(&arena); free(out.p); return (code); } while (0)
    mcc_state_t *root = mcc_alloc(&arena);
    if (!root) MCC_DFAIL(RSN_ERR_ALLOC);
    root->is_root = 1;
    if (mcc_add_tokens(&arena, root)) MCC_DFAIL(RSN_ERR_ALLOC);
    mcc_state_t *state = root;
    int moving_up = 0;

    long p = 0;
    while (p < sep) {
        /* Atoi semantics: every comma-separated piece must be a plain int */
        long q = p;
        int idx = 0, any = 0;
        while (q < sep && in[q] != ',') {
            if (in[q] < '0' || in[q] > '9') MCC_DFAIL(RSN_ERR_FORMAT);
            idx = idx * 10 + (in[q] - '0');
            if (idx > 1 << 20) MCC_DFAIL(RSN_ERR_FORMAT);
            any = 1;
            q++;
        }
        if (!any) MCC_DFAIL(RSN_ERR_FORMAT);
        p = q + 1;

        if (idx >= state->n_tr) MCC_DFAIL(RSN_ERR_FORMAT);
        mcc_state_t *child = state->tr[idx];
        if (child->is_tok) {
            if (child->token == 0) { /* Read */
                if (moving_up) {
                    if (buf_push(&out, state->symbol)) MCC_DFAIL(RSN_ERR_ALLOC);
                    moving_up = 0;
                    state->freq++;
                    mcc_sort(state->parent);
                } else {
                    if (lit_pos >= n_lit) MCC_DFAIL(RSN_ERR_FORMAT);
                    uint8_t symbol = literals[lit_pos++];
                    if (buf_push(&out, symbol)) MCC_DFAIL(RSN_ERR_ALLOC);
                    state = mcc_create_state(&arena, symbol, child->parent);
                    if (!state) MCC_DFAIL(RSN_ERR_ALLOC);
                }
            } else {
                int move_up = child->token;
                if (!moving_up) { moving_up = 1; move_up -= 1; }
                for (int k = 0; k < move_up; k++) {
                    if (!state->parent) MCC_DFAIL(RSN_ERR_FORMAT);
                    state = state->parent;
                }
            }
        } else {
            state = child;
            if (buf_push(&out, state->symbol)) MCC_DFAIL(RSN_ERR_ALLOC);
            state->freq++;
            mcc_sort(state->parent);
        }
    }
#undef MCC_DFAIL

    mcc_arena_free(&arena);
    *out_p = out.p;
    *out_len = (long)out.len;
    return 0;
}

/* ------------------------------------------------------------------ */
/* DMC ("dynamic Markov chain"), compress-only codec.
 *
 * Native port of formats/dmc_ref.py (itself parity with the reference
 * compressor/dmc/dmc.go): build a Markov tree with MoveUp links over the
 * input (dmc.go:32), stable-sort children by occurrences (dmc.go:196),
 * re-walk the input emitting one little-endian int8 per non-implicit
 * transition with a [-2, count] end marker (dmc.go:79-83,148). The file
 * decoder is a stub by reference parity (dmc.go:274). */

#define RSN_ERR_DMC -3

typedef struct {
    int32_t value;
    int32_t occ;
    int32_t move_up;
    int32_t nchild, ccap;
    int32_t *children; /* arena indices */
} dmc_node_t;

typedef struct {
    dmc_node_t *nodes;
    long n, cap;
} dmc_arena_t;

static long dmc_new_node(dmc_arena_t *a, int value, int occ, int move_up) {
    if (a->n >= a->cap) return -1; /* arena pre-sized to 2*n_in + 2 */
    dmc_node_t *nd = &a->nodes[a->n];
    nd->value = value;
    nd->occ = occ;
    nd->move_up = move_up;
    nd->nchild = 0;
    nd->ccap = 0;
    nd->children = NULL;
    return a->n++;
}

static int dmc_push_child(dmc_arena_t *a, long ni, long child) {
    dmc_node_t *nd = &a->nodes[ni];
    if (nd->nchild >= nd->ccap) {
        int ncap = nd->ccap ? nd->ccap * 2 : 4;
        int32_t *p = (int32_t *)realloc(nd->children, sizeof(int32_t) * (size_t)ncap);
        if (!p) return -1;
        nd->children = p;
        nd->ccap = ncap;
    }
    nd->children[nd->nchild++] = (int32_t)child;
    return 0;
}

static int dmc_child_by_value(const dmc_arena_t *a, long ni, int val) {
    const dmc_node_t *nd = &a->nodes[ni];
    for (int i = 0; i < nd->nchild; i++)
        if (a->nodes[nd->children[i]].value == val) return i;
    return -1;
}

static int dmc_child_by_moveup(const dmc_arena_t *a, long ni, int mu) {
    const dmc_node_t *nd = &a->nodes[ni];
    for (int i = 0; i < nd->nchild; i++)
        if (a->nodes[nd->children[i]].move_up == mu) return i;
    return -1;
}

static void dmc_arena_free(dmc_arena_t *a) {
    for (long i = 0; i < a->n; i++) free(a->nodes[i].children);
    free(a->nodes);
}

/* build_chain (dmc.go:36-67 / dmc_ref.build_chain); returns root index or
 * a negative error */
static long dmc_build(dmc_arena_t *a, const uint8_t *in, long n_in,
                      int32_t *stack) {
    long root = dmc_new_node(a, 0, 0, 0); /* Go zero-value root */
    if (root < 0) return RSN_ERR_ALLOC;
    long sp = 0;
    stack[sp++] = (int32_t)root;
    for (long pos = 0; pos < n_in; pos++) {
        int b = in[pos];
        long up_idx = -1;
        for (long i = sp - 1; i >= 0; i--)
            if (a->nodes[stack[i]].value == b) { up_idx = i; break; }
        if (up_idx != -1) {
            long top = stack[sp - 1];
            int mu = (int)(sp - up_idx);
            int mi = dmc_child_by_moveup(a, top, mu);
            if (mi == -1) {
                long child = dmc_new_node(a, 0, 1, mu);
                if (child < 0 || dmc_push_child(a, top, child)) return RSN_ERR_ALLOC;
            } else {
                a->nodes[a->nodes[top].children[mi]].occ++;
            }
            sp = up_idx; /* stack = stack[:up_idx] */
            if (sp == 0) return RSN_ERR_DMC; /* NUL matched root; reference panics */
        }
        long node = stack[sp - 1];
        int idx = dmc_child_by_value(a, node, b);
        if (idx == -1) {
            long child = dmc_new_node(a, b, 1, 0);
            if (child < 0 || dmc_push_child(a, node, child)) return RSN_ERR_ALLOC;
            stack[sp++] = (int32_t)child;
        } else {
            long child = a->nodes[node].children[idx];
            a->nodes[child].occ++;
            stack[sp++] = (int32_t)child;
        }
    }
    return root;
}

/* stable descending sort of every node's children by occurrences
 * (SortNodesByOccurrences, dmc.go:196; stable like dmc_ref._sort_nodes) */
static int dmc_cmp_pair(const void *pa, const void *pb) {
    const int64_t *x = (const int64_t *)pa, *y = (const int64_t *)pb;
    return (*x < *y) ? -1 : (*x > *y);
}

static int dmc_sort_all(dmc_arena_t *a, long root) {
    /* iterative DFS (tree depth can be O(n)); keys pack (-occ, index) so
     * qsort is effectively stable */
    int32_t *todo = (int32_t *)malloc(sizeof(int32_t) * (size_t)(a->n > 0 ? a->n : 1));
    int64_t *keys = NULL;
    int kcap = 0;
    if (!todo) return -1;
    long tp = 0;
    todo[tp++] = (int32_t)root;
    while (tp > 0) {
        long ni = todo[--tp];
        dmc_node_t *nd = &a->nodes[ni];
        if (nd->nchild > 1) {
            if (nd->nchild > kcap) {
                int64_t *p = (int64_t *)realloc(keys, sizeof(int64_t) * (size_t)nd->nchild);
                if (!p) { free(todo); free(keys); return -1; }
                keys = p;
                kcap = nd->nchild;
            }
            for (int i = 0; i < nd->nchild; i++)
                keys[i] = -(int64_t)a->nodes[nd->children[i]].occ * ((int64_t)1 << 32) | (uint32_t)i;
            qsort(keys, (size_t)nd->nchild, sizeof(int64_t), dmc_cmp_pair);
            /* keys' low halves are the old positions in sorted order */
            for (int i = 0; i < nd->nchild; i++) keys[i] = nd->children[(int32_t)(keys[i] & 0xffffffff)];
            for (int i = 0; i < nd->nchild; i++) nd->children[i] = (int32_t)keys[i];
        }
        for (int i = 0; i < nd->nchild; i++)
            if (a->nodes[nd->children[i]].nchild > 0) todo[tp++] = nd->children[i];
    }
    free(todo);
    free(keys);
    return 0;
}

/* GetBitsFromChain re-walk (dmc.go:100-149 / dmc_ref.chain_to_transitions)
 * + int8 wire mapping (dmc.go:81). */
long rsn_dmc_compress(const uint8_t *in, long n_in, uint8_t **out_p, long *out_len) {
    dmc_arena_t a;
    /* node/child indices are int32_t; past ~1 GiB the arena index would
     * silently truncate, so refuse rather than corrupt */
    if (n_in < 0 || 2 * n_in + 2 > INT32_MAX) return RSN_ERR_ALLOC;
    a.cap = 2 * n_in + 2;
    a.n = 0;
    a.nodes = (dmc_node_t *)malloc(sizeof(dmc_node_t) * (size_t)a.cap);
    int32_t *stack = (int32_t *)malloc(sizeof(int32_t) * (size_t)(n_in + 2));
    buf_t out;
    if (!a.nodes || !stack || buf_init(&out, (size_t)n_in + 16)) {
        free(a.nodes); free(stack);
        return RSN_ERR_ALLOC;
    }
#define DMC_FAIL(code) { dmc_arena_free(&a); free(stack); free(out.p); return (code); }
    long root = dmc_build(&a, in, n_in, stack);
    if (root < 0) DMC_FAIL(root);
    if (dmc_sort_all(&a, root)) DMC_FAIL(RSN_ERR_ALLOC);

    /* re-walk: the Python new_stack = stack + [node] copy becomes pushes and
     * truncations on one array (older prefixes are never revisited) */
    long node = root;
    long sp = 0; /* stack holds the path EXCLUDING the current node */
    long emitted = 0;
    long trailing_implicit = 0;
    for (long pos = 0; pos < n_in; pos++) {
        int val = in[pos];
        stack[sp++] = (int32_t)node; /* new_stack = stack + [node] */
        long look_in = -1;
        long transition = -2; /* sentinel: none */
        dmc_node_t *nd = &a.nodes[node];
        int idx = dmc_child_by_value(&a, node, val);
        if (idx == -1) {
            for (int i = 0; i < nd->nchild; i++) {
                dmc_node_t *ch = &a.nodes[nd->children[i]];
                /* MoveUp deeper than the walk stack would read out of
                 * bounds; the Go reference panics there (dmc.go:119) */
                if (ch->move_up > sp) DMC_FAIL(RSN_ERR_DMC);
                if (ch->move_up > 0 && a.nodes[stack[sp - ch->move_up]].value == val) {
                    look_in = stack[sp - ch->move_up];
                    sp = sp - ch->move_up + 1; /* truncate */
                    transition = (nd->nchild == 1) ? -1 : i;
                    break;
                }
            }
            sp -= 1; /* new_stack.pop() */
            if (look_in < 0) DMC_FAIL(RSN_ERR_DMC);
        } else {
            look_in = nd->children[idx];
            transition = (nd->nchild == 1) ? -1 : idx;
        }
        if (transition == -1) {
            trailing_implicit++;
        } else {
            if (buf_push(&out, (uint8_t)(transition & 0xff))) DMC_FAIL(RSN_ERR_ALLOC);
            emitted++;
            trailing_implicit = 0;
        }
        node = look_in;
    }
    {
        long marker = emitted ? -1 : -2;
        if (buf_push(&out, (uint8_t)(marker & 0xff)) ||
            buf_push(&out, (uint8_t)(trailing_implicit & 0xff)))
            DMC_FAIL(RSN_ERR_ALLOC);
    }
#undef DMC_FAIL
    dmc_arena_free(&a);
    free(stack);
    *out_p = out.p;
    *out_len = (long)out.len;
    return 0;
}

/* Reference-parity stub (dmc.go:274-276). */
long rsn_dmc_decompress(const uint8_t *in, long n, uint8_t **out_p, long *out_len) {
    (void)in; (void)n;
    const char *hello = "Hello!";
    uint8_t *p = (uint8_t *)malloc(6);
    if (!p) return RSN_ERR_ALLOC;
    memcpy(p, hello, 6);
    *out_p = p;
    *out_len = 6;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Huffman trees of byte-count tables (the port's own)                */
/*
 * Go's buildTree (compressor/huffman/huffman.go:58) on Go's container/heap,
 * one tree a block, for the RSNB container's Huffman blocks on the card
 * (raisin_tpu_torch/ops/huffman_blocks.py); the same trees as
 * raisin_tpu_torch/formats/huffman.py's build_tree. The leaves in ascending
 * (count, symbol) order, heap.Init over them, then, while more than one tree
 * is left, two Pops and a Push of their join, the first popped on the left.
 * Less compares counts only; up's parent is (j - 1) / 2, which C, as Go,
 * truncates toward zero, so the climb stops at the root.
 *
 * A block's 256 byte counts (a block of zeros gets no tree: -1) and the id
 * kernel H takes for each symbol (its leaf is 128 + id) give each symbol's
 * code (its len low bits, the first bit the most significant; 0 past 32
 * bits) and length, 0 for an absent symbol and for the lone symbol of a
 * one-leaf tree; kernel H's child table, 64 words (internal nodes numbered
 * in preorder from 0, word j holding nodes 2j and 2j + 1 in its low and
 * high half, each left | right << 8), all zero where an id is 128 or more
 * or the tree has one leaf; and the deepest code.
 */

typedef struct {
    int64_t freq;
    int node;
} hf_item;

static int hf_leaf_cmp(const void *pa, const void *pb) {
    const hf_item *a = (const hf_item *)pa, *b = (const hf_item *)pb;
    if (a->freq != b->freq) return a->freq < b->freq ? -1 : 1;
    return a->node - b->node; /* node is the symbol for a leaf */
}

static void hf_down(hf_item *h, int i, int n) {
    for (;;) {
        int j1 = 2 * i + 1;
        if (j1 >= n) break;
        int j = j1;
        if (j1 + 1 < n && h[j1 + 1].freq < h[j1].freq) j = j1 + 1;
        if (!(h[j].freq < h[i].freq)) break;
        hf_item t = h[i];
        h[i] = h[j];
        h[j] = t;
        i = j;
    }
}

static void hf_up(hf_item *h, int j) {
    for (;;) {
        int i = (j - 1) / 2;
        if (i == j || !(h[j].freq < h[i].freq)) break;
        hf_item t = h[i];
        h[i] = h[j];
        h[j] = t;
        j = i;
    }
}

/* One block's tree: code and len by symbol (256 each), words kernel H's table (64) where not NULL.
 * Returns the deepest code, -1 for a block of zeros. */
static int hf_tree(const int64_t *c, const uint8_t *id, uint32_t *code, int32_t *len, uint32_t *words) {
    /* nodes 0..255 are the leaves (their symbols), 256.. the joins */
    int left[512], right[512];
    hf_item h[256];
    int n = 0;
    memset(code, 0, 256 * sizeof(uint32_t));
    memset(len, 0, 256 * sizeof(int32_t));
    if (words) memset(words, 0, 64 * sizeof(uint32_t));
    for (int s = 0; s < 256; ++s)
        if (c[s] > 0) {
            h[n].freq = c[s];
            h[n].node = s;
            ++n;
        }
    if (n == 0) return -1;
    qsort(h, n, sizeof(hf_item), hf_leaf_cmp);
    for (int i = n / 2 - 1; i >= 0; --i) hf_down(h, i, n); /* heap.Init */
    int size = n, joins = 256;
    while (size > 1) {
        hf_item a, bb;
        hf_item t = h[0]; /* Pop: swap the root with the last, sift the root down */
        h[0] = h[size - 1];
        h[size - 1] = t;
        hf_down(h, 0, size - 1);
        a = h[--size];
        t = h[0];
        h[0] = h[size - 1];
        h[size - 1] = t;
        hf_down(h, 0, size - 1);
        bb = h[--size];
        left[joins] = a.node;
        right[joins] = bb.node;
        h[size].freq = a.freq + bb.freq; /* Push: append, sift up */
        h[size].node = joins++;
        hf_up(h, size++);
    }
    /* codes: a walk from the root, 0 to the left and 1 to the right */
    int stack[512], depth[512];
    uint64_t bits[512];
    int top = 0, deepest = 0;
    stack[top] = h[0].node;
    depth[top] = 0;
    bits[top++] = 0;
    while (top > 0) {
        --top;
        int node = stack[top], d = depth[top];
        uint64_t v = bits[top];
        if (node < 256) {
            len[node] = d;
            code[node] = d <= 32 ? (uint32_t)v : 0u;
            if (d > deepest) deepest = d;
            continue;
        }
        stack[top] = right[node];
        depth[top] = d + 1;
        bits[top++] = (v << 1) | 1u;
        stack[top] = left[node];
        depth[top] = d + 1;
        bits[top++] = v << 1;
    }
    if (n == 1 || !words) return deepest;
    /* kernel H's table: a preorder walk, left first, numbering the joins */
    int parent[512], side[512], counter = 0, fits = 1;
    top = 0;
    stack[top] = h[0].node;
    parent[top] = -1;
    side[top++] = 0;
    while (top > 0 && fits) {
        --top;
        int node = stack[top], p = parent[top], sd = side[top], ref;
        if (node < 256) {
            if (id[node] >= 128) fits = 0;
            ref = 128 + id[node];
        } else {
            if (counter >= 127) fits = 0;
            ref = counter++;
            stack[top] = right[node];
            parent[top] = ref;
            side[top++] = 1;
            stack[top] = left[node];
            parent[top] = ref;
            side[top++] = 0;
        }
        if (fits && p >= 0) words[p / 2] |= (uint32_t)ref << (16 * (p % 2) + 8 * sd);
    }
    if (!fits) memset(words, 0, 64 * sizeof(uint32_t));
    return deepest;
}

/* ------------------------------------------------------------------ */
/* Huffman block headers of a batch (the port's own)                   */
/*
 * The text codec of the container's Huffman block headers
 * (raisin_tpu_torch/formats/huffman.py build_header and read_header), for
 * the blocks the card codes, with each block's tree, in one call a batch.
 *
 * A header is its symbols' entries in ascending order, each the count in
 * decimal, '|' and the symbol's byte (10 as the two bytes "\n"), then the
 * separator "\\\n". A card block's symbols are ASCII, or, in a block coded
 * over its bytes ("raw"), any byte; each byte >= 0x80 of a raw block takes
 * an ASCII id that is no symbol, from 127 down and never 0 (ops/huffman_blocks
 * ascii_ids), for the kernels.
 */

/* ascii_ids: id[s] = s % 128, each symbol >= 128 an ASCII value that is no symbol; 0 where too few are free */
static int hf_ascii_ids(const uint8_t *present, uint8_t *id) {
    int free_at = 127;
    for (int s = 0; s < 256; ++s) id[s] = (uint8_t)(s & 127);
    for (int s = 128; s < 256; ++s) {
        if (!present[s]) continue;
        while (free_at > 0 && present[free_at]) --free_at;
        if (free_at == 0) return 0;
        id[s] = (uint8_t)free_at--;
    }
    return 1;
}

static int hf_digits(int64_t v) {
    int d = 1;
    while (v >= 10) {
        v /= 10;
        ++d;
    }
    return d;
}

/*
 * Encode: for B blocks of counts (B x 256) and raw flags (B), which blocks the
 * card takes, their tables and their headers' lengths. A block takes the
 * host oracle (on_host) where it is not raw and has a byte >= 0x80, or is raw
 * and has no ASCII ids. Out, a block each: ids (256, identity for a block not
 * raw or on the host), codes and lens by id (128 each, zero on the host),
 * nbits the block's exact bit count, head_lens its header's bytes with the
 * separator (0 on the host). Returns the deepest code of the card's blocks,
 * -1 for none.
 */
long rsn_huffman_encode_tables(const int64_t *counts, const uint8_t *raw, long B, uint8_t *on_host, uint8_t *ids,
                               uint32_t *codes, int32_t *lens, int64_t *nbits, int64_t *head_lens) {
    long deepest = -1;
    for (long b = 0; b < B; ++b) {
        const int64_t *c = counts + 256 * b;
        uint8_t *id = ids + 256 * b, present[256];
        uint32_t code256[256];
        int32_t len256[256];
        int high = 0, host;
        for (int s = 0; s < 256; ++s) {
            present[s] = c[s] > 0;
            id[s] = (uint8_t)s;
            if (s >= 128 && present[s]) high = 1;
        }
        host = raw[b] ? !hf_ascii_ids(present, id) : high;
        if (host) for (int s = 0; s < 256; ++s) id[s] = (uint8_t)s;
        on_host[b] = (uint8_t)host;
        memset(codes + 128 * b, 0, 128 * sizeof(uint32_t));
        memset(lens + 128 * b, 0, 128 * sizeof(int32_t));
        nbits[b] = 0;
        head_lens[b] = 0;
        if (host) continue;
        int d = hf_tree(c, id, code256, len256, NULL);
        if (d > deepest) deepest = d;
        int64_t bits = 0, head = 2;
        for (int s = 0; s < 256; ++s) {
            if (!present[s]) continue;
            codes[128 * b + id[s]] = code256[s];
            lens[128 * b + id[s]] = len256[s];
            bits += c[s] * len256[s];
            head += hf_digits(c[s]) + (s == 10 ? 3 : 2);
        }
        nbits[b] = bits;
        head_lens[b] = head;
    }
    return deepest;
}

/*
 * Each card block's header and separator (on_host 0), right-aligned in its
 * row of heads (B x width); the rows of the host's blocks are left as they
 * are. Returns 0, or -1 where a header does not fit its row.
 */
long rsn_huffman_headers(const int64_t *counts, const uint8_t *on_host, long B, long width, uint8_t *heads) {
    for (long b = 0; b < B; ++b) {
        if (on_host[b]) continue;
        const int64_t *c = counts + 256 * b;
        uint8_t *row = heads + width * b;
        long at = width - 2;
        if (at < 0) return -1;
        row[at] = '\\';
        row[at + 1] = '\n';
        for (int s = 255; s >= 0; --s) {
            if (c[s] <= 0) continue;
            if (at < hf_digits(c[s]) + (s == 10 ? 3 : 2)) return -1;
            if (s == 10) {
                row[--at] = 'n';
                row[--at] = '\\';
            } else {
                row[--at] = (uint8_t)s;
            }
            row[--at] = '|';
            for (int64_t v = c[s]; ; v /= 10) {
                row[--at] = (uint8_t)('0' + v % 10);
                if (v < 10) break;
            }
        }
    }
    return 0;
}

/* Whether p (avail bytes, p[0] >= 0x80) begins a valid UTF-8 sequence, by Go's rules (formats/huffman go_decode_runes) */
static int hf_valid_rune(const uint8_t *p, long avail) {
    uint8_t b0 = p[0], lo = 0x80, hi = 0xBF;
    int size;
    if (b0 < 0xC2 || b0 > 0xF4) return 0;
    if (b0 < 0xE0) {
        size = 2;
    } else if (b0 < 0xF0) {
        size = 3;
        if (b0 == 0xE0) lo = 0xA0;
        if (b0 == 0xED) hi = 0x9F;
    } else {
        size = 4;
        if (b0 == 0xF0) lo = 0x90;
        if (b0 == 0xF4) hi = 0x8F;
    }
    if (avail < 2 || p[1] < lo || p[1] > hi) return 0;
    for (int k = 2; k < size; ++k)
        if (k >= avail || p[k] < 0x80 || p[k] > 0xBF) return 0;
    return 1;
}

/*
 * Decode: the header of each of B blocks, block b at data[starts[b],
 * starts[b] + sizes[b]) of the n bytes of data, read as read_header reads it
 * (formats/huffman._scan_header): digits build up a count across any other
 * byte; at '|' the count is taken (0 for no digits) and the symbol follows,
 * the two bytes "\n" as 10 where a byte follows them, else one byte; a later
 * entry of a symbol overwrites the earlier. Where a symbol's byte is >= 0x80
 * and begins no valid UTF-8 sequence (inside the header's end) the block is
 * coded over its bytes (raw). The card takes a block (taken) whose separator
 * and pad byte are inside it and whose header holds two symbols or more, each
 * counted once or more, each ASCII, or a byte with an ASCII id in a raw block.
 * Every other block (no separator or pad byte, '|' last, a count above
 * HF_MAX_COUNT, a rune >= 128, one symbol, a zero count, too many bytes
 * >= 0x80) is left to the caller: its row of each output is zero (ids the
 * identity). No block of the container's writer counts more than its size,
 * and 256 counts of at most HF_MAX_COUNT sum inside int64 in hf_tree.
 * Out, a block each: freqs (256), ids (256), raw, back (128: each id's byte
 * in a raw block), the pad byte, pstart (the payload's first byte - base),
 * blens (the payload's bytes after the pad byte), kernel H's table (64).
 * Returns the number of blocks taken.
 */
#define HF_MAX_COUNT ((int64_t)1 << 40)

long rsn_huffman_read_headers(const uint8_t *data, long n_data, const int64_t *starts, const int64_t *sizes,
                              long B, int64_t base, uint8_t *taken, int64_t *freqs, uint8_t *ids, uint8_t *raw,
                              uint8_t *back, int32_t *pads, int64_t *pstart, int64_t *blens, int32_t *tables) {
    long count = 0;
    for (long b = 0; b < B; ++b) {
        int64_t *f = freqs + 256 * b;
        uint8_t *id = ids + 256 * b, *bk = back + 128 * b, present[256];
        uint32_t code256[256], *words = (uint32_t *)(tables + 64 * b);
        int32_t len256[256];
        memset(f, 0, 256 * sizeof(int64_t));
        memset(present, 0, sizeof present);
        memset(bk, 0, 128);
        memset(words, 0, 64 * sizeof(uint32_t));
        for (int s = 0; s < 256; ++s) id[s] = (uint8_t)s;
        taken[b] = 0;
        raw[b] = 0;
        pads[b] = 0;
        pstart[b] = 0;
        blens[b] = 0;
        int64_t lo = starts[b], hi = starts[b] + sizes[b], cut = -1;
        if (lo < 0 || sizes[b] < 0 || hi > n_data) continue;
        for (int64_t k = lo; k + 1 < hi; ++k)
            if (data[k] == '\\' && data[k + 1] == '\n') {
                cut = k;
                break;
            }
        if (cut < 0 || cut + 2 >= hi) continue;
        const uint8_t *h = data + lo;
        long n = (long)(cut - lo), i = 0;
        int digits = 0, high = 0, stray = 0, ok = 1;
        int64_t value = 0;
        while (i < n && ok) {
            uint8_t v = h[i];
            if (v != '|') {
                if (v >= '0' && v <= '9') {
                    value = 10 * value + (v - '0');
                    ++digits;
                    if (value > HF_MAX_COUNT) ok = 0;
                }
                ++i;
                continue;
            }
            int64_t freq = digits ? value : 0;
            int sym;
            value = 0;
            digits = 0;
            if (i + 2 < n && h[i + 1] == '\\' && h[i + 2] == 'n') {
                sym = 10;
                i += 3;
            } else {
                if (i + 1 >= n) {
                    ok = 0;
                    break;
                }
                sym = h[i + 1];
                if (sym >= 0x80) {
                    high = 1;
                    long avail = n - (i + 1) < 4 ? n - (i + 1) : 4;
                    if (!hf_valid_rune(h + i + 1, avail)) stray = 1;
                }
                i += 2;
            }
            f[sym] = freq;
            present[sym] = 1;
        }
        int nsym = 0;
        for (int s = 0; s < 256 && ok; ++s)
            if (present[s]) {
                ++nsym;
                if (f[s] < 1) ok = 0;
            }
        if (ok && (nsym < 2 || (high && !stray) || (stray && !hf_ascii_ids(present, id)))) ok = 0;
        if (!ok) {
            memset(f, 0, 256 * sizeof(int64_t));
            for (int s = 0; s < 256; ++s) id[s] = (uint8_t)s;
            continue;
        }
        if (stray)
            for (int s = 0; s < 256; ++s)
                if (present[s]) bk[id[s]] = (uint8_t)s;
        hf_tree(f, id, code256, len256, words);
        taken[b] = 1;
        raw[b] = (uint8_t)stray;
        pads[b] = data[cut + 2];
        pstart[b] = cut + 3 - base;
        blens[b] = hi - (cut + 3);
        ++count;
    }
    return count;
}
