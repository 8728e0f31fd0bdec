"""Kernel E (csrc/lzss_commit.cu) modelled on the CPU, against the plain
version, the host oracle and the JAX package.

Kernel E runs only on the card. It splits each block's positions into
segments of SEG positions, one thread each, SPAN_SEGS a CTA (a span), and
launches three kernels: the speculation (each segment walks greedily from
its first position to its exit, the first position at or past its end,
adding up its bytes, unless the first commit of its warp's first segment
jumps over it; then each warp, and then the span's warps, repair
their entries from the exits before them, in rounds, until none changes:
a segment takes the exit of the nearest segment before it that holds
commits),
the chain (over a block's spans in order: a span whose first entry was
wrong repeats the repair from the true exit, then a scan of the byte
counts gives the offsets and tok_len) and the write (each thread walks its
true commits again into the span's output in shared memory, stored sixteen
bytes a store). ``_commit_model`` mirrors those passes in numpy, vectorised
over the segments, with the constants read from the kernel's source, and
counts the repair rounds and the steps of the repair walks. It is held,
exactly (tolerance 0: bytes and lengths), against the plain version
``lzss_commit._commit_tokens_torch`` (the wrapper's route for CPU
tensors), against the oracle ``lzss_ref.commit_tokens`` and, at windows up
to 8191, against the Pallas kernel
``raisin_tpu.ops.lzss_commit_pallas.commit_emit_blocks`` in interpret mode.
The kernel's own source runs here too, built with g++ over
``tests/cuda_host/cuda_emu.h`` (a CTA's threads as threads, warps
exchanging through barriers), against the same references. Inputs are
blocks of seeded random bytes and of ``bench.make_corpus`` through the
port's escape layer and plain match search, and synthetic (L, D) fields:
L = 2 everywhere, from an even and from an odd start (walks that never
meet), matches longer than a span, and the edges of the block length.
"""

from __future__ import annotations

import functools
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from raisin_tpu.formats import lzss_ref
from raisin_tpu.ops import lzss_commit_pallas as cp
from raisin_tpu_torch.ops import escape, lzss_commit, lzss_match

torch.set_num_threads(1)

CSRC = Path(lzss_commit.__file__).resolve().parent.parent / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"


@functools.cache
def _constants() -> dict[str, int]:
    """Kernel E's integer constants, read from its source (the model mirrors them)."""
    src = (CSRC / "lzss_commit.cu").read_text()
    out: dict[str, int] = {}
    for k, v in re.findall(r"constexpr int (\w+) = ([\w */+-]+);", src):  # integer arithmetic on earlier ones
        out[k] = eval(v.replace(" / ", " // "), {}, dict(out))
    return out


K = _constants()
SEG, SPAN_SEGS, SPAN = K["SEG"], K["SPAN_SEGS"], K["SPAN"]


# ---------------------------------------------------------------------------
# The model


def _ndigits(v: np.ndarray) -> np.ndarray:
    return 1 + sum((v >= 10**k).astype(np.int64) for k in range(1, 5))


class _Block:
    """One block's fields: x (bytes), L, D (int64) and its length n, clamped to 0..S."""

    def __init__(self, x, L, D, n: int):
        self.x, self.L, self.D = (np.asarray(a).astype(np.int64) for a in (x, L, D))
        self.n = min(max(int(n), 0), self.x.size)

    def commit(self, p: np.ndarray):
        """The commits at positions p < n: (the positions each consumes, the bytes each writes)."""
        lq = np.minimum(self.L[p], self.n - p)
        tl = 3 + _ndigits(self.D[p]) + _ndigits(lq)
        short = lq < K["MIN_TOKEN_L"]
        step = np.where(short, np.maximum(lq, 1), lq)
        out = np.where(short, step, np.where(tl < lq, tl, lq))
        return step, out


def _walk(blk: _Block, p: np.ndarray, end: np.ndarray):
    """Each walk from p to its first position at or past end: (exit, bytes, steps)."""
    p, c = p.copy(), np.zeros(p.size, np.int64)
    steps = 0
    act = np.nonzero(p < end)[0]
    while act.size:
        s, o = blk.commit(p[act])
        p[act] += s
        c[act] += o
        steps += act.size
        act = act[p[act] < end[act]]
    return p, c, steps


def _rewalk(blk: _Block, e_new, end, e, x, c, stats):
    """The walks from e_new, in lockstep with the old walks (e, x, c) until the two land on one
    position or the new walk passes its end: the new (e, x, c)."""
    p, q = e_new.copy(), e.copy()
    cn, co = np.zeros_like(c), np.zeros_like(c)
    met = np.zeros(p.size, bool)
    live = np.nonzero(p < end)[0]
    while live.size:
        hit = p[live] == q[live]
        met[live[hit]] = True
        live = live[~hit]
        old = live[q[live] < p[live]]
        new = live[q[live] >= p[live]]
        if old.size:
            s, o = blk.commit(q[old])
            q[old] += s
            co[old] += o
        if new.size:
            s, o = blk.commit(p[new])
            p[new] += s
            cn[new] += o
        stats["repair_steps"] += old.size + new.size
        live = live[p[live] < end[live]]
    return e_new.copy(), np.where(met, x, p), np.where(met, c - co + cn, cn)


def _repair_span(blk: _Block, first: int, lo, end, e, x, c, stats) -> None:
    """A span's repair, in place: in each warp, in rounds until no entry changes, each entry from
    the exit of the nearest lane before it that holds commits (entry < end; lane 0's, and that of
    a lane without one before it, from its warp's first entry once that has reached the lane's
    first position lo); then each warp's first entry from the warps before it in order, from
    ``first`` (a value at or past a warp's end passes over it, any other takes its exit), until
    none changes."""
    warps = SPAN_SEGS // 32
    lane = np.arange(32)
    e0 = np.concatenate([[first], e.reshape(warps, 32)[1:, 0]])
    while True:
        while True:  # the warps' rounds
            walks = (e < end).reshape(warps, 32)
            # the nearest walking lane before each lane, -1 for none
            last = np.where(walks, lane, -1)
            near = np.concatenate([np.full((warps, 1), -1), np.maximum.accumulate(last, axis=1)[:, :-1]], axis=1)
            xw = x.reshape(warps, 32)
            e0l = np.where(e0[:, None] >= lo.reshape(warps, 32), e0[:, None], e.reshape(warps, 32))
            prev = np.where(near >= 0, np.take_along_axis(xw, near.clip(0), axis=1), e0l).ravel()
            ch = np.nonzero(prev != e)[0]
            if not ch.size:
                break
            e[ch], x[ch], c[ch] = _rewalk(blk, prev[ch], end[ch], e[ch], x[ch], c[ch], stats)
            stats["warp_rounds"] += 1
        # each warp's first entry from the warps before it in order: a value at or past a warp's
        # end passes over it, any other takes the warp's exit
        e0_new, v = np.empty_like(e0), first
        for k in range(warps):
            e0_new[k] = v
            v = v if v >= min(lo[32 * k] - (32 * k) * SEG + (k + 1) * 32 * SEG, blk.n) else x[32 * k + 31]
        if np.array_equal(e0_new, e0):
            return
        e0 = e0_new
        stats["span_rounds"] += 1


def _token_bytes(d: np.ndarray, lq: np.ndarray) -> np.ndarray:
    """(k, 13) bytes of the tokens "<d,lq>", zero past each token's length (d's floor modulo 10
    for d < 0, as in the plain version; the last five digits of longer values)."""
    rows = np.zeros((d.size, K["MAX_OUT"]), np.int64)
    nd_d, nd_l = _ndigits(d), _ndigits(lq)
    col = np.arange(K["MAX_OUT"])[None, :]
    rows[:, 0] = ord("<")
    for v, nd, at in ((d, nd_d, 1), (lq, nd_l, 2 + nd_d)):
        for k in range(5):
            digit = (v[:, None] // 10 ** (nd[:, None] - 1 - k).clip(0)) % 10 + ord("0")
            rows = np.where((col == (np.asarray(at)[..., None] + k)) & (k < nd[:, None]), digit, rows)
    rows[np.arange(d.size), 1 + nd_d] = ord(",")
    rows[np.arange(d.size), 3 + nd_d + nd_l - 1] = ord(">")
    return rows


def _emit(blk: _Block, commits: np.ndarray) -> bytes:
    """The bytes of the commits at positions ``commits``, in order."""
    if not commits.size:
        return b""
    step, out = blk.commit(commits)
    lq = np.minimum(blk.L[commits], blk.n - commits)
    tok = (lq >= K["MIN_TOKEN_L"]) & (out < lq)
    col = np.arange(K["MAX_OUT"])[None, :]
    raw = blk.x[np.minimum(commits[:, None] + col, blk.x.size - 1)]
    rows = np.where(tok[:, None], _token_bytes(blk.D[commits], lq), raw)
    return rows[col < out[:, None]].astype(np.uint8).tobytes()


def _commit_block(blk: _Block, stats: dict):
    """Kernel E's three passes on one block: (its token bytes, their count)."""
    spans = -(-blk.n // SPAN)
    t = np.arange(SPAN_SEGS)
    state = []
    # pass 1, every span at once in the kernel: the speculation and the span's repair
    for cs in range(spans):
        lo = cs * SPAN + t * SEG
        end = np.minimum(lo + SEG, blk.n)
        real = lo < blk.n
        e = np.where(real, lo, blk.n)
        x, c, steps = _walk(blk, e, np.where(real, end, 0))
        x, c = np.where(real, x, blk.n), np.where(real, c, 0)
        # a segment that the first commit of its warp's first segment jumps over takes its exit
        lead = lo.reshape(-1, 32)[:, 0]
        jump = np.repeat(np.where(lead < blk.n, lead + blk.commit(np.minimum(lead, blk.n - 1))[0], lead), 32)
        passed = (t % 32 > 0) & real & (jump >= end)
        e, x, c = np.where(passed, jump, e), np.where(passed, jump, x), np.where(passed, 0, c)
        stats["spec_steps"] += steps - int(((lo < end) & passed).sum())  # not the passed segments' steps
        _repair_span(blk, cs * SPAN, lo, end, e, x, c, stats)
        state.append((lo, end, e, x, c))
    # pass 2: the spans in order from the true exits; the offsets and the count
    true_exit, base, offsets = 0, 0, []
    for cs, (lo, end, e, x, c) in enumerate(state):
        if true_exit != cs * SPAN:
            stats["chain_repairs"] += 1
            _repair_span(blk, true_exit, lo, end, e, x, c, stats)
        offsets.append(base + np.cumsum(c) - c)
        base += int(c.sum())
        true_exit = int(x[-1])
    assert true_exit == blk.n or spans == 0
    # pass 3: each segment's true commits again, each span's output within its stage
    out = []
    for (_, end, e, _, c), off in zip(state, offsets):
        commits = []
        p = e.copy()
        act = np.nonzero(p < end)[0]
        while act.size:
            commits.append(np.stack([act, p[act]]))
            p[act] += blk.commit(p[act])[0]
            act = act[p[act] < end[act]]
        if commits:
            seg, pos = np.concatenate(commits, axis=1)
            pos = pos[np.lexsort((pos, seg))]
        else:
            pos = np.zeros(0, np.int64)
        span_bytes = _emit(blk, pos)

        assert len(span_bytes) == int(c.sum()) and len(span_bytes) + 15 <= K["STAGE_BYTES"]
        out.append(span_bytes)
    return b"".join(out), base


def _commit_model(x, L, D, lengths):
    """(tok (B, S) uint8, tok_len (B,) int32, stats): the repair rounds and steps of every block."""
    stats = {"spec_steps": 0, "repair_steps": 0, "warp_rounds": 0, "span_rounds": 0, "chain_repairs": 0}
    B, S = x.shape
    tok = np.zeros((B, S), np.uint8)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        got, tl[b] = _commit_block(_Block(x[b], L[b], D[b], lengths[b]), stats)
        tok[b, : len(got)] = np.frombuffer(got, np.uint8)
    return tok, tl, stats


# ---------------------------------------------------------------------------
# Inputs


def _plain(x, L, D, lengths):
    out = lzss_commit._commit_tokens_torch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, L, D, lengths)))
    return tuple(o.numpy() for o in out)


def _matched(blocks: list[bytes], window: int, width: int | None = None):
    """Blocks through the port's escape layer and plain match search on the CPU -> (x (B, S)
    uint8, L, D (B, S) int32, lengths (B,) int32); S is ``width`` when given."""
    m = np.zeros((len(blocks), max(map(len, blocks))), np.uint8)
    for i, b in enumerate(blocks):
        m[i, : len(b)] = np.frombuffer(b, np.uint8)
    xe, en = escape.escape_blocks(torch.from_numpy(m), torch.tensor([len(b) for b in blocks], dtype=torch.int32))
    if width is not None:
        xe = torch.nn.functional.pad(xe, (0, width - xe.shape[1]))
    L, D = lzss_match._find_matches_torch(xe, en, window)
    return xe.numpy(), L.numpy(), D.numpy(), en.numpy()


def _zeros_field(lengths, window: int, S: int):
    """The match search's fields on blocks of zero bytes, in closed form: at position i the
    longest match is min(i, window, n - i) long, at the largest distance min(i, window)."""
    i = np.arange(S)[None, :]
    n = np.asarray(lengths, np.int64)[:, None]
    D = np.where(i < n, np.minimum(i, window), 0)
    L = np.where(i < n, np.minimum(D, n - i), 0)
    D = np.where(L > 0, D, 0)
    return np.zeros((len(lengths), S), np.uint8), L.astype(np.int32), D.astype(np.int32), np.asarray(lengths, np.int32)


def _corpus(n: int, offset: int = 0) -> bytes:
    return bench.make_corpus(n + offset)[offset:]


def _field(S: int, lengths, seed: int, L_fill=None):
    """A synthetic (x, L, D, lengths): random bytes, L from ``L_fill`` (an (S,) array) or
    random, random D in 1..65535."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    x = rng.integers(0, 256, (B, S), dtype=np.uint8)
    L = np.tile(L_fill, (B, 1)).astype(np.int32) if L_fill is not None else rng.integers(0, 40, (B, S), dtype=np.int32)
    D = rng.integers(1, 65536, (B, S), dtype=np.int32)
    return x, L, D, np.asarray(lengths, np.int32)


@functools.cache
def _case(name: str):
    """A named input: (x, L, D, lengths, window of its match search or None for a synthetic field)."""
    if name == "corpus":  # B = 2 over three spans each, S not a multiple of SEG
        return (*_matched([_corpus(40_001), _corpus(37_000, offset=3)], 4096), 4096)
    if name == "stream":  # B = 1 over seven spans, as the lzss streams commit
        return (*_matched([_corpus(110_000, offset=7)], 512), 512)
    if name == "escaped":  # escaping grows the block past a span; a second block of text
        rng = np.random.default_rng(3)
        heavy = bytes(rng.choice(np.frombuffer(b"\\\xff<ab", np.uint8), 30_000))
        return (*_matched([heavy, _corpus(9_000)], 1024), 1024)
    if name == "random":  # a literal or a short copy at nearly every position
        rng = np.random.default_rng(9)
        return (*_matched([rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()], 1024), 1024)
    if name == "zeros":  # every match past the window its length: most segments hold no commit
        return (*_zeros_field([50_000, 33_333], 4096, 50_000), 4096)
    if name == "five digits":  # zeros at window 65535: matches of 32768 and 65535 jump over spans
        return (*_zeros_field([100_000, 70_000], 65535, 100_000), 65535)
    if name == "L=2 even":  # every guess lands on the true parse
        return (*_field(40_000, [40_000, 39_999], 4, np.full(40_000, 2)), None)
    if name == "L=2 odd":  # a literal, then L = 2: walks from even positions never meet the parse
        fill = np.full(40_000, 2)
        fill[0] = 1
        return (*_field(40_000, [40_000, 33_001], 5, fill), None)
    if name == "long":  # random short matches, and matches of 5-digit lengths across spans
        x, L, D, n = _field(50_000, [50_000, 49_000, 20_000], 6)
        L[0, ::997] = 17_000
        L[1, 5] = 45_000  # clamped by n - i at the first commit that lands on it
        L[1, 12_000:12_100] = 99_999  # clamped by n - i
        L[2, 3] = 123_456  # clamped: "<D,19997>"
        return x, L, D, n, None
    if name == "edges":
        # lengths 0-3, 0 with S > 0, a negative length, garbage L and D past each length, L = 1
        # and L <= 0 (literals), raw copies (L 2-13), negative D on a token
        x, L, D, n = _field(5_000, [0, 1, 2, 3, 4_321, 5_000, 4_999, -7, 2_999, 4_000], 7)
        rng = np.random.default_rng(8)
        L[4, :3000] = rng.integers(-3, 14, 3000)  # literals and copies: no token is shorter
        D[8, ::3] = -rng.integers(1, 99, D[8, ::3].size)
        L[8] = 20
        L[9] = 1
        return x, L, D, n, None
    raise KeyError(name)


CASES = ["corpus", "stream", "escaped", "random", "zeros", "five digits", "L=2 even", "L=2 odd", "long", "edges"]


def _oracle(x, L, D, lengths) -> list[bytes]:
    """lzss_ref.commit_tokens on each block of a field from the match search."""
    return [lzss_ref.commit_tokens(x[b, : lengths[b]].tobytes(), list(zip(D[b, : lengths[b]].tolist(),
                                                                          L[b, : lengths[b]].tolist())))
            for b in range(len(lengths))]


def test_zeros_field_is_the_match_search():
    for window in (7, 1000):
        want = _matched([bytes(3000), bytes(1234)], window)
        got = _zeros_field([3000, 1234], window, 3000)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_model_reads_kernel_constants():
    assert (SEG, SPAN_SEGS) == (lzss_commit.SEG, lzss_commit.SPAN_SEGS)
    assert SPAN == SEG * SPAN_SEGS and SPAN_SEGS % 32 == 0 and K["WARPS"] == SPAN_SEGS // 32
    # a span's output is under SPAN + MAX_OUT bytes, staged from a 16-byte boundary
    assert K["STAGE_BYTES"] % 16 == 0 and K["STAGE_BYTES"] >= SPAN + K["MAX_OUT"] - 1 + 15
    assert K["MAX_OUT"] == len(lzss_ref.token_bytes(99_999, 99_999))
    assert K["MIN_TOKEN_L"] == 1 + len(lzss_ref.token_bytes(1, 1))  # a match that no token is shorter than
    assert lzss_commit.workspace_bytes(3, 40_000) == 16 * 3 * -(-40_000 // SPAN) * SPAN_SEGS
    assert lzss_commit.workspace_bytes(2, 0) == 16 * 2 * SPAN_SEGS


@pytest.mark.parametrize("name", CASES)
def test_model_matches_plain(name):
    x, L, D, lengths, window = _case(name)
    tok, tl, stats = _commit_model(x, L, D, lengths)
    want_tok, want_tl = _plain(x, L, D, lengths)
    assert np.array_equal(tl, want_tl) and np.array_equal(tok, want_tok)
    if window is not None:
        for b, oracle in enumerate(_oracle(x, L, D, lengths)):
            assert tok[b, : tl[b]].tobytes() == oracle
    n = np.clip(lengths, 0, x.shape[1])
    segments, spans = int((-(-n // SEG)).sum()), int((-(-n // SPAN)).sum())
    if name == "escaped":
        assert n[0] > SPAN
    if name in ("corpus", "stream"):
        # the walks meet the true parse within a few commits: few repair steps and rounds
        assert (n > SPAN).all() and stats["chain_repairs"] >= 1
        assert stats["repair_steps"] < stats["spec_steps"] // 2 and stats["warp_rounds"] <= 4 * spans
    if name == "L=2 even":
        assert stats["repair_steps"] == 0 and stats["chain_repairs"] == 0
    if name == "L=2 odd":  # a round a segment: the block is walked in order once more
        assert stats["warp_rounds"] >= int((n // SEG).sum()) - 2 and stats["chain_repairs"] == spans - len(n)
    if name == "zeros":  # a commit every 4096 positions: a step a segment, and a round passes an exit
        # over all the segments that its match jumps
        assert stats["spec_steps"] < segments + 32 and stats["repair_steps"] < 2 * segments
        assert stats["warp_rounds"] < segments // 8
    if name == "five digits":
        assert re.search(rb"<\d{5},\d{5}>", tok[0, : tl[0]].tobytes())
    if name == "edges":
        assert tl[[0, 1, 2, 3, 7]].tolist() == [0, 1, 2, 3, 0]


def test_model_matches_pallas_interpret():
    """The Pallas kernel (4-digit tokens, S a multiple of 1024) on the corpus's blocks at window 4096
    and the escaped blocks at window 1024, each cut to 36-40 K positions, past a span."""
    for name, S in (("corpus", 40_960), ("escaped", 36_864)):
        x, L, D, lengths, _ = _case(name)
        x, L, D = (np.pad(a[:, :S], ((0, 0), (0, max(0, S - a.shape[1])))) for a in (x, L, D))
        lengths = np.minimum(lengths, S)
        tok_j, tl_j = cp.commit_emit_blocks(jnp.asarray(x.astype(np.int32)), jnp.asarray(L), jnp.asarray(D),
                                            jnp.asarray(lengths), interpret=True)
        tok_j, tl_j = np.asarray(tok_j), np.asarray(tl_j)
        tok, tl, _ = _commit_model(x, L, D, lengths)
        assert np.array_equal(tl, tl_j)
        for b in range(len(tl)):
            assert tok[b, : tl[b]].tobytes() == tok_j[b, : tl[b]].astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# The kernel's own source on the host: lzss_commit.cu built with g++ over
# cuda_host/cuda_emu.h, held against the plain version and the JAX package.

HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {  // B S in out: x, L, D, lengths -> tok, tok_len
    const int B = atoi(argv[1]), S = atoi(argv[2]);
    const size_t guard = 67;  // bytes around the rows that no store may touch
    std::vector<uint8_t> x((size_t)B * S);
    std::vector<int32_t> L((size_t)B * S), D((size_t)B * S), lens(B), tok_len(B, -1);
    FILE* f = fopen(argv[3], "rb");
    if (fread(x.data(), 1, x.size(), f) + fread(L.data(), 4, L.size(), f) + fread(D.data(), 4, D.size(), f) +
            fread(lens.data(), 4, B, f) != x.size() + L.size() + D.size() + B)
        return 1;
    fclose(f);
    const long long spans = std::max(1LL, ((long long)S + SPAN - 1) / SPAN);
    std::vector<int32_t> work(4 * (size_t)B * spans * SPAN_SEGS, 0x7F7F7F7F);  // garbage, as the wrapper's
    // zeroed rows, as the wrapper's, `guard` bytes in: not on a 16-byte boundary
    std::vector<uint8_t> rows((size_t)B * S + 2 * guard, 0);
    for (size_t i = 0; i < guard; ++i) rows[i] = rows[rows.size() - 1 - i] = 0xA5;
    const int rc = rsn_lzss_commit(x.data(), L.data(), D.data(), lens.data(), rows.data() + guard, tok_len.data(),
                                   work.data(), B, S, nullptr);
    f = fopen(argv[4], "wb");
    fwrite(rows.data() + guard, 1, (size_t)B * S, f);
    fwrite(tok_len.data(), 4, B, f);
    fclose(f);
    for (size_t i = 0; i < guard; ++i)
        if (rows[i] != 0xA5 || rows[rows.size() - 1 - i] != 0xA5) return 3;  // a store outside the rows
    return rc;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """A function running kernel E's source, built for the CPU, on numpy fields."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build kernel E's source for the host")
    tmp = tmp_path_factory.mktemp("lzss_commit_host")
    cu = (CSRC / "lzss_commit.cu").read_text()
    # name<<<grid, block, smem, stream>>>(args) -> emu_launch(name, grid, block, args)
    cu = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\)?)",
                lambda m: f"emu_launch({m[1]}, {m[2]}, {m[3]}{')' if m[4] else ', '}", cu)
    src = tmp / "lzss_commit_host.cpp"
    src.write_text('#include "cuda_emu.h"\n' + cu + HOST_MAIN)
    exe = tmp / "lzss_commit_host"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(HOST), "-I", str(CSRC), "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(x, L, D, lengths):
        B, S = x.shape
        inp, out = tmp / "in.bin", tmp / "out.bin"
        inp.write_bytes(b"".join(np.ascontiguousarray(a, dt).tobytes()
                                 for a, dt in ((x, np.uint8), (L, np.int32), (D, np.int32), (lengths, np.int32))))
        subprocess.run([str(exe), str(B), str(S), str(inp), str(out)], check=True)
        r = out.read_bytes()
        return np.frombuffer(r[: B * S], np.uint8).reshape(B, S), np.frombuffer(r[B * S :], np.int32)

    return run


@pytest.mark.parametrize("name", CASES)
def test_kernel_source_on_host_matches_plain(host_kernel, name):
    x, L, D, lengths, _ = _case(name)
    got = host_kernel(x, L, D, lengths)
    want = _plain(x, L, D, lengths)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_kernel_source_on_host_matches_pallas_interpret(host_kernel):
    """The Pallas kernel's blocks of tests/test_torch_lzss.py (text, random, runs, escape-heavy,
    zeros at window 4096), as the JAX package commits them."""
    from tests.test_torch_lzss import BLOCKS, _matches, _matrix

    names, encs, (Lj, Dj), _ = _matches(4096)
    x, lengths = _matrix(encs, 2048, 0)
    tok_j, tl_j = cp.commit_emit_blocks(jnp.asarray(x), jnp.asarray(Lj), jnp.asarray(Dj), jnp.asarray(lengths),
                                        interpret=True)
    tok, tl = host_kernel(x.astype(np.uint8), Lj, Dj, lengths)
    assert np.array_equal(tl, np.asarray(tl_j))
    for i, name in enumerate(names):
        assert tok[i, : tl[i]].tobytes() == np.asarray(tok_j)[i, : tl[i]].astype(np.uint8).tobytes()
        assert tok[i, : tl[i]].tobytes() == lzss_ref.compress(BLOCKS[name], 4096)


def test_chip_smoke_commit_inputs_have_their_shapes(monkeypatch):
    """chip_smoke.py's COMMIT_INPUTS at a small size on the CPU: the shapes, and the L = 2 field,
    whose parse is a literal and then copies of two bytes, so that its tokens are its bytes."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "MAIN_BYTES", 2 * chip_smoke.BLOCK_SIZE)
    monkeypatch.setattr(chip_smoke, "STREAM_BYTES", 20_000)
    data = bench.make_corpus(chip_smoke.MAIN_BYTES)
    for name in ("L=2 container", "L=2 stream", "zeros stream"):
        x, L, D, n = chip_smoke.commit_input(name, data, "cpu")
        rows = 1 if "stream" in name else 2
        width = chip_smoke.STREAM_BYTES if "stream" in name else chip_smoke.BLOCK_SIZE
        assert x.shape == L.shape == D.shape == (rows, width) and n.tolist() == [width] * rows
        if name.startswith("L=2"):
            assert (L[:, 0] == 1).all() and (L[:, 1:] == 2).all()
            tok, tl = lzss_commit._commit_tokens_torch(x, L, D, n)
            assert torch.equal(tok, x) and tl.tolist() == n.tolist()
        else:
            assert not x.any() and L[0, 4096:8192].eq(4096).all()
