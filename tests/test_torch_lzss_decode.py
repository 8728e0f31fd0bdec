"""Kernel F (csrc/lzss_decode.cu) modelled on the CPU, against the plain
version, the host oracle and the JAX package.

Kernel F runs only on the card. A CTA takes a block's token stream TILE
bytes at a time, CHUNK bytes a thread: (A) each chunk's map of the three
parser states, whose exclusive scan gives each chunk its state on entry;
(B) each chunk's output bytes and copying tokens, counted from that state
(a token parsed forward from its ``<``), whose scan gives the offsets and
the token indices; (C) the literals placed, the tokens listed, the first
fault taken by a reduction; (D) the copies in rounds: a token whose source
no pending token writes copies, one whose source lies inside a single
pending token's output takes that token's source; a round that moves fewer
than FEW tokens, or the MAX_ROUNDS-th, hands the rest of the tile to one
warp, which copies the pending tokens in order; then the row is written
once, zeros past ``out_len``. ``_decode_model`` mirrors those passes
in Python and numpy, with the constants read from the kernel's source, and
counts the rounds. It is held, exactly (tolerance 0: rows, ``out_len``,
``err``), against the plain version ``lzss_decode._walk_tokens_torch`` (the
wrapper's route for CPU tensors), the oracle ``lzss_ref.decompress`` and,
on well-formed blocks up to 8192 bytes, the Pallas kernel
``raisin_tpu.ops.lzss_decode_pallas.lzss_decode_blocks`` in interpret mode.
The kernel's own source runs here too, built with g++ over
``tests/cuda_host/cuda_emu.h`` (a CTA's threads as threads, dynamic shared
memory as a static array), against the same references, with rows that
start off 16-byte boundaries, garbage in them beforehand and guard bytes
around them. Inputs come from seeded numpy, from ``bench.make_corpus``
through the port's escape layer, and from the plain match search and
commit on the CPU.
"""

from __future__ import annotations

import functools
import itertools
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from chip_smoke import chained
from raisin_tpu.formats import lzss_ref
from raisin_tpu.ops import lzss_decode_pallas as dp
from raisin_tpu_torch.ops import escape, lzss_commit, lzss_decode, lzss_match
from tests.test_torch_lzss import DECODE_BLOCKS, ODD_STREAMS, _raw_oracle

torch.set_num_threads(1)

CSRC = Path(lzss_decode.__file__).resolve().parent.parent / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"


@functools.cache
def _constants() -> dict[str, int]:
    """Kernel F's integer constants, read from its source (the model mirrors them)."""
    src = (CSRC / "lzss_decode.cu").read_text()
    out: dict[str, int] = {}
    for k, v in re.findall(r"constexpr int (\w+) = ([^;]+);", src):  # integer arithmetic on earlier ones
        out[k] = eval(v.replace(" / ", " // "), {}, dict(out))
    return out


K = _constants()
TILE, CHUNK, FEW, MAX_ROUNDS = K["TILE"], K["CHUNK"], K["FEW"], K["MAX_ROUNDS"]
SATURATE = lzss_decode.SATURATE
OPEN, SEP, CLOSE = ord("<"), ord(","), ord(">")


# ---------------------------------------------------------------------------
# The model


def _step(s: int, c: int) -> int:
    if s == 0:
        return 1 if c == OPEN else 0
    if s == 1:
        return 2 if c == SEP else 1
    return 0 if c == CLOSE else 2


def _parse(t: np.ndarray, n: int, p: int):
    """The token whose '<' is at p: None if the stream ends inside it, else (its '>', D, L)."""
    v, digits, second, D = 0, True, False, 0
    for q in range(p + 1, n):
        c = int(t[q])
        if c == (CLOSE if second else SEP):
            value = v if digits else 0
            if second:
                return q, D, value
            D, second, v, digits = value, True, 0, True
        elif 0x30 <= c <= 0x39:
            v = min(v * 10 + c - 0x30, SATURATE)
        else:
            digits = False
    return None


def _chunk_walk(t, n, lo, hi, s, o, cap, out=None, tokens=None):
    """Passes B (``out`` None: the chunk's output bytes, saturated, and copying tokens) and C
    (its literals placed in ``out`` from offset o, its tokens appended to ``tokens``: its first
    fault as 2 * position + code - 1, or None)."""
    count, toks = 0, 0
    p = lo
    while p < hi:
        c = int(t[p])
        if s != 0:
            s = _step(s, c)
        elif c != OPEN:
            if out is None:
                count = min(count + 1, SATURATE)
            else:
                if o >= cap:
                    return 2 * p + 1
                out[o] = c
                o += 1
        else:
            tok = _parse(t, n, p)
            if tok is None:
                break
            q, D, L = tok
            if out is None:
                count = min(count + L, SATURATE)
                toks += L > 0
            else:
                if D > o or L > D:
                    return 2 * q
                if o + L > cap:
                    return 2 * q + 1
                if L > 0:
                    tokens.append((o, o - D, L))
                o += L
            p = q
        p += 1
    return (count, toks) if out is None else None


def _exclusive(values, op, identity):
    acc, out = identity, []
    for v in values:
        out.append(acc)
        acc = op(acc, v)
    return out, acc


def _compose(a, b):  # the map a, then b; a map is (s(0), s(1), s(2))
    return tuple(b[s] for s in a)


def _resolve(tokens, out: np.ndarray, stats: dict) -> None:
    """Pass D on one tile's tokens, (dst, src, L) in stream order, copying inside ``out``."""
    if not tokens:
        return
    dst, src, ln = (np.array(a, np.int64) for a in zip(*tokens))
    end = dst + ln
    cnt = dst.size
    idx = np.arange(cnt)
    done = np.zeros(cnt, bool)

    def blocker(js):
        """Per token of js: the first pending token whose output overlaps its source, or -1."""
        lo = np.searchsorted(end, src[js], side="right")  # the first whose output ends past it
        nxt = np.minimum.accumulate(np.where(done, cnt, idx)[::-1])[::-1]  # the next pending from each
        i = np.append(nxt, cnt)[lo]
        hit = (i < js) & (dst[np.minimum(i, cnt - 1)] < src[js] + ln[js])
        return np.where(hit, i, -1)

    def copy(j):
        out[dst[j] : dst[j] + ln[j]] = out[src[j] : src[j] + ln[j]]

    for rnd in itertools.count():
        js = np.nonzero(~done)[0]
        i = blocker(js)
        ready = js[i < 0]
        inside = (i >= 0) & (dst[i] <= src[js]) & (src[js] + ln[js] <= end[i])
        moved, via = js[inside], i[inside]
        for j in ready:
            copy(j)
        src[moved] = src[via] + (src[moved] - dst[via])
        done[ready] = True
        stats["rounds"] += 1
        stats["moved"] += moved.size
        if done.all():
            return
        if ready.size + moved.size < FEW or rnd + 1 >= MAX_ROUNDS:
            break
    stats["fallback_tiles"] += 1
    for j in np.nonzero(~done)[0]:  # one warp, in order
        copy(j)
        stats["steps"] += 1


def _decode_block(t: np.ndarray, n: int, cap: int, stats: dict):
    """Kernel F's passes on one block: (its output bytes, err)."""
    out = np.zeros(cap, np.uint8)
    state, base = 0, 0
    for p0 in range(0, n, TILE):
        stats["tiles"] += 1
        chunks = [(lo, min(lo + CHUNK, n)) for lo in range(p0, min(p0 + TILE, n), CHUNK)]
        # A: the state maps and their scan
        maps = []
        for lo, hi in chunks:
            m = [0, 1, 2]
            for c in t[lo:hi]:
                m = [_step(s, int(c)) for s in m]
            maps.append(tuple(m))
        before, whole = _exclusive(maps, _compose, (0, 1, 2))
        entry = [m[state] for m in before]
        state = whole[state]
        # B: the counts and their scan
        counts = [_chunk_walk(t, n, lo, hi, s, 0, cap) for (lo, hi), s in zip(chunks, entry)]
        offsets, (tile_out, _) = _exclusive(counts, lambda a, b: (min(a[0] + b[0], SATURATE), a[1] + b[1]), (0, 0))
        # C: literals, tokens, the first fault
        tokens, faults = [], []
        for (lo, hi), s, (o, k) in zip(chunks, entry, offsets):
            assert faults or len(tokens) == k  # the scan's token index
            f = _chunk_walk(t, n, lo, hi, s, min(base + o, SATURATE), cap, out, tokens)
            if f is not None:
                faults.append(f)
        if faults:
            return None, min(faults) % 2 + 1
        assert len(tokens) <= K["MAX_TOKENS"]
        base = min(base + tile_out, SATURATE)
        _resolve(tokens, out, stats)
    return out[:base].tobytes(), 0


def _decode_model(tok: np.ndarray, tok_len: np.ndarray, cap: int):
    """(rows (B, cap) uint8, out_len (B,), err (B,), stats): the rounds, moved sources and
    one-warp steps of every block."""
    stats = {"tiles": 0, "rounds": 0, "moved": 0, "steps": 0, "fallback_tiles": 0}
    B, S = tok.shape
    rows = np.zeros((B, cap), np.uint8)
    out_len, err = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for b in range(B):
        got, err[b] = _decode_block(tok[b], min(max(int(tok_len[b]), 0), S), cap, stats)
        if got is not None:
            rows[b, : len(got)] = np.frombuffer(got, np.uint8)
            out_len[b] = len(got)
    return rows, out_len, err, stats


def _plain(tok, tok_len, cap):
    out = lzss_decode._walk_tokens_torch(torch.from_numpy(tok), torch.from_numpy(tok_len), cap)
    return tuple(o.numpy() for o in out)


# ---------------------------------------------------------------------------
# Inputs


def _rows(streams: list[bytes], width: int | None = None):
    """Streams as (tok (B, S) uint8, zero past each, tok_len (B,) int32)."""
    S = max(width or 0, max(map(len, streams)), 1)
    tok = np.zeros((len(streams), S), np.uint8)
    for i, s in enumerate(streams):
        tok[i, : len(s)] = np.frombuffer(s, np.uint8)
    return tok, np.array([len(s) for s in streams], np.int32)


def _escaped(blocks: list[bytes]):
    m = np.zeros((len(blocks), max(map(len, blocks))), np.uint8)
    for i, b in enumerate(blocks):
        m[i, : len(b)] = np.frombuffer(b, np.uint8)
    return escape.escape_blocks(torch.from_numpy(m), torch.tensor([len(b) for b in blocks], dtype=torch.int32))


def _tokens(xe: torch.Tensor, en: torch.Tensor, L, D):
    """The plain commit's token streams -> (tok, tok_len, cap_out as the container's: twice the width)."""
    tok, tl = lzss_commit._commit_tokens_torch(xe, L, D, en)
    return tok.numpy(), tl.numpy(), 2 * xe.shape[1]


def _compressed(blocks: list[bytes], window: int):
    """Blocks through the escape layer, the plain match search and the plain commit."""
    xe, en = _escaped(blocks)
    return _tokens(xe, en, *lzss_match._find_matches_torch(xe, en, window))


def _zeros(lengths: list[int], window: int):
    """Blocks of zero bytes, compressed; the match search's fields in closed form (at position i
    the longest match is min(i, window, n - i) long, at the largest distance min(i, window))."""
    S = max(lengths)
    i = np.arange(S)[None, :]
    n = np.asarray(lengths, np.int64)[:, None]
    D = np.where(i < n, np.minimum(i, window), 0)
    L = np.where(i < n, np.minimum(D, n - i), 0)
    D = np.where(L > 0, D, 0)
    xe = torch.zeros((len(lengths), S), dtype=torch.uint8)
    return _tokens(xe, torch.tensor(lengths, dtype=torch.int32), torch.from_numpy(L.astype(np.int32)),
                   torch.from_numpy(D.astype(np.int32)))


# malformed streams beyond ODD_STREAMS, each a batch (streams, tok_len or None, cap_out, whether
# the oracle, which has no capacity, gives the same: cap_out holds every output)
MALFORMED = {
    "odd streams": (ODD_STREAMS, None, 64, True),
    "'<' inside numbers": ([b"ab<1<2,1>c", b"abcd<2,1<>x", b"abcd<2<,1>x", b"xy<<1,1>"], None, 64, True),
    "20+ digits": ([b"abc<" + b"9" * 25 + b",1>", b"abc<1," + b"0" * 30 + b"2>",
                    b"abcabc<3," + b"0" * 40 + b"3>", b"abc<" + b"0" * 22 + b"3,3>tail"], None, 64, True),
    "a token over many chunks": ([b"hello<" + b"0" * 100 + b"5," + b"0" * 77 + b"3>!", b"q" * 40], None, 64, True),
    "a token over a tile": ([b"x" * (TILE - 7) + b"<" + b"0" * 300 + b"1,1>yz"], None, TILE + 8, True),
    "capacity before reference": ([b"abcdef<9,1>"], None, 3, False),
    "reference before capacity": ([b"ab<5,1>cdefgh"], None, 4, True),
    "a fault between good blocks": ([b"abcabc<3,3>", b"ab<3,1>cd", b"xyz<1,1><2,2>"], None, 16, True),
    "<0,0>": ([b"ab<0,0>cd", b"<0,0>", b"<0,0><0,0>a<1,1>"], None, 16, True),
    "unclosed at n": ([b"abc<1,1", b"abc<1", b"abc<", b"abc<1,1>"], [7, 5, 4, 7], 16, True),
    "tok_len 0, negative, past S": ([b"abcd", b"ab<2,2>", b"xyz<1,1>"], [0, -5, 99], 16, True),
    "cap_out 0": ([b"abc", b"", b"<0,0>", b"<1,1>"], None, 0, False),
    "cap_out under a literal run": ([b"abcdefgh", b"abcd", b"ab<2,2>"], None, 5, False),
}


@functools.cache
def _case(name: str):
    """A named input: (tok, tok_len, cap_out, whether the oracle gives the same)."""
    if name in MALFORMED:
        streams, lens, cap, oracle = MALFORMED[name]
        tok, tl = _rows(list(streams))
        if lens is not None:
            tl = np.array(lens, np.int32)
        return tok, tl, cap, oracle
    if name == "corpus":  # two blocks over several tiles each
        return (*_compressed([bench.make_corpus(40_000), bench.make_corpus(27_003)[3:]], 4096), True)
    if name == "random":  # almost all literals
        rng = np.random.default_rng(9)
        return (*_compressed([rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(), b"x"], 1024), True)
    if name == "escaped":  # escaping doubles the block: output past STAGE beside one inside it
        heavy = b"\xff" * (K["STAGE"] // 2 + 3000) + bench.make_corpus(4000)
        return (*_compressed([heavy, bench.make_corpus(9000)], 1024), True)
    if name == "zeros":  # a chain of tokens "<4096,4096>", each copying the one before
        return (*_zeros([40_000, 9_999], 4096), True)
    if name == "zeros past the stage":  # window 65535: five-digit tokens, output past STAGE
        return (*_zeros([K["STAGE"] + 6_000, 70_000], 65535), True)
    if name == "chained":
        tok, tl = _rows([chained(20_000, 6, 6), chained(777, 6, 6), b""])
        return tok, tl, 24_000, True
    if name == "chain no move shortens":  # "<5,4>": each source spans two tokens' outputs
        tok, tl = _rows([chained(4_000, 5, 4), b"abc"])
        return tok, tl, 4_100, True
    raise KeyError(name)


CASES = ["corpus", "random", "escaped", "zeros", "zeros past the stage", "chained", "chain no move shortens",
         *MALFORMED]


def _oracle(tok, tok_len, cap):
    """(rows, out_len, err) from lzss_ref.decompress before its escape pass, block by block."""
    B, S = tok.shape
    rows = np.zeros((B, cap), np.uint8)
    out_len, err = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for b in range(B):
        want, err[b] = _raw_oracle(tok[b, : min(max(int(tok_len[b]), 0), S)].tobytes())
        if want is not None:
            rows[b, : len(want)] = np.frombuffer(want, np.uint8)
            out_len[b] = len(want)
    return rows, out_len, err


# ---------------------------------------------------------------------------
# The model against the references


def test_model_reads_kernel_constants():
    assert K["TILE"] == K["THREADS"] * CHUNK and K["THREADS"] % 32 == 0 and CHUNK == 16
    assert K["MIN_COPY"] == len(b"<1,1>") and K["MAX_TOKENS"] == -(-TILE // K["MIN_COPY"])
    assert K["PER_THREAD"] * K["THREADS"] >= K["MAX_TOKENS"]
    # a random 64 KiB block escapes to ~66 KB: the container's blocks stay in shared memory
    assert K["STAGE"] % 16 == 0 and K["STAGE"] >= 65536 + 2048
    # two CTAs an SM: 228 KB, less 1 KB a CTA, and the static arrays
    assert K["SMEM_BYTES"] == K["STAGE"] + 16 + TILE + K["MAX_TOKENS"] * 17
    assert 2 * (K["SMEM_BYTES"] + 1024 + 4 * (2 * K["WARPS"] + 4)) <= 228 * 1024
    assert SATURATE == 1 << 30 and lzss_decode.ERR_REFERENCE == 1 and lzss_decode.ERR_CAPACITY == 2


@pytest.mark.parametrize("name", CASES)
def test_model_matches_plain(name):
    tok, tl, cap, oracle = _case(name)
    rows, out_len, err, stats = _decode_model(tok, tl, cap)
    want = _plain(tok, tl, cap)
    for g, w in zip((rows, out_len, err), want):
        assert np.array_equal(g, w)
    if oracle:
        for g, w in zip((rows, out_len, err), _oracle(tok, tl, cap)):
            assert np.array_equal(g, w)
    if name not in MALFORMED:
        assert not err.any()
    n = np.clip(tl, 0, tok.shape[1])
    if name == "corpus":  # few rounds a tile, most tokens in the CTA's rounds
        assert (n > 2 * TILE).all() and stats["rounds"] <= 16 * stats["tiles"]
    if name == "chained":  # moved sources: ~log rounds a tile, no one-warp walk
        assert stats["moved"] > 0 and stats["steps"] == 0 and stats["rounds"] <= 16 * stats["tiles"]
    if name.startswith("zeros"):  # a few tokens a block, each copying the one before
        assert stats["rounds"] <= 4 * stats["tiles"] and stats["steps"] <= 16 * stats["tiles"]
    if name == "chain no move shortens":  # a step a token for the one warp
        assert stats["fallback_tiles"] == 1 and stats["steps"] >= (4_000 - 5) // 4 - FEW
    if name == "zeros past the stage":
        assert out_len[0] > K["STAGE"] > out_len[1] - 70_000
    if name == "escaped":
        assert out_len[0] > K["STAGE"] > out_len[1]
    if name == "capacity before reference":
        assert err.tolist() == [lzss_decode.ERR_CAPACITY]
    if name == "reference before capacity":
        assert err.tolist() == [lzss_decode.ERR_REFERENCE]
    if name == "a fault between good blocks":
        assert err.tolist() == [0, lzss_decode.ERR_REFERENCE, 0]


def test_model_matches_pallas_interpret():
    """Well-formed blocks up to 8192 bytes, as tests/test_torch_lzss.py runs the Pallas kernel."""
    encs = [lzss_ref.encode_opening_symbols(p) for p in DECODE_BLOCKS]
    encs.append(lzss_ref.encode_opening_symbols(bench.make_corpus(7000)))
    toks = [lzss_ref.commit_tokens(e, lzss_ref.find_matches(e, 4096)) for e in encs]
    tok, tl = _rows(toks, 8192)
    rows_j, olen_j = dp.lzss_decode_blocks(jnp.asarray(tok.astype(np.int32)), jnp.asarray(tl), cap_out=8192,
                                           interpret=True)
    rows_j, olen_j = np.asarray(rows_j), np.asarray(olen_j)
    rows, out_len, err, _ = _decode_model(tok, tl, 8192)
    assert not err.any() and np.array_equal(out_len, olen_j)
    for i, e in enumerate(encs):
        assert rows[i, : out_len[i]].tobytes() == rows_j[i].tobytes()[: olen_j[i]] == e  # rows_j: packed words


# ---------------------------------------------------------------------------
# The kernel's own source on the host: lzss_decode.cu built with g++ over
# cuda_host/cuda_emu.h, held against the plain version and the JAX package.

HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {  // B S cap in out: tok, tok_len -> rows, out_len, err, stats
    const int B = atoi(argv[1]), S = atoi(argv[2]), cap = atoi(argv[3]);
    const size_t guard = 67;  // bytes around the rows that no store may touch; the rows start off 16 bytes
    std::vector<uint8_t> tok((size_t)B * S);
    std::vector<int32_t> lens(B), out_len(B, -1), err(B, -1), stats(2 * (size_t)B, -1);
    FILE* f = fopen(argv[4], "rb");
    if (fread(tok.data(), 1, tok.size(), f) + fread(lens.data(), 4, B, f) != tok.size() + B) return 1;
    fclose(f);
    std::vector<uint8_t> rows((size_t)B * cap + 2 * guard, 0xA5);  // garbage, as the wrapper's empty rows
    const int rc = rsn_lzss_decode(tok.data(), lens.data(), rows.data() + guard, out_len.data(), err.data(),
                                   stats.data(), B, S, cap, nullptr);
    f = fopen(argv[5], "wb");
    fwrite(rows.data() + guard, 1, (size_t)B * cap, f);
    fwrite(out_len.data(), 4, B, f);
    fwrite(err.data(), 4, B, f);
    fwrite(stats.data(), 4, 2 * (size_t)B, f);
    fclose(f);
    for (size_t i = 0; i < guard; ++i)
        if (rows[i] != 0xA5 || rows[rows.size() - 1 - i] != 0xA5) return 3;  // a store outside the rows
    return rc;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """A function running kernel F's source, built for the CPU, on numpy token rows."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build kernel F's source for the host")
    tmp = tmp_path_factory.mktemp("lzss_decode_host")
    cu = (CSRC / "lzss_decode.cu").read_text()
    # name<<<grid, block, smem, stream>>>(args) -> emu_launch(name, grid, block, args)
    cu = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\)?)",
                lambda m: f"emu_launch({m[1]}, {m[2]}, {m[3]}{')' if m[4] else ', '}", cu)
    # extern __shared__ T name[]; -> __shared__ T name[EMU_DYNAMIC_SHARED_BYTES];
    cu, found = re.subn(r"extern __shared__ (.*?)\[\];", r"__shared__ \1[EMU_DYNAMIC_SHARED_BYTES];", cu)
    assert found == 1
    src = tmp / "lzss_decode_host.cpp"
    src.write_text('#include "cuda_emu.h"\n' + cu + HOST_MAIN)
    exe = tmp / "lzss_decode_host"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(HOST), "-I", str(CSRC), "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(tok, tok_len, cap):
        B, S = tok.shape
        inp, out = tmp / "in.bin", tmp / "out.bin"
        inp.write_bytes(np.ascontiguousarray(tok, np.uint8).tobytes() + np.ascontiguousarray(tok_len, np.int32).tobytes())
        subprocess.run([str(exe), str(B), str(S), str(cap), str(inp), str(out)], check=True)
        r = out.read_bytes()
        rows = np.frombuffer(r[: B * cap], np.uint8).reshape(B, cap)
        ints = np.frombuffer(r[B * cap :], np.int32)
        return rows, ints[:B], ints[B : 2 * B], ints[2 * B :].reshape(B, 2)

    return run


@pytest.mark.parametrize("name", CASES)
def test_kernel_source_on_host_matches_plain(host_kernel, name):
    tok, tl, cap, _ = _case(name)
    rows, out_len, err, stats = host_kernel(tok, tl, cap)
    for g, w in zip((rows, out_len, err), _plain(tok, tl, cap)):
        assert np.array_equal(g, w)
    # the kernel's rounds and one-warp steps are the model's, block by block
    for b in range(tok.shape[0]):
        m = _decode_model(tok[b : b + 1], tl[b : b + 1], cap)[3]
        assert stats[b].tolist() == [m["rounds"], m["steps"]]


def test_kernel_source_on_host_matches_pallas_interpret(host_kernel):
    """tests/test_torch_lzss.py's decode blocks, as the JAX package decodes them."""
    encs = [lzss_ref.encode_opening_symbols(p) for p in DECODE_BLOCKS]
    toks = [lzss_ref.commit_tokens(e, lzss_ref.find_matches(e, 4096)) for e in encs]
    tok, tl = _rows(toks, 2048)
    rows_j, olen_j = dp.lzss_decode_blocks(jnp.asarray(tok.astype(np.int32)), jnp.asarray(tl), cap_out=8192,
                                           interpret=True)
    rows, out_len, err, _ = host_kernel(tok, tl, 8192)
    assert not err.any() and np.array_equal(out_len, np.asarray(olen_j))
    for i, e in enumerate(encs):
        assert rows[i, : out_len[i]].tobytes() == np.asarray(rows_j)[i].tobytes()[: out_len[i]] == e
        assert not rows[i, out_len[i] :].any()


def test_chip_smoke_walk_inputs_give_back_their_blocks(monkeypatch):
    """chip_smoke.py's WALK_INPUTS at a small size on the CPU: the shapes, and the plain version
    gives back each input as time_walk checks it on the card; the model agrees on the chains."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "BLOCK_SIZE", 4096)
    monkeypatch.setattr(chip_smoke, "MAIN_BYTES", 3 * 4096)
    data = bench.make_corpus(chip_smoke.MAIN_BYTES)
    for name in chip_smoke.WALK_INPUTS:
        (tok, tl, cap), want = chip_smoke.walk_input(name, data, "cpu")
        assert tok.shape[0] == 3 and cap == 2 * 4096 and tok.shape[1] == int(tl.max()) + (name not in ("chained", "chain <5,4>"))
        rows, ol, err = lzss_decode.walk_tokens(tok, tl, cap)
        assert not err.any()
        if isinstance(want, bytes):
            assert ol.tolist() == [len(want)] * 3 and all(r[: len(want)].numpy().tobytes() == want for r in rows)
            got = _decode_model(tok.numpy(), tl.numpy(), cap)
            assert np.array_equal(got[0], rows.numpy()) and np.array_equal(got[1], ol.numpy())
        else:
            xe, en = want
            assert torch.equal(ol, en) and torch.equal(rows[:, : xe.shape[1]], xe)
