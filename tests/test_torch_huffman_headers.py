"""The Huffman container's block headers, written and read in the native runtime, against the Python path.

``ops/huffman_blocks`` writes the card blocks' headers in
``native.huffman_encode_tables`` and reads
them in ``native.huffman_read_headers``; the host oracle decodes a block that
the native reader does not take. The tests rebuild the per-block Python loops
that these calls replace (``_python_code_tables``, ``_python_read_headers``:
``build_header``, ``read_header``, ``ascii_ids``, and the trees of
``build_tree`` and ``packed_table``, block by block) and
require the same bytes, counts, ids and card/host decisions, on seeded random
count tables, on fuzzed headers and on whole containers; every comparison is
exact. The one rule the loops lacked: a header count above
``native.HUFFMAN_MAX_COUNT``, which no writer's block reaches, leaves the
block to the oracle.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from perfbench import corpus
from raisin_tpu_torch import native
from raisin_tpu_torch.formats import huffman as hf
from raisin_tpu_torch.ops import huffman_blocks, huffman_rows
from raisin_tpu_torch.parallel import blocks

HUFF, LZ_HUFF = ("huffman",), ("lzss", "huffman")
SEP = hf.SEPARATOR


# ---------------------------------------------------------------------------
# The Python loops the native calls replace


def _with_ids(tree, ids):
    """The tree with each leaf's symbol replaced by its id."""
    if isinstance(tree, hf.Leaf):
        return hf.Leaf(tree.freq, int(ids[tree.value]))
    return hf.Node(tree.freq, _with_ids(tree.left, ids), _with_ids(tree.right, ids))


def _python_trees(counts: np.ndarray, ids: np.ndarray):
    """Each row's Go tree from ``formats/huffman.build_tree`` -> (codes (B, 256) uint32, lens (B, 256) int32,
    tables (B, 64) int32, longest (B,) int32), as the native runtime keeps them: a code past 32 bits is 0,
    a one-leaf tree's code is empty and it has no child table (``huffman_blocks.packed_table`` at ``ids``),
    nor has a tree with an id of 128 or more, and a row of zeros has no tree (longest -1)."""
    B = len(counts)
    codes, lens = np.zeros((B, 256), np.uint32), np.zeros((B, 256), np.int32)
    tables, longest = np.zeros((B, 64), np.int32), np.full(B, -1, np.int32)
    for b in range(B):
        syms = np.nonzero(counts[b])[0]
        if not syms.size:
            continue
        tree = hf.build_tree(dict(zip(syms.tolist(), counts[b, syms].tolist())))
        vals, bins = hf.print_codes(tree)
        lens[b, vals] = [len(c) for c in bins]
        codes[b, vals] = [int(c, 2) if 0 < len(c) <= 32 else 0 for c in bins]
        longest[b] = max(len(c) for c in bins)
        table = None if isinstance(tree, hf.Leaf) else huffman_blocks.packed_table(_with_ids(tree, ids[b]))
        if table is not None:
            tables[b] = table
    return codes, lens, tables, longest


def _right_aligned(pieces: list[bytes], width: int) -> np.ndarray:
    out = np.zeros((len(pieces), width), dtype=np.uint8)
    for b, p in enumerate(pieces):
        out[b, width - len(p) :] = np.frombuffer(p, dtype=np.uint8)
    return out


def _python_code_tables(counts: np.ndarray, raw: np.ndarray | None = None) -> native.EncodeTables:
    """code_tables with its headers, ids and bit counts built block by block in Python."""
    B = len(counts)
    raw = np.zeros(B, dtype=bool) if raw is None else raw
    on_host = counts[:, huffman_rows.NSYM :].any(1) & ~raw
    ids = np.tile(np.arange(256, dtype=np.uint8), (B, 1))
    for b in np.nonzero(raw)[0].tolist():
        at = huffman_blocks.ascii_ids(np.nonzero(counts[b])[0].tolist())
        if at is None:
            on_host[b] = True
        else:
            ids[b] = at
    card = np.where(on_host[:, None], 0, counts)
    codes256, lens256, _, longest = _python_trees(card, ids)
    if (longest > huffman_rows.CONTAINER_CODE_BITS).any():
        raise ValueError(f"huffman: code length beyond {huffman_rows.CONTAINER_CODE_BITS} bits")
    codes = np.zeros((B, huffman_rows.NSYM), dtype=np.uint32)
    code_lens = np.zeros((B, huffman_rows.NSYM), dtype=np.int32)
    rows, syms = np.nonzero(card)
    codes[rows, ids[rows, syms]] = codes256[rows, syms]
    code_lens[rows, ids[rows, syms]] = lens256[rows, syms]
    prefixes: list[bytes] = []
    for b in range(B):
        if on_host[b]:
            prefixes.append(b"")
            continue
        present = np.nonzero(counts[b])[0]
        freqs = dict(zip(present.tolist(), counts[b, present].tolist()))
        prefixes.append(hf.build_header(freqs, raw=bool(raw[b])) + SEP)
    nbits = (counts[:, : huffman_rows.NSYM] * code_lens).sum(1)
    for b in np.nonzero(raw & ~on_host)[0].tolist():
        nbits[b] = (counts[b] * code_lens[b, ids[b]]).sum()
    lens = np.array([len(p) for p in prefixes], dtype=np.int64)
    return native.EncodeTables(on_host, ids, codes, code_lens, nbits, _right_aligned(prefixes, int(lens.max(initial=0))),
                               lens, int(longest.max(initial=-1)))


def _python_read(data: bytes, lo: int, hi: int):
    """The per-block header read the native reader replaced: None where the block takes the host oracle,
    else (freqs, ascii ids or None, pad byte, payload start, payload bytes)."""
    cut = data.find(SEP, lo, hi)
    freqs, byte_coded, at = None, False, None
    if cut >= 0 and cut + len(SEP) < hi:
        try:
            freqs, byte_coded = hf.read_header(data[lo:cut])
        except ValueError:
            freqs = None
        if byte_coded and freqs:
            at = huffman_blocks.ascii_ids(freqs)
    if (not freqs or len(freqs) < 2 or min(freqs.values()) < 1
            or (at is None and max(freqs) >= huffman_rows.NSYM)):
        return None
    return freqs, at, data[cut + len(SEP)], cut + len(SEP) + 1, hi - (cut + len(SEP) + 1)


def _big_count(piece: bytes) -> bool:
    """Whether the scan of the piece's header (formats/huffman._scan_header) builds up a count above
    native.HUFFMAN_MAX_COUNT, taken at a '|' or not."""
    head = piece.split(SEP, 1)[0]
    i, value = 0, 0
    while i < len(head):
        if head[i] != 0x7C:
            if 0x30 <= head[i] <= 0x39:
                value = 10 * value + head[i] - 0x30
                if value > native.HUFFMAN_MAX_COUNT:
                    return True
            i += 1
            continue
        value = 0
        i += 3 if head[i + 1 : i + 3] == b"\\n" and i + 2 < len(head) else 2
    return False


def _python_read_headers(data, starts, sizes, base) -> native.ReadHeaders:
    """native.huffman_read_headers as the per-block loop it replaced: _python_read block by block, then the
    trees of the blocks the card takes."""
    B = len(starts)
    out = native.ReadHeaders(
        np.zeros(B, bool), np.zeros((B, 256), np.int64), np.tile(np.arange(256, dtype=np.uint8), (B, 1)),
        np.zeros(B, bool), np.zeros((B, 128), np.uint8), np.zeros(B, np.int32), np.zeros(B, np.int64),
        np.zeros(B, np.int64), np.zeros((B, 64), np.int32),
    )
    for b in range(B):
        lo, hi = int(starts[b]), int(starts[b] + sizes[b])
        want = None if _big_count(data[lo:hi]) else _python_read(data, lo, hi)
        if want is None:
            continue
        freqs, at, pad, pstart, blen = want
        out.taken[b] = True
        out.freqs[b, list(freqs)] = list(freqs.values())
        if at is not None:
            out.ids[b] = at
            out.raw[b] = True
            out.back[b, at[list(freqs)]] = list(freqs)
        out.pads[b], out.pstart[b], out.blens[b] = pad, pstart - base, blen
    if out.taken.any():
        out.tables[out.taken] = _python_trees(out.freqs[out.taken], out.ids[out.taken])[2]
    return out


# ---------------------------------------------------------------------------
# Writing


# the symbols a header's text treats with care: NUL, newline, '|', '\', the digits
SPECIAL = [0, 10, 0x7C, 0x5C, *range(0x30, 0x3A)]
COUNTS = [1, 9, 10, 99, 100, 65535, 65536]


def _count(r: random.Random) -> int:
    return r.choice(COUNTS) if r.random() < 0.3 else r.randint(1, 65536)


def _count_table(r: random.Random) -> tuple[np.ndarray, bool]:
    """One block's (256,) counts and raw flag: ASCII, byte-coded, or for the host."""
    kind = r.choice(["ascii", "ascii", "raw", "raw", "wide", "raw_full", "one", "empty"])
    c = np.zeros(256, np.int64)
    ascii_syms = r.sample(range(128), r.randint(2, 100)) + r.sample(SPECIAL, r.randint(0, len(SPECIAL)))
    if kind == "one":
        ascii_syms = [r.choice(SPECIAL)]
    if kind != "empty":
        for s in ascii_syms:
            c[s] = _count(r)
    if kind in ("raw", "wide"):
        for s in r.sample(range(128, 256), r.randint(1, 20)):
            c[s] = _count(r)
    if kind == "raw_full":  # more bytes >= 0x80 than free ASCII ids: the host oracle
        for s in range(60, 256):
            c[s] = _count(r)
    return c, kind in ("raw", "raw_full")


@pytest.mark.parametrize("seed", range(6))
def test_code_tables_write_the_python_headers_and_tables(seed):
    r = random.Random(1000 + seed)
    tables = [_count_table(r) for _ in range(40)]
    counts = np.stack([c for c, _ in tables])
    raw = np.array([w for _, w in tables])
    got, want = huffman_blocks.code_tables(counts, raw), _python_code_tables(counts, raw)
    assert want.on_host.any() and not want.on_host.all()
    for name in native.EncodeTables._fields:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.heads.dtype == np.uint8 and got.heads.shape == want.heads.shape
    P = got.heads.shape[1]
    for b in np.nonzero(~got.on_host)[0].tolist():
        present = np.nonzero(counts[b])[0]
        head = hf.build_header(dict(zip(present.tolist(), counts[b, present].tolist())), raw=bool(raw[b])) + SEP
        assert got.heads[b, P - len(head) :].tobytes() == head and not got.heads[b, : P - len(head)].any()


def test_headers_write_newline_and_bar_entries_exactly():
    counts = np.zeros((2, 256), np.int64)
    counts[0, [0, 10, 0x30, 0x5C, 0x7C]] = [7, 65536, 1, 10, 100]
    counts[1, [10, 0x41, 0xFF]] = [3, 2, 12]
    t = huffman_blocks.code_tables(counts, np.array([False, True]))
    assert t.heads[0, -int(t.head_lens[0]) :].tobytes() == b"7|\x0065536|\\n1|010|\\100||\\\n"
    assert t.heads[1, -int(t.head_lens[1]) :].tobytes() == b"3|\\n2|A12|\xff\\\n"
    assert t.ids[1, 0xFF] == 127 and t.code_lens[1, 127] > 0


# ---------------------------------------------------------------------------
# Reading


def _entries(freqs: dict[int, int], raw: bool) -> list[bytes]:
    return [hf.build_header({s: f}, raw=raw) for s, f in sorted(freqs.items())]


def _well_formed(r: random.Random, kind: str | None = None) -> bytes:
    """A block as the container writes it: header, separator, pad byte, payload; its symbols ASCII, bytes
    (byte-coded) or runes (Go's stream of a non-ASCII block, which the host oracle decodes)."""
    kind = kind or r.choice(["ascii", "raw", "rune"])
    freqs = {s: _count(r) for s in r.sample(range(128), r.randint(2, 30)) + r.sample(SPECIAL, 3)}
    if kind == "raw":
        freqs.update({s: _count(r) for s in r.sample(range(128, 256), r.randint(1, 8))})
    if kind == "rune":
        freqs.update({s: _count(r) for s in r.sample([0xE9, 0x3B1, 0x20AC, 0x1F600, 0xFFFD], 2)})
    head = b"".join(_entries(freqs, kind == "raw"))
    return head + SEP + bytes([r.randrange(8)]) + r.randbytes(r.randint(0, 6))


JUNK = [b" ", b"x", b"7", b"\\", b"\n", b"\xff", b"\xc3", b"\x80", b"\\n", b"|"]


def _malformed(r: random.Random) -> list[bytes]:
    """Headers the container never writes, each a block with a separator and a pad byte unless named."""
    ascii_e = _entries({s: _count(r) for s in r.sample(range(32, 127), 6)}, False)
    tail = SEP + b"\x03" + r.randbytes(3)
    out = [
        b"".join(e + r.choice(JUNK) for e in ascii_e) + tail,  # junk between entries
        b"".join(ascii_e) + b"5|a9|a" + tail,  # a duplicate, the later count kept
        b"".join(ascii_e) + b"4|a" + b"".join(ascii_e[:2]) + tail,
        b"".join(ascii_e) + b"0|z" + tail,  # a zero count
        b"".join(ascii_e) + b"|q" + tail,  # no digits: a count of 0
        b"".join(ascii_e) + b"5|a0|a" + tail,  # a duplicate with a zero count
        b"".join(ascii_e) + b"1234567890123456789|z" + tail,  # 19 digits
        b"".join(ascii_e) + b"99999999999999999999|z" + tail,  # 20 digits, past int64
        b"".join(ascii_e) + b"000000000000000000012|z" + tail,  # leading zeros
        b"".join(ascii_e) + b"|" + tail,  # '|' last
        b"".join(ascii_e) + b"3|\\n" + tail,  # "\n" at the header's end
        b"".join(ascii_e) + b"3|\\" + tail,  # '\' last
        b"".join(ascii_e) + b"3|\xc3\xa9" + tail,  # a multi-byte rune
        b"".join(ascii_e) + b"3|\xe2\x82\xac5|\xf0\x9f\x98\x80" + tail,
        b"".join(ascii_e) + b"3|\xef\xbf\xbd" + tail,  # EF BF BD, U+FFFD, valid
        b"".join(ascii_e) + b"3|\xef\xbf\xbd4|\xff" + tail,  # beside a stray byte: byte-coded
        b"".join(ascii_e) + b"3|\xff" + tail,  # a stray byte
        b"".join(ascii_e) + b"3|\x80" + tail,
        b"".join(ascii_e) + b"3|\xc3" + tail,  # a rune cut by the header's end
        b"".join(ascii_e) + b"3|\xe0\x80\x80" + tail,  # an overlong form
        b"".join(ascii_e) + b"3|\xed\xa0\x80" + tail,  # a surrogate
        b"".join(ascii_e) + b"3|\xf4\x90\x80\x80" + tail,  # past U+10FFFF
        b"".join(ascii_e) + b"3|\xf0\x9f\x98" + tail,  # a four-byte rune cut short
        b"".join(_entries({s: 2 for s in range(1, 200)}, True)) + tail,  # too few free ASCII ids
        b"".join(_entries({s: 2 for s in range(60, 256)}, True)) + tail,
        b"".join(ascii_e) + SEP,  # no pad byte
        b"".join(ascii_e),  # no separator
        b"5|a" + tail,  # one symbol
        tail,  # an empty header
        b"",  # an empty block
        b"".join(ascii_e) + b"\\" + tail,  # a '\' before the separator
        b"".join(ascii_e) + b"7|\\" + b"\n" + b"\x02\x00",  # the separator inside an entry
    ]
    return out


def _batch(pieces: list[bytes], lead: int) -> tuple[bytes, np.ndarray, np.ndarray]:
    """The pieces as a container body after ``lead`` bytes: (data, starts, sizes)."""
    sizes = np.array([len(p) for p in pieces], dtype=np.int64)
    starts = lead + np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return b"\x5c" * lead + b"".join(pieces) + b"\\\n", starts, sizes


def _check_read(pieces: list[bytes], lead: int = 5) -> tuple[int, int]:
    """Hold the native read of a batch against _python_read_headers, field by field -> (card blocks, host
    blocks)."""
    data, starts, sizes = _batch(pieces, lead)
    got = native.huffman_read_headers(data, starts, sizes, int(starts[0]))
    want = _python_read_headers(data, starts, sizes, int(starts[0]))
    for name in native.ReadHeaders._fields:
        a, w = getattr(got, name), getattr(want, name)
        assert a.dtype == w.dtype, name
        bad = np.nonzero((a != w).reshape(len(pieces), -1).any(1))[0]
        assert not bad.size, (name, pieces[bad[0]])
    card = int(want.taken.sum())
    return card, len(pieces) - card


@pytest.mark.parametrize("seed", range(4))
def test_read_headers_equal_the_python_read_on_well_formed_blocks(seed):
    r = random.Random(2000 + seed)
    card, host = _check_read([_well_formed(r) for _ in range(60)])
    assert card and host


@pytest.mark.parametrize("seed, kind", [(0, "ascii"), (1, "raw"), (2, "rune"), (3, "ascii"), (4, "raw")])
def test_read_headers_equal_the_python_read_on_every_cut(seed, kind):
    r = random.Random(3000 + seed)
    blk = _well_formed(r, kind)
    card, host = _check_read([blk[:k] for k in range(len(blk) + 1)], lead=seed)
    assert host and (card == 0 if kind == "rune" else card)


@pytest.mark.parametrize("seed", range(3))
def test_read_headers_equal_the_python_read_on_malformed_headers(seed):
    r = random.Random(4000 + seed)
    pieces = _malformed(r)
    card, host = _check_read(pieces)
    assert card and host
    # and each malformed header cut at every position
    _check_read([p[:k] for p in pieces for k in range(0, len(p) + 1, 3)])


def test_read_headers_fuzzed_bytes():
    r = random.Random(5000)
    alphabet = b"0123456789||||\\\\nnab\n\xff\xc3\xa9\xef\xbf\xbd\x80"
    pieces = [bytes(r.choice(alphabet) for _ in range(r.randint(0, 40))) for _ in range(400)]
    _check_read(pieces, lead=0)


def test_read_headers_leave_blocks_outside_the_data():
    data = b"2|a3|b\\\n\x00\xff"
    got = native.huffman_read_headers(data, np.array([0, 0, 2, -1]), np.array([len(data), len(data) + 1, 8, 3]), 0)
    assert got.taken.tolist() == [True, False, False, False]


# ---------------------------------------------------------------------------
# Containers


def _inputs() -> dict[str, bytes]:
    r = np.random.default_rng(24)
    text = corpus._prose(3000, 1) + corpus._html(3000, 2) + corpus._csrc(2500, 3)
    return {
        "text": text,
        "lt": corpus._html(2500, 4) + b"a <b> c" * 300,
        "non_utf8": text[:2000] + bytes(r.integers(0, 256, 1500, dtype=np.uint8)) + b"abc\xffabd" * 200,
        "utf8": text[:1500] + "naïve résumé — ünïcödé ".encode() * 120 + text[:900],
        "mixed": text[:1200] + "ünï".encode() * 300 + b"x\xc3\xffz" * 300 + text[-1200:],
    }


def _python_path(monkeypatch):
    monkeypatch.setattr(huffman_blocks, "code_tables", _python_code_tables)
    monkeypatch.setattr(native, "huffman_read_headers", _python_read_headers)


def _outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except (ValueError, OverflowError) as e:
        return type(e), str(e)


@pytest.mark.parametrize("algs", [HUFF, LZ_HUFF])
@pytest.mark.parametrize("name", sorted(_inputs()))
def test_containers_equal_the_python_path_and_round_trip(algs, name, monkeypatch):
    data = _inputs()[name]
    huffman_blocks.reset_host_split()
    huffman_blocks.reset_native_headers()
    c = blocks.compress_container(data, algs, block_size=1024, device="cpu")
    enc_split, enc_native = dict(huffman_blocks.host_split), dict(huffman_blocks.native_headers)
    assert blocks.decompress_container(c, device="cpu") == data
    split, headers = dict(huffman_blocks.host_split), dict(huffman_blocks.native_headers)
    n_blocks = -(-len(data) // 1024)
    assert headers == {"encode": n_blocks - enc_split["encode"], "decode": n_blocks - split["decode"]}
    assert enc_native == {"encode": headers["encode"], "decode": 0}
    with monkeypatch.context() as m:
        _python_path(m)
        huffman_blocks.reset_host_split()
        huffman_blocks.reset_native_headers()
        assert blocks.compress_container(data, algs, block_size=1024, device="cpu") == c
        assert blocks.decompress_container(c, device="cpu") == data
        assert huffman_blocks.host_split == split
        assert huffman_blocks.native_headers == headers  # the reference loops take the same card blocks


def test_single_symbol_blocks_raise_as_the_python_path(monkeypatch):
    data = corpus._prose(1024, 5)[:1024] + b"a" * 1024 + corpus._prose(700, 6)
    c = blocks.compress_container(data, HUFF, block_size=1024, device="cpu")
    got = _outcome(blocks.decompress_container, c, device="cpu")
    with monkeypatch.context() as m:
        _python_path(m)
        assert blocks.compress_container(data, HUFF, block_size=1024, device="cpu") == c
        assert _outcome(blocks.decompress_container, c, device="cpu") == got
    assert got[0] is ValueError and "not decodable" in got[1]


CORRUPTIONS = {
    "no_separator": lambda p: p.replace(SEP, b"xx", 1),
    "no_pad_byte": lambda p: p.split(SEP, 1)[0] + SEP,
    "bar_last": lambda p: p.split(SEP, 1)[0] + b"|" + SEP + p.split(SEP, 1)[1],
    "zero_count": lambda p: b"0|\x01" + p,
    "one_symbol": lambda p: b"7|a" + SEP + p.split(SEP, 1)[1],
    "long_count": lambda p: b"123456789012345678901|\x01" + p,
    "count_past_int64": lambda p: b"18|\x0119999999999999999999|\x01" + p,
    "big_count": lambda p: b"1234567890123456789|\x01" + p,
    "count_past_bound": lambda p: b"%d|\x01" % (native.HUFFMAN_MAX_COUNT + 1) + p,
    "count_at_bound": lambda p: b"%d|\x01" % native.HUFFMAN_MAX_COUNT + p,
    "leading_zeros": lambda p: b"0000000000000000000000003|\x01" + p,
    "rune": lambda p: b"3|\xc3\xa9" + p,
    "stray": lambda p: b"3|\xfe" + p,
    "pad_byte": lambda p: p.split(SEP, 1)[0] + SEP + b"\x07" + p.split(SEP, 1)[1][1:],
}


@pytest.mark.parametrize("algs", [HUFF, LZ_HUFF])
@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_a_corrupt_header_decodes_or_raises_as_the_python_path(algs, corruption, monkeypatch):
    data = _inputs()["text"][:3000]
    c = blocks.compress_container(data, algs, block_size=1024, device="cpu")
    f_algs, bs, orig, payloads, aux, window = blocks.parse_container(c)
    payloads = list(payloads)
    payloads[1] = CORRUPTIONS[corruption](payloads[1])
    bad = blocks.assemble_container(payloads, aux, f_algs, bs, window, orig)
    huffman_blocks.reset_host_split()
    got = _outcome(blocks.decompress_container, bad, device="cpu")
    split = dict(huffman_blocks.host_split)
    with monkeypatch.context() as m:
        _python_path(m)
        huffman_blocks.reset_host_split()
        assert _outcome(blocks.decompress_container, bad, device="cpu") == got
        assert huffman_blocks.host_split == split
