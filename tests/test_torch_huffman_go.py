"""The port's Huffman layer against Go's rules: the benchmark's plain reference, Go's heap, and the JAX
package where its tree is not Go's.

``perfbench/reference/huffman.py`` is written from
compressor/huffman/huffman.go and shares no code with the port or the JAX
package. The port's ``lzss,huffman`` container (the plain versions of
kernels D, E, G and H on the CPU) and its format copy
(``formats/huffman.py``) must give the reference's bytes, Go's where a
block's input is valid UTF-8 and byte-coded elsewhere, and decode them
back to the input. The JAX
package's oracle, unpatched here, computes the heap's parent at the root as
-1 (``raisin_tpu/formats/huffman_ref.py``) and builds another tree wherever
that swap happens: its bytes differ from the port's there, and each decodes
the other's only where the trees agree. Every comparison is exact.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import pytest

import chip_smoke
from perfbench import corpus
from perfbench.reference import compress_pipeline, rsnb
from perfbench.reference import huffman as ref
from raisin_tpu.formats import huffman_ref, lzss_ref
from raisin_tpu_torch import native
from raisin_tpu_torch.formats import huffman as port_hf
from raisin_tpu_torch.ops import huffman_blocks
from raisin_tpu_torch.parallel import blocks
from tests.fixtures import UNICODE_TEXT

LZ_HUFF = ("lzss", "huffman")
BLOCK = 9000
WINDOW = 4096
# perfbench/tests/test_perfbench_reference.py's edge cases
_rng = np.random.default_rng(3)
EDGES = [b"a", b"<<<\\\\\xff\xff<\\", b"abcabcabcabcabcabcabcabc" * 40, bytes(_rng.integers(0, 256, 3000, dtype=np.uint8)),
         corpus._prose(3000, 3), corpus._html(2000, 4) + corpus._man(1000, 5), bytes(3000), corpus._xls(4000, 2),
         b"ab" * 1500]


def _codes(tree_module, freqs: dict[int, int]) -> dict[int, str]:
    return dict(zip(*tree_module.print_codes(tree_module.build_tree(freqs))))


def _small_table(r: random.Random) -> bytes:
    """2-12 ASCII symbols with counts 1-20, shuffled."""
    symbols = r.sample(range(32, 127), r.randint(2, 12))
    data = bytearray(b"".join(bytes([s]) * r.randint(1, 20) for s in symbols))
    r.shuffle(data)
    return bytes(data)


@functools.cache
def _text() -> bytes:
    """Five blocks of text, the last one ragged; the html and C blocks hold '<', which the LZSS escape
    writes as 0xFF, so that their token streams are byte-coded."""
    return (corpus._prose(12000, 11) + corpus._html(9000, 15) + corpus._man(10000, 12) + corpus._csrc(9000, 16)
            + corpus._poetry(4500, 14))


@functools.cache
def _reference_container() -> bytes:
    data = _text()
    streams, lengths = compress_pipeline([data[i : i + BLOCK] for i in range(0, len(data), BLOCK)], LZ_HUFF, WINDOW,
                                         "cpu")
    head = rsnb.header(LZ_HUFF, BLOCK, WINDOW, len(data), [len(s) for s in streams], [lengths[0]])
    return head + b"".join(streams)


def test_go_heap_stops_at_the_root():
    assert _codes(port_hf, {97: 1, 98: 1, 99: 5}) == {97: "00", 98: "01", 99: "1"}
    assert ref.codes([97, 98, 99], [1, 1, 5]) == {97: "00", 98: "01", 99: "1"}
    assert [ref._go_parent(j) for j in range(5)] == [0, 0, 0, 1, 1]


def test_container_equals_the_reference_payload_by_payload():
    data = _text()
    huffman_blocks.reset_host_split()
    port = blocks.compress_container(data, LZ_HUFF, BLOCK, window=WINDOW, device="cpu")
    blob = _reference_container()
    got, want = rsnb.parse(port), rsnb.parse(blob)
    assert huffman_blocks.host_split == {"encode": 0, "decode": 0}
    assert want["num_blocks"] == got["num_blocks"] == 5
    assert got["aux"][0].tolist() == want["aux"][0].tolist()
    assert got["sizes"].tolist() == want["sizes"].tolist()
    for b in range(5):
        assert rsnb.payload(port, got, b) == rsnb.payload(blob, want, b), b
    assert port == blob
    assert blocks.decompress_container(blob, device="cpu") == data
    assert huffman_blocks.host_split == {"encode": 0, "decode": 0}


def test_trees_count_a_block_each_way():
    data = _text()
    huffman_blocks.reset_trees()
    blob = blocks.compress_container(data, LZ_HUFF, BLOCK, window=WINDOW, device="cpu")
    assert huffman_blocks.trees == {"encode": 5, "decode": 0}
    assert blocks.decompress_container(blob, device="cpu") == data
    assert huffman_blocks.trees == {"encode": 5, "decode": 5}
    huffman_blocks.reset_trees()
    assert huffman_blocks.trees == {"encode": 0, "decode": 0}


def test_a_block_with_lt_is_byte_coded_on_the_card_and_round_trips():
    """'<' escapes to 0xFF, which Go's rune iteration reads as U+FFFD, so Go's stream of the block
    decodes to other token bytes. The port codes it over its bytes, on the card, as the reference
    does: Go's tree, codes and bits, with the raw 0xFF in the header where Go writes U+FFFD."""
    data = corpus._html(6000, 21)
    streams, lengths = compress_pipeline([data], LZ_HUFF, WINDOW, "cpu")
    huffman_blocks.reset_host_split()
    blob = blocks.compress_container(data, LZ_HUFF, BLOCK, window=WINDOW, device="cpu")
    f = rsnb.parse(blob)
    payload = rsnb.payload(blob, f, 0)
    assert payload == streams[0] and f["aux"][0].tolist() == lengths[0]
    assert huffman_blocks.host_split == {"encode": 0, "decode": 0}
    head, body = payload.split(port_hf.SEPARATOR, 1)
    tokens = lzss_ref.compress(data, WINDOW)
    assert head.replace(b"|\xff", b"|\xef\xbf\xbd") + port_hf.SEPARATOR + body == port_hf.compress(tokens)
    go = port_hf.compress(tokens)
    with pytest.raises(ValueError, match="token bytes, its aux table says"):  # Go's stream loses the '<'
        blocks.decompress_container(rsnb.header(LZ_HUFF, BLOCK, WINDOW, len(data), [len(go)], [lengths[0]]) + go,
                                    device="cpu")
    huffman_blocks.reset_host_split()
    assert blocks.decompress_container(blob, device="cpu") == data
    assert huffman_blocks.host_split == {"encode": 0, "decode": 0}


# ASCII with one stray byte; stray bytes beside a valid sequence; 200 symbols (no free ASCII id: the oracle)
BYTE_CODED = [b"abc\xffabd\xff" * 50, "é".encode() * 40 + b"\xc3\xffz" * 30, bytes(range(200)) * 3]


@pytest.mark.parametrize("case", range(len(BYTE_CODED)))
def test_byte_coded_blocks_equal_the_reference_and_round_trip(case):
    data = BYTE_CODED[case]
    huffman_blocks.reset_host_split()
    blob = blocks.compress_container(data, ("huffman",), BLOCK, device="cpu")
    f = rsnb.parse(blob)
    assert rsnb.payload(blob, f, 0) == ref.compress(data) == port_hf.compress_block(data)
    assert blocks.decompress_container(blob, device="cpu") == data
    assert port_hf.decompress_block(ref.compress(data)) == data
    host = int(case == 2)
    assert huffman_blocks.host_split == {"encode": host, "decode": host}


def test_valid_utf8_blocks_stay_go_streams():
    data = UNICODE_TEXT * 20
    blob = blocks.compress_container(data, ("huffman",), BLOCK, device="cpu")
    f = rsnb.parse(blob)
    assert rsnb.payload(blob, f, 0) == port_hf.compress(data) == ref.compress(data)
    assert port_hf.read_header(port_hf.compress(data).split(port_hf.SEPARATOR)[0]) == (
        port_hf.parse_header(port_hf.compress(data).split(port_hf.SEPARATOR)[0]), False)


def test_read_header_tells_byte_coded_headers_by_their_stray_bytes():
    assert port_hf.read_header(b"3|a2|\xef\xbf\xbd") == ({97: 3, 0xFFFD: 2}, False)
    assert port_hf.read_header(b"3|a2|\xff") == ({97: 3, 0xFF: 2}, True)
    assert port_hf.read_header(b"1|\xc31|\xa92|\\n") == ({0xC3: 1, 0xA9: 1, 10: 2}, True)
    assert port_hf.parse_header(b"3|a2|\xff") == {97: 3, 0xFFFD: 2}  # Go's reading


def _with_ids(tree, ids):
    """The tree with each leaf's symbol replaced by its id."""
    if isinstance(tree, port_hf.Leaf):
        return port_hf.Leaf(tree.freq, int(ids[tree.value]))
    return port_hf.Node(tree.freq, _with_ids(tree.left, ids), _with_ids(tree.right, ids))


def test_native_trees_are_the_formats_trees():
    """The container's batch of trees in C against ``formats/huffman.build_tree``, on 1500 tables of 1-256
    symbols with many ties: every code, length, depth and child table."""
    r = random.Random(2027)
    counts = np.zeros((1500, 256), dtype=np.int64)
    ids = np.tile(np.arange(256, dtype=np.uint8), (1500, 1))
    for b in range(1500):
        syms = r.sample(range(256), r.choice([1, 2, 3, r.randint(2, 20), r.randint(2, 128), r.randint(100, 256)]))
        counts[b, syms] = [r.choice([1, 1, 2, 3, 5, r.randint(1, 50), r.randint(1, 10**9)]) for _ in syms]
        if r.random() < 0.5 and huffman_blocks.ascii_ids(syms) is not None:
            ids[b] = huffman_blocks.ascii_ids(syms)
    codes, lens, tables, longest = native.huffman_trees(counts, ids)
    for b in range(1500):
        syms = np.nonzero(counts[b])[0]
        tree = port_hf.build_tree(dict(zip(syms.tolist(), counts[b, syms].tolist())))
        vals, bins = port_hf.print_codes(tree)
        ls = [len(c) for c in bins]
        assert longest[b] == max(ls)
        assert lens[b, vals].tolist() == ls and lens[b].sum() == sum(ls)
        assert [int(c) for c, n in zip(codes[b, vals], ls) if n <= 32] == [int(c or "0", 2) for c in bins if len(c) <= 32]
        want = None if isinstance(tree, port_hf.Leaf) else huffman_blocks.packed_table(_with_ids(tree, ids[b]))
        assert tables[b].tolist() == (want.tolist() if want is not None else [0] * 64)
    assert native.huffman_trees(np.zeros((1, 256), np.int64), ids[:1])[3].tolist() == [-1]


def test_ascii_ids_take_free_values_from_the_top_never_zero():
    ids = huffman_blocks.ascii_ids([0, 97, 127, 0xC3, 0xFF])
    assert (ids[0xC3], ids[0xFF], ids[97], ids[0]) == (126, 125, 97, 0)
    assert huffman_blocks.ascii_ids(list(range(1, 127)) + [0xFF]) is not None
    assert huffman_blocks.ascii_ids(list(range(1, 128)) + [0xFF]) is None


@pytest.mark.parametrize("case", range(len(EDGES)))
def test_format_equals_the_reference_on_the_edge_cases(case):
    assert port_hf.compress_block(EDGES[case]) == ref.compress(EDGES[case])


def test_empty_input_raises_in_both():
    with pytest.raises(ValueError):
        port_hf.compress(b"")
    with pytest.raises(ValueError):
        ref.compress(b"")


@pytest.mark.parametrize("data", [UNICODE_TEXT, *chip_smoke.RUNE_EDGES, b"".join(chip_smoke.RUNE_EDGES)])
def test_format_equals_the_reference_on_runes(data):
    assert ref.runes(data).tolist() == port_hf.go_decode_runes(data)
    assert port_hf.compress_block(data) == ref.compress(data)
    if len(set(ref.runes(data).tolist()) if port_hf.go_lossless(data) else set(data)) > 1:  # else no code bits
        assert port_hf.decompress_block(ref.compress(data)) == data


def test_format_equals_the_reference_on_small_tables():
    r = random.Random(2026)
    for _ in range(200):
        data = _small_table(r)
        assert port_hf.compress(data) == ref.compress(data)
        assert port_hf.decompress(ref.compress(data)) == data


def test_jax_oracle_builds_another_tree_where_the_root_swaps():
    """The unpatched JAX oracle: its codes for {a: 1, b: 1, c: 5}, and the small tables on which its
    streams differ from the port's; each package decodes the other's only where they agree."""
    assert _codes(huffman_ref, {97: 1, 98: 1, 99: 5}) == {97: "10", 98: "11", 99: "0"}
    r = random.Random(2026)
    differ = 0
    for _ in range(200):
        data = _small_table(r)
        port, jax = port_hf.compress(data), huffman_ref.compress(data)
        if port == jax:
            assert huffman_ref.decompress(port) == data
            continue
        differ += 1
        assert _codes(port_hf, port_hf.parse_header(port.split(port_hf.SEPARATOR)[0])) != _codes(
            huffman_ref, huffman_ref.parse_header(jax.split(huffman_ref.SEPARATOR)[0]))
        try:
            crossed = port_hf.decompress(jax)
        except ValueError:
            crossed = None
        assert crossed != data
    assert differ == 72  # of these 200 tables
