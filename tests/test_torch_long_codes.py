"""Huffman codes past 32 bits in the port's stream, against the JAX package's stream and the oracle.

The JAX stream (``raisin_tpu.ops.huffman_jax``) packs codes of up to 256
bits (``_maxlen_bucket``) and walks a tree of any depth; its container stops
at 32 bits. The port's wide tables give each code 1, 2 or 8 words
(``huffman_blocks.wide_tables``), wide kernels G and H take them, and the
stream sends a tree with a code past 32 bits to them whatever its alphabet.
Held here, exactly (tolerance 0: bits, ids and bytes), on inputs made from
seeded numpy:

- the plain wide encode against ``huffman_jax._pack_codes`` bit for bit and
  the plain wide decode against ``huffman_jax._bitwalk_decode``, on crafted
  caterpillar trees whose longest codes have 33 to 256 bits and on the tree
  of ``chip_smoke.fibonacci_block(34)``'s counts (a 33-bit code);
- wide kernels G and H's own sources, built with g++ over
  ``tests/cuda_host/cuda_emu.h``, against the plain versions on those trees
  (kernel G at each code width it instantiates);
- crafted streams (headers of Fibonacci counts for 34, 70 and 260 leaves, a
  short payload, damaged copies) through the port's decompress against
  ``huffman_jax.decompress``;
- the raises: past 256 bits the JAX stream's message, and the containers'
  Huffman layers the JAX container's 32-bit message;
- the 14,930,351-byte ``fibonacci_block(34)`` stream end to end against
  ``huffman_ref.compress`` (marked slow: ~90 s and ~4 GiB on a CPU, most of
  it the plain decode walking its 39 M bits from every position).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from raisin_tpu.formats import huffman_ref
from raisin_tpu.ops import huffman_jax
from raisin_tpu.parallel import blocks as jax_blocks
from raisin_tpu_torch.formats import huffman as port_hf
from raisin_tpu_torch.ops import huffman_blocks, huffman_rows, huffman_stream
from raisin_tpu_torch.parallel import blocks as port_blocks
from tests.test_torch_runes import host_kernels  # noqa: F401  (a fixture: wide G and H built for the host)
from tests.go_heap import jax_heap_at_go_rule  # noqa: F401  (a fixture)

# the JAX oracle builds Go's Huffman tree here, as the port does (tests/go_heap.py)
pytestmark = pytest.mark.usefixtures("jax_heap_at_go_rule")

torch.set_num_threads(1)
CPU = "cpu"
DEPTHS = [33, 40, 64, 65, 128, 256]
TREES = [f"caterpillar {d}" for d in DEPTHS] + ["fibonacci 34"]


def _fib(n: int) -> list[int]:
    """Fib(1..n)."""
    fib = [1, 1]
    while len(fib) < n:
        fib.append(fib[-1] + fib[-2])
    return fib[:n]


@functools.cache
def _trees(name: str):
    """(the port's tree, huffman_ref's tree) of a case of TREES."""
    if name.startswith("caterpillar"):
        spec = chip_smoke.caterpillar(int(name.split()[1]))
        return chip_smoke.built_tree(spec, port_hf), chip_smoke.built_tree(spec, huffman_ref)
    freqs = dict(zip(range(65, 65 + 34), _fib(34)))  # fibonacci_block(34)'s counts
    return port_hf.build_tree(freqs), huffman_ref.build_tree(freqs)


def _jax_code_table(jtree):
    """The JAX stream's tables for a tree, as its compress builds them: (vals in the walk's order,
    code_bits (K + 1, maxlen) uint8 with a zero-length sentinel row, code_lens (K + 1,) int32)."""
    vals, bins = huffman_ref.print_codes(jtree)
    maxlen = huffman_jax._maxlen_bucket(max(len(b) for b in bins))
    code_bits = np.zeros((len(vals) + 1, maxlen), np.uint8)
    code_lens = np.zeros(len(vals) + 1, np.int32)
    for i, b in enumerate(bins):
        code_lens[i] = len(b)
        code_bits[i, : len(b)] = np.frombuffer(b.encode(), np.uint8) - ord("0")
    return vals, code_bits, code_lens


def _symbols(name: str, n: int = 1500) -> np.ndarray:
    """n seeded runes of a tree's alphabet, every code length among them."""
    t = huffman_blocks.wide_tables(_trees(name)[0])
    rng = np.random.default_rng(len(name))
    deep = t.vals[np.argsort(t.code_lens)[-8:]]  # the longest codes, so that they occur
    return np.concatenate([deep, rng.choice(t.vals, n - len(deep))])


def _port_encode(name: str, runes: np.ndarray):
    """The port's plain wide encode of a rune sequence: (tables, ids, rows, byte_lens, pads) as numpy."""
    t = huffman_blocks.wide_tables(_trees(name)[0])
    ids = np.searchsorted(t.vals, runes).astype(np.int32)[None]
    lengths = np.array([ids.shape[1]], np.int32)
    capw = -(-int(t.code_lens[ids[0]].sum()) // 32)
    rows, bl, pads = huffman_rows.encode_rows_wide(
        *(torch.from_numpy(a) for a in (ids, lengths, t.codes, t.code_lens)), capw)
    return t, ids, rows.numpy(), bl.numpy(), pads.numpy()


@pytest.mark.parametrize("name", TREES)
def test_wide_tables_take_the_codes_words(name):
    t = huffman_blocks.wide_tables(_trees(name)[0])
    vals, bins = huffman_ref.print_codes(_trees(name)[1])
    order = np.argsort(vals)
    assert t.longest == max(map(len, bins)) == (int(name.split()[1]) if name.startswith("cat") else 33)
    assert t.codes.shape == (len(vals), {33: 2, 40: 2, 64: 2}.get(t.longest, 8))
    bits = ["".join(format(int(w) & 0xFFFFFFFF, "032b") for w in row) for row in t.codes]
    assert [b[:n] for b, n in zip(bits, t.code_lens)] == [bins[i] for i in order]
    assert all(set(b[n:]) <= {"0"} for b, n in zip(bits, t.code_lens))  # left-aligned, zeros after


@pytest.mark.parametrize("name", TREES)
def test_plain_wide_encode_equals_jax_pack_codes(name):
    runes = _symbols(name)
    t, ids, rows, bl, pads = _port_encode(name, runes)
    vals, code_bits, code_lens = _jax_code_table(_trees(name)[1])
    at = {v: i for i, v in enumerate(vals)}
    jids = np.full(huffman_jax._bucket(len(runes)), len(vals), np.int32)  # the sentinel pads
    jids[: len(runes)] = [at[r] for r in runes.tolist()]
    max_bits = huffman_jax._bucket(code_bits.shape[1] * len(runes) + 8)
    want, total = huffman_jax._pack_codes(jids, code_bits, code_lens, max_bits)
    got = np.unpackbits(rows[0, : bl[0]])[pads[0] :]
    assert int(total) == got.size == int(t.code_lens[ids[0]].sum())
    assert np.array_equal(got, np.asarray(want)[: int(total)])


@pytest.mark.parametrize("name", TREES)
@pytest.mark.parametrize("cut", [0, 1])
def test_plain_wide_decode_equals_jax_bitwalk(name, cut):
    """The payload whole and cut by its last byte (a walk that may end inside a code)."""
    runes = _symbols(name)
    t, ids, rows, bl, pads = _port_encode(name, runes)
    bl = bl - cut
    out, counts, ok = (a.numpy() for a in huffman_rows.decode_rows_wide(
        *(torch.from_numpy(a) for a in (rows, pads, bl, t.children)), t.lattice, len(runes) + 8, t.longest))
    left, right, leaf, vals = huffman_jax._tree_arrays(_trees(name)[1])
    bits = np.unpackbits(rows[0, : bl[0]])[pads[0] :]
    S = huffman_jax._bucket(bits.size)
    padded = np.zeros(S, np.uint8)
    padded[: bits.size] = bits
    syms, count, jok = huffman_jax._bitwalk_decode(padded, np.int32(bits.size), left, right, leaf,
                                                   S // huffman_jax.TILE)
    syms = np.asarray(syms)
    want = np.asarray(vals)[syms[syms >= 0]]
    assert counts[0] == int(count) and bool(ok[0]) == bool(jok) == (cut == 0)
    assert np.array_equal(t.vals[out[0, : counts[0]]], want)
    if not cut:
        assert np.array_equal(want, runes)


@pytest.mark.parametrize("name", TREES)
def test_wide_kernel_sources_on_host_take_long_codes(host_kernels, name):  # noqa: F811
    """Wide G (1, 2 or 8 words a code, a tile of TILE / W symbols) and wide H (walks past its 11-bit table to
    the tree's depth) from their sources, built for the host, against the plain versions."""
    encode, decode = host_kernels
    runes = np.concatenate([_symbols(name, 3000), _symbols(name, 1700)])
    t, ids, rows, bl, pads = _port_encode(name, runes)
    bits = np.array([int(t.code_lens[ids[0]].sum())], np.int64)
    got = encode(ids, np.array([ids.shape[1]], np.int32), t, rows.shape[1] // 4, bits)
    for g, w in zip(got, (rows, bl, pads)):
        assert np.array_equal(g, w)
    assert huffman_rows.tiles(ids.shape[1], t.codes.shape[1]) > 1  # several tiles, each after a look-back
    cap = ids.shape[1] + 8
    want = huffman_rows.decode_rows_wide(*(torch.from_numpy(a) for a in (rows, pads, bl, t.children)), t.lattice,
                                         cap, t.longest)
    for g, w in zip(decode(rows, pads, bl, t, cap), want):
        assert np.array_equal(g, w.numpy())


# ---------------------------------------------------------------------------
# Crafted streams: the decode of trees that no input of a sane size has


def _crafted_stream(leaves: int) -> bytes:
    """A stream whose header gives ``leaves`` runes the counts Fib(1..leaves) (ASCII runes up to 70 leaves,
    runes >= 0x100 past that) and whose payload codes 40 seeded runes of it, the deepest among them."""
    first = 65 if leaves <= 34 else 40 if leaves <= 70 else 0x100
    freqs = dict(zip(range(first, first + leaves), _fib(leaves)))
    vals, bins = huffman_ref.print_codes(huffman_ref.build_tree(freqs))
    code = dict(zip(vals, bins))
    rng = np.random.default_rng(leaves)
    picks = [first, first + 1] + rng.choice(np.arange(first, first + leaves), 38).tolist()
    bits = "".join(code[r] for r in picks)
    pad = (8 - len(bits) % 8) % 8
    payload = int("0" * pad + bits, 2).to_bytes((pad + len(bits)) // 8, "big")
    return huffman_ref.build_header(freqs) + huffman_ref.SEPARATOR + bytes([pad]) + payload


def _outcome(fn, data: bytes):
    try:
        return fn(data)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("leaves", [34, 70, 260])
def test_crafted_stream_decodes_as_jax_does(leaves):
    comp = _crafted_stream(leaves)
    at = comp.index(huffman_ref.SEPARATOR) + len(huffman_ref.SEPARATOR)  # the pad byte
    tree = port_hf.build_tree(port_hf.parse_header(comp[: at - len(huffman_ref.SEPARATOR)]))
    assert huffman_blocks.longest_code(tree) == leaves - 1
    cases = [comp, comp[:-1], comp[:-1] + bytes([comp[-1] ^ 0x96]), comp[:at] + bytes([(comp[at] + 5) % 8]) + comp[at + 1 :]]
    want = [_outcome(huffman_jax.decompress, c) for c in cases]
    assert isinstance(want[0], bytes) and want[0] == huffman_ref.decompress(comp)
    assert [_outcome(lambda d: huffman_stream.decompress(d, device=CPU), c) for c in cases] == want


# ---------------------------------------------------------------------------
# The raises


def test_codes_past_256_bits_raise_the_jax_stream_message():
    tree = chip_smoke.built_tree(chip_smoke.caterpillar(257, bush_levels=2), port_hf)
    with pytest.raises(ValueError, match="^huffman: code length beyond 256 bits$"):
        huffman_jax._maxlen_bucket(257)
    with pytest.raises(ValueError, match="^huffman: code length beyond 256 bits$"):
        huffman_blocks.wide_tables(tree)
    t = huffman_blocks.wide_tables(tree, codes=False)  # the decode's tables take any depth
    assert t.codes is None and t.longest == 257 and len(t.children) == 2 * (len(t.vals) - 1)


@functools.cache
def _fibonacci_34() -> bytes:
    return chip_smoke.fibonacci_block(34)


def test_container_huffman_layers_raise_the_jax_container_message():
    """A block with a 33-bit code: the containers' Huffman layers raise where the stream codes it."""
    data = _fibonacci_34()
    assert len(data) == 14_930_351 >= huffman_stream.LONG_CODE_SYMBOLS
    with pytest.raises(ValueError, match="^huffman: code length beyond 32 bits$"):
        jax_blocks.compress_container(data, ("huffman",), block_size=len(data))
    with pytest.raises(ValueError, match="^huffman: code length beyond 32 bits$"):
        port_blocks.compress_container(data, ("huffman",), block_size=len(data), device=CPU)


def test_stream_sends_long_codes_to_the_wide_kernels():
    """A code of L bits needs Fib(L + 2) symbols, so only a tree over LONG_CODE_SYMBOLS = Fib(35) symbols or
    more has one past 32 bits: Fib(1..33) (one symbol fewer) stops at 32, Fib(1..34) reaches 33."""
    fewer = port_hf.build_tree(dict(zip(range(65, 65 + 33), _fib(33))))
    assert fewer.freq == huffman_stream.LONG_CODE_SYMBOLS - 1
    assert huffman_blocks.longest_code(fewer) == 32 and not huffman_stream._long_codes(fewer)
    tree = _trees("fibonacci 34")[0]
    assert huffman_blocks.longest_code(tree) == 33 and huffman_stream._long_codes(tree)


@pytest.mark.parametrize("name", ["ascii", pytest.param("runes", marks=pytest.mark.slow)])
def test_chip_smoke_longcode_digests_are_the_oracles(name):
    """chip_smoke's ORACLE_LONGCODE, from the oracle (~7 s for the ASCII stream here, ~20 s for the runes)."""
    data = _fibonacci_34() if name == "ascii" else chip_smoke.fibonacci_runes(34)
    want = huffman_ref.compress(data)
    assert chip_smoke.ORACLE_LONGCODE[name] == (chip_smoke.sha(data), len(want), chip_smoke.sha(want))


@pytest.mark.slow
def test_fibonacci_34_stream_round_trip_equals_the_oracle():
    data = _fibonacci_34()
    comp = huffman_stream.compress(data, device=CPU)
    assert comp == huffman_ref.compress(data)
    assert huffman_stream.decompress(comp, device=CPU) == data
