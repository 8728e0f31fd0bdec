"""The Huffman stream's rune alphabet in the port, against the JAX package and the host oracle.

``raisin_tpu_torch.ops.runes`` (Go's rune iteration and its inverse on
tensors) is held against ``raisin_tpu.formats.huffman_ref``'s
``go_decode_runes`` and ``runes_to_utf8_np``; the port's stream
(``ops/huffman_stream.py`` with ``device="cpu"``: the plain versions of
wide kernels G and H) against ``raisin_tpu.ops.huffman_jax``, whose device
codec codes every rune with no decode cap; the plain wide encoder and
decoder against a per-symbol loop; and the wide kernels' own sources,
built with g++ over ``tests/cuda_host/cuda_emu.h``, against the plain
versions (both of kernel G's table homes). Outputs are bytes and integers,
so every comparison is exact (tolerance 0). Inputs come from seeded numpy,
the corpus and ``chip_smoke``'s runes-phase inputs.
"""

from __future__ import annotations

import functools
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from raisin_tpu.engine import core as jax_core
from raisin_tpu.formats import huffman_ref, lzss_ref
from raisin_tpu.ops import huffman_jax
from raisin_tpu.utils import corpus as jax_corpus
from raisin_tpu_torch.engine import core as port_core
from raisin_tpu_torch.formats import huffman as port_hf
from raisin_tpu_torch.ops import huffman_blocks, huffman_rows, huffman_stream, runes
from tests.fixtures import UNICODE_TEXT, random_bytes
from tests.test_torch_huffman_encode import _host_build
from tests.go_heap import jax_heap_at_go_rule  # noqa: F401  (a fixture)

# the JAX oracle builds Go's Huffman tree here, as the port does (tests/go_heap.py)
pytestmark = pytest.mark.usefixtures("jax_heap_at_go_rule")

torch.set_num_threads(1)
CPU = "cpu"


@functools.cache
def _fault() -> tuple[bytes, bytes]:
    """The 950,000-rune stream of chip_smoke's runes phase and its encoding by the JAX package."""
    data = chip_smoke.fault_stream()
    return data, huffman_jax.compress(data)


def test_stream_decodes_past_the_oracle_cap_like_jax():
    """Past 900,000 runes the oracle raises its parity cap; the port's device stream, like JAX's, decodes."""
    data, comp = _fault()
    assert len(huffman_ref.go_decode_runes(data)) == chip_smoke.RUNE_FAULT_RUNES > huffman_ref.MAX_DECODED_SYMBOLS
    with pytest.raises(ValueError, match="parity cap"):
        port_hf.decompress(comp)
    huffman_blocks.reset_host_split()
    assert huffman_stream.compress(data, device=CPU) == comp
    assert huffman_stream.decompress(comp, device=CPU) == huffman_jax.decompress(comp) == data
    assert huffman_blocks.host_split == {"encode": 0, "decode": 0}


def test_auto_order_decodes_past_the_cap_where_jax_raises():
    """Kept on purpose (ROADMAP Queue 3): the port's auto order tries the device first, the JAX package's
    the host oracle, so only the port's ``decompress_bytes(c, ["huffman"])`` gives the bytes back."""
    data, comp = _fault()
    assert port_core.decompress_bytes(comp, ["huffman"], device=CPU) == data
    with pytest.raises(ValueError, match="parity cap"):
        jax_core.decompress_bytes(comp, ["huffman"])


# ---------------------------------------------------------------------------
# Go's rune iteration and its inverse


def _runes(b: bytes) -> np.ndarray:
    return runes.decode(torch.from_numpy(np.frombuffer(b, np.uint8).copy())).numpy()


@pytest.mark.parametrize("i", range(len(chip_smoke.RUNE_EDGES)))
def test_rune_decode_equals_go_on_edges(i):
    edge = chip_smoke.RUNE_EDGES[i]
    for b in (edge, b"x" + edge, edge + b"\xc3\xa9", edge * 3):
        want = np.array(huffman_ref.go_decode_runes(b), np.int32)
        assert np.array_equal(_runes(b), want), b
        assert np.array_equal(huffman_ref.decode_runes_array(b), want)
        assert runes.encode_utf8(torch.from_numpy(want)).numpy().tobytes() == huffman_ref.runes_to_utf8_np(want)


@pytest.mark.parametrize("seed", range(4))
def test_rune_decode_equals_go_on_random_bytes(seed):
    rng = np.random.default_rng(seed)
    lead = np.array([0x00, 0x41, 0x7F, 0x80, 0x9F, 0xA0, 0xBF, 0xC0, 0xC2, 0xDF, 0xE0, 0xED, 0xEF, 0xF0, 0xF4, 0xF5,
                     0xFF], np.uint8)
    for b in (rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(), rng.choice(lead, 3000).tobytes(), b""):
        want = np.array(huffman_ref.go_decode_runes(b), np.int32)
        assert np.array_equal(_runes(b), want)
        assert runes.encode_utf8(torch.from_numpy(want)).numpy().tobytes() == huffman_ref.runes_to_utf8_np(want)


def test_utf8_of_runes_outside_unicode():
    r = np.array([0, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x10FFFF, 0xD800, 0xDFFF, -1, 0x110000], np.int32)
    assert runes.encode_utf8(torch.from_numpy(r)).numpy().tobytes() == huffman_ref.runes_to_utf8_np(r)


# ---------------------------------------------------------------------------
# The stream against the JAX device codec

CORPUS = jax_corpus.generate(scale=0.05)
STREAM_INPUTS = {
    "mixed-width utf-8": UNICODE_TEXT + "ünïcödé €uro 中文字 𝄞 🎉".encode() * 40,
    "random binary": random_bytes(5000, seed=161),
    "kennedy.xls": CORPUS["kennedy.xls"],
    "ptt5": CORPUS["ptt5"],
    "sum": CORPUS["sum"],
    "lzss escapes": lzss_ref.compress(CORPUS["cp.html"]),
    "one rune twice": "é".encode() * 2,
    "edges": b"".join(chip_smoke.RUNE_EDGES),
}


@pytest.mark.parametrize("name", STREAM_INPUTS)
def test_stream_equals_jax(name):
    data = STREAM_INPUTS[name]
    huffman_blocks.reset_host_split()
    got = huffman_stream.compress(data, device=CPU)
    want = huffman_jax.compress(data)
    assert got == want == huffman_ref.compress(data)
    if name == "one rune twice":
        for decode in (huffman_jax.decompress, lambda c: huffman_stream.decompress(c, device=CPU)):
            with pytest.raises(ValueError, match="single-symbol stream is not decodable"):
                decode(got)
    else:  # each package decodes the other's stream (the bytes are equal, so one decode each)
        assert huffman_stream.decompress(want, device=CPU) == huffman_jax.decompress(got)
        assert huffman_stream.decompress(want, device=CPU) == huffman_ref.decompress(want)
    assert huffman_blocks.host_split == {"encode": 0, "decode": 0}


def _outcome(decode, data: bytes):
    try:
        return decode(data)
    except ValueError as e:
        return str(e)


def test_stream_decode_of_damaged_streams_equals_jax():
    """Cut and damaged streams give the JAX device codec's bytes or its error message."""
    comp = huffman_jax.compress(STREAM_INPUTS["mixed-width utf-8"])
    at = comp.index(port_hf.SEPARATOR) + len(port_hf.SEPARATOR)  # the pad byte
    cases = [comp[: at - 1], comp[:at], comp[:-1], comp[:-3], comp[:at] + bytes([(comp[at] + 3) % 8]) + comp[at + 1 :],
             comp[:-1] + bytes([comp[-1] ^ 0x5A]), comp[:at] + b"\x07", "3|é\\\n\x00".encode(), b"no separator"]
    for c in cases:
        assert _outcome(lambda d: huffman_stream.decompress(d, device=CPU), c) == _outcome(huffman_jax.decompress, c)


# ---------------------------------------------------------------------------
# The wide tables and the plain wide kernels against per-symbol loops


def _tables(data: bytes):
    r = np.array(huffman_ref.go_decode_runes(data), np.int64)
    vals, ids, counts = np.unique(r, return_inverse=True, return_counts=True)
    tree = port_hf.build_tree(dict(zip(vals.tolist(), counts.tolist())))
    return ids.astype(np.int32), huffman_blocks.wide_tables(tree), tree


def _code(t, i: int) -> str:
    """Id i's code in the wide table t, as the oracle's string of bits."""
    return "".join(format(int(w) & 0xFFFFFFFF, "032b") for w in t.codes[i])[: t.code_lens[i]]


def test_wide_tables_are_the_oracles_codes():
    ids, t, tree = _tables(STREAM_INPUTS["kennedy.xls"])
    vals, bins = port_hf.print_codes(tree)
    order = np.argsort(vals)
    assert np.array_equal(t.vals, np.array(vals)[order])
    assert t.codes.shape == (len(vals), 1) and t.longest == max(map(len, bins))
    assert [_code(t, i) for i in range(len(vals))] == [bins[i] for i in order]
    assert t.lattice == np.gcd.reduce(t.code_lens) and len(t.children) == 2 * (len(vals) - 1)


def test_wide_tables_raise_past_32_bits():
    """The container's tables raise past 32 bits, as the JAX container's do; the stream's wide tables give
    such a code two words (tests/test_torch_long_codes.py holds them up to 256 bits)."""
    fib = [1, 1]
    while len(fib) < 35:
        fib.append(fib[-1] + fib[-2])
    tree = port_hf.build_tree({0x100 + i: f for i, f in enumerate(fib)})
    t = huffman_blocks.wide_tables(tree)
    assert t.longest == 34 and t.codes.shape == (35, 2)
    counts = np.zeros((1, 256), np.int64)
    counts[0, 40 : 40 + 35] = fib
    with pytest.raises(ValueError, match="^huffman: code length beyond 32 bits$"):
        huffman_blocks.code_tables(counts)


def _loop_encode(ids, lengths, t) -> list[bytes]:
    out = []
    for row, n in zip(ids, lengths):
        bits = "".join(_code(t, i) for i in row[:n] if 0 <= i < len(t.codes))
        pad = (8 - len(bits) % 8) % 8
        out.append(bytes([pad]) + int("0" * pad + bits or "0", 2).to_bytes((pad + len(bits)) // 8, "big"))
    return out


def _loop_decode(payload: bytes, pad: int, t) -> tuple[list[int], bool]:
    bits = "".join(format(b, "08b") for b in payload)[pad:]
    out, node = [], 0
    for bit in bits:
        ch = int(t.children[2 * node + int(bit)]) & 0xFFFFFFFF
        if ch & huffman_rows.LEAF:
            out.append(ch & ~huffman_rows.LEAF)
            node = 0
        else:
            node = ch
    return out, node == 0


def _wide_case(name: str):
    """(ids (B, S) int32, lengths (B,) int32, tables): rows of one tree's ids."""
    rng = np.random.default_rng(len(name))
    if name == "edges":
        rows = [_runes(e) for e in chip_smoke.RUNE_EDGES]
    elif name == "past the shared table":
        rows = [_runes(chip_smoke.wide_alphabet_stream(huffman_rows.WIDE_TABLE + 900, seed=7))]
    elif name == "long codes":  # Fibonacci counts: codes up to 24 bits, past the decoder's table
        rows = [rng.choice(np.arange(0x4E00, 0x4E00 + 25), 9000), np.arange(0x4E00, 0x4E00 + 25)]
    else:  # the corpus' binary files, several tiles and a short row
        rows = [_runes(CORPUS["kennedy.xls"]), _runes(CORPUS["ptt5"]), _runes(CORPUS["sum"])[:77]]
    alphabet = np.unique(np.concatenate(rows)).tolist()
    if name == "long codes":
        fib = [1, 1]
        while len(fib) < len(alphabet):
            fib.append(fib[-1] + fib[-2])
        freqs = dict(zip(alphabet, fib))
    else:
        freqs = {v: 1 + int(rng.integers(0, 50)) for v in alphabet}
    t = huffman_blocks.wide_tables(port_hf.build_tree(freqs))
    lengths = np.array([len(r) for r in rows], np.int32)
    ids = np.full((len(rows), int(lengths.max())), -1, np.int32)
    for b, r in enumerate(rows):
        ids[b, : len(r)] = np.searchsorted(t.vals, r)
    return ids, lengths, t


WIDE_CASES = ["edges", "past the shared table", "long codes", "corpus"]


def _plain_encode(ids, lengths, t, capw):
    rows, bl, pads = huffman_rows.encode_rows_wide(*(torch.from_numpy(a) for a in (ids, lengths, t.codes, t.code_lens)),
                                                   capw)
    return rows.numpy(), bl.numpy(), pads.numpy()


def _capw(ids, lengths, t) -> int:
    return max(1, -(-int(max(sum(int(t.code_lens[i]) for i in r[:n]) for r, n in zip(ids, lengths))) // 32))


@pytest.mark.parametrize("name", WIDE_CASES)
def test_plain_wide_encode_and_decode_equal_symbol_loops(name):
    ids, lengths, t = _wide_case(name)
    capw = _capw(ids, lengths, t)
    rows, bl, pads = _plain_encode(ids, lengths, t, capw)
    for b, want in enumerate(_loop_encode(ids, lengths, t)):
        assert bytes([pads[b]]) + rows[b, : bl[b]].tobytes() == want
    out, counts, ok = (a.numpy() for a in huffman_rows.decode_rows_wide(
        torch.from_numpy(rows), torch.from_numpy(pads), torch.from_numpy(bl), torch.from_numpy(t.children), t.lattice,
        int(ids.shape[1]) + 8, t.longest))
    for b in range(len(ids)):
        loop, at_root = _loop_decode(rows[b, : bl[b]].tobytes(), int(pads[b]), t)
        assert ok[b] == at_root == 1 and counts[b] == len(loop) == lengths[b]
        assert np.array_equal(out[b, : counts[b]], loop) and np.array_equal(loop, ids[b, : lengths[b]])


def test_plain_wide_encode_skips_ids_outside_the_table():
    ids, lengths, t = _wide_case("edges")
    odd = ids.copy()
    odd[:, 0] = len(t.codes)  # no code: adds no bits
    capw = _capw(ids, lengths, t)
    got = _plain_encode(odd[:, 1:], lengths - 1, t, capw)
    want = _plain_encode(odd, lengths, t, capw)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# The wide kernels' own sources on the host

ENCODE_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {  // B S capw K W in out: ids, lengths, codes, code_lens, bits -> rows, byte_lens, pads
    const int B = atoi(argv[1]), S = atoi(argv[2]), capw = atoi(argv[3]), K = atoi(argv[4]), W = atoi(argv[5]);
    const size_t guard = 64;  // words after the rows that no store may touch
    std::vector<int32_t> x((size_t)B * S + 4), lens(B), codes((size_t)K * W), code_lens(K), byte_lens(B, -1),
        pads(B, -1);
    std::vector<long long> bits(B), totals(B, -1);
    std::vector<uint32_t> rows((size_t)B * capw + guard, 0);
    for (size_t i = (size_t)B * capw; i < rows.size(); ++i) rows[i] = 0xA5A5A5A5u;
    FILE* f = fopen(argv[6], "rb");
    if (fread(x.data(), 4, (size_t)B * S, f) + fread(lens.data(), 4, B, f) + fread(codes.data(), 4, codes.size(), f) +
            fread(code_lens.data(), 4, K, f) + fread(bits.data(), 8, B, f) !=
        (size_t)B * S + 2 * B + codes.size() + K)
        return 1;
    fclose(f);
    const int tile = TILE / W;
    const int tiles = S > 0 ? (S + tile - 1) / tile : 1;
    std::vector<unsigned long long> work((size_t)B * tiles + 1, 0);
    const int rc = rsn_huffman_encode_wide(x.data(), lens.data(), codes.data(), code_lens.data(), bits.data(),
                                           rows.data(), byte_lens.data(), pads.data(), totals.data(), work.data(), B,
                                           S, capw, K, W, nullptr);
    f = fopen(argv[7], "wb");
    fwrite(rows.data(), 4, (size_t)B * capw, f);
    fwrite(byte_lens.data(), 4, B, f);
    fwrite(pads.data(), 4, B, f);
    fclose(f);
    for (size_t i = (size_t)B * capw; i < rows.size(); ++i)
        if (rows[i] != 0xA5A5A5A5u) return 3;  // a store past the last row
    return rc;
}
"""

DECODE_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {  // B capb cap n_children lattice depth in out: rows, pads, byte_lens, children -> ids, counts, ok
    const int B = atoi(argv[1]), capb = atoi(argv[2]), cap = atoi(argv[3]), nc = atoi(argv[4]), lattice = atoi(argv[5]);
    const int depth = atoi(argv[6]);
    const size_t guard = 64;  // ids after the rows that no store may touch
    std::vector<uint8_t> payload((size_t)B * capb);
    std::vector<int32_t> pads(B), lens(B), children(nc), ids((size_t)B * cap + guard, 0), counts(B, -1), ok(B, -1);
    for (size_t i = (size_t)B * cap; i < ids.size(); ++i) ids[i] = 0x5A5A5A5A;
    FILE* f = fopen(argv[7], "rb");
    if (fread(payload.data(), 1, payload.size(), f) + fread(pads.data(), 4, B, f) + fread(lens.data(), 4, B, f) +
            fread(children.data(), 4, nc, f) != payload.size() + 2 * B + nc)
        return 1;
    fclose(f);
    const long long subs = (8LL * capb + SUB_BITS - 1) / SUB_BITS;
    const long long spans = std::max(1LL, (subs + SPAN_SUBS - 1) / SPAN_SUBS);
    std::vector<uint32_t> work(4 * (size_t)B * spans * SPAN_SUBS + (1 << LUT_BITS_WIDE));
    const int rc = rsn_huffman_decode_wide(payload.data(), pads.data(), lens.data(), children.data(), ids.data(),
                                           counts.data(), ok.data(), work.data(), B, capb, cap, lattice, depth, nullptr);
    f = fopen(argv[8], "wb");
    fwrite(ids.data(), 4, (size_t)B * cap, f);
    fwrite(counts.data(), 4, B, f);
    fwrite(ok.data(), 4, B, f);
    fclose(f);
    for (size_t i = (size_t)B * cap; i < ids.size(); ++i)
        if (ids[i] != 0x5A5A5A5A) return 3;  // a store past the last row
    return rc;
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """Functions running wide kernels G and H from their sources, built for the CPU, on numpy rows."""
    tmp = tmp_path_factory.mktemp("huffman_wide_host")
    enc, dec = _host_build(tmp, "huffman_encode", ENCODE_MAIN), _host_build(tmp, "huffman_decode", DECODE_MAIN)

    def encode(ids, lengths, t, capw, bits):
        B, S = ids.shape
        inp, out = tmp / "enc_in.bin", tmp / "enc_out.bin"
        inp.write_bytes(b"".join(np.ascontiguousarray(a, dt).tobytes() for a, dt in (
            (ids, np.int32), (lengths, np.int32), (t.codes, np.int32), (t.code_lens, np.int32), (bits, np.int64))))
        subprocess.run([str(enc), str(B), str(S), str(capw), *map(str, t.codes.shape), str(inp), str(out)], check=True)
        r = out.read_bytes()
        n = 4 * B * capw
        return (np.frombuffer(r[:n], np.uint8).reshape(B, 4 * capw), np.frombuffer(r[n : n + 4 * B], np.int32),
                np.frombuffer(r[n + 4 * B :], np.int32))

    def decode(rows, pads, byte_lens, t, cap):
        B, capb = rows.shape
        inp, out = tmp / "dec_in.bin", tmp / "dec_out.bin"
        inp.write_bytes(b"".join(np.ascontiguousarray(a, dt).tobytes() for a, dt in (
            (rows, np.uint8), (pads, np.int32), (byte_lens, np.int32), (t.children, np.int32))))
        subprocess.run([str(dec), str(B), str(capb), str(cap), str(len(t.children)), str(t.lattice), str(t.longest),
                        str(inp), str(out)], check=True)
        r = out.read_bytes()
        n = 4 * B * cap
        return (np.frombuffer(r[:n], np.int32).reshape(B, cap), np.frombuffer(r[n : n + 4 * B], np.int32),
                np.frombuffer(r[n + 4 * B :], np.int32))

    return encode, decode


@pytest.mark.parametrize("name", WIDE_CASES)
def test_wide_kernel_sources_on_host_match_plain(host_kernels, name):
    encode, decode = host_kernels
    ids, lengths, t = _wide_case(name)
    capw = _capw(ids, lengths, t)
    bits = np.array([sum(int(t.code_lens[i]) for i in r[:n]) for r, n in zip(ids, lengths)], np.int64)
    want = _plain_encode(ids, lengths, t, capw)
    got = encode(ids, lengths, t, capw, bits)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    rows, bl, pads = want
    cap = int(ids.shape[1]) + 8
    want_d = huffman_rows.decode_rows_wide(torch.from_numpy(rows), torch.from_numpy(pads), torch.from_numpy(bl),
                                           torch.from_numpy(t.children), t.lattice, cap, t.longest)
    for g, w in zip(decode(rows, pads, bl, t, cap), want_d):
        assert np.array_equal(g, w.numpy())
    assert (name != "past the shared table") or len(t.codes) > huffman_rows.WIDE_TABLE  # kernel G's global table
    assert (name != "long codes") or t.code_lens.max() > huffman_rows.LUT_BITS_WIDE  # kernel H's walk past its table
