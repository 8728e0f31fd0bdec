"""The port's Huffman layers against the JAX package and the host oracle.

``raisin_tpu_torch.formats.huffman`` is the port's copy of
``raisin_tpu.formats.huffman_ref``; ``raisin_tpu_torch.ops.huffman_rows``
on CPU tensors runs the plain PyTorch versions of kernels G
(``encode_rows``) and H (``decode_rows``), held against
``raisin_tpu.ops.huffman_pallas`` in Pallas interpret mode (as
tests/test_ops_pallas.py runs it); ``raisin_tpu_torch.ops.huffman_blocks``
is held against ``raisin_tpu.ops.huffman_blocks`` and the oracle. Outputs
are bytes and integers, so every comparison is exact (tolerance 0).
Inputs come from seeded numpy.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raisin_tpu.formats import huffman_ref
from raisin_tpu.ops import huffman_blocks as jax_hb
from raisin_tpu.ops import huffman_pallas as hp
from raisin_tpu_torch.formats import huffman as port_hf
from raisin_tpu_torch.ops import huffman_blocks, huffman_rows
from tests.fixtures import ABC, HELLO, UNICODE_TEXT, VERSE, random_bytes, random_text

torch.set_num_threads(1)


JAX_CODE_BITS = 26  # the JAX package's packed code entry: bits | len << 26


def split_packed_codes(packed: torch.Tensor):
    """The JAX package's (B, 132) ``bits | len << 26`` rows -> the port's (codes, code_lens), (B, 128) int32."""
    p = packed[:, : huffman_rows.NSYM].to(torch.int64) & 0xFFFFFFFF
    return (p & ((1 << JAX_CODE_BITS) - 1)).to(torch.int32), (p >> JAX_CODE_BITS).to(torch.int32)


def _freqs(block: bytes) -> dict[int, int]:
    syms, counts = np.unique(np.frombuffer(block, np.uint8), return_counts=True)
    return dict(zip(syms.tolist(), counts.tolist()))


def _fibonacci_block(symbols: int) -> bytes:
    fib = [1, 1]
    while len(fib) < symbols:
        fib.append(fib[-1] + fib[-2])
    block = np.repeat(np.arange(40, 40 + symbols, dtype=np.uint8), fib)
    np.random.default_rng(symbols).shuffle(block)
    return block.tobytes()


def _tensor(blocks: list[bytes]):
    """Blocks -> ((B, max length) uint8 zero-padded, lengths (B,) int32) as CPU tensors."""
    m = np.zeros((len(blocks), max(1, max(map(len, blocks)))), dtype=np.uint8)
    for i, b in enumerate(blocks):
        m[i, : len(b)] = np.frombuffer(b, np.uint8)
    return torch.from_numpy(m), torch.tensor([len(b) for b in blocks], dtype=torch.int32)


# ---------------------------------------------------------------------------
# The port's copy of the oracle


@pytest.mark.parametrize("seed", range(6))
def test_codes_equal_the_oracle_on_tie_heavy_tables(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        k = int(rng.integers(1, 129))
        syms = rng.choice(128 if seed % 2 else 300, size=k, replace=False)
        freqs = {int(s): int(rng.choice([1, 1, 2, 3, 5, int(rng.integers(1, 40))])) for s in syms}
        assert port_hf.print_codes(port_hf.build_tree(freqs)) == huffman_ref.print_codes(huffman_ref.build_tree(freqs))


HEADERS = [
    b"3|a5|b1|\\n",  # canonical, with a newline entry
    b"12|\\2|n7|1",  # '\\' then a digit symbol
    b"x4|ay|3|\xc3\xa9",  # junk bytes and a two-byte rune
    b"2|a2|a9|b",  # a repeated symbol: the last count wins
    b"|z",  # an empty count
]


@pytest.mark.parametrize("header", HEADERS)
def test_header_parse_equals_the_oracle(header):
    assert port_hf.parse_header(header) == huffman_ref.parse_header(header)


def test_header_build_and_errors_equal_the_oracle():
    freqs = {10: 3, 92: 1, 97: 7, 0x263A: 2}
    assert port_hf.build_header(freqs) == huffman_ref.build_header(freqs)
    for fn, arg in ((lambda m: m.parse_header(b"5|"), None), (lambda m: m.build_tree({}), None)):
        with pytest.raises(ValueError) as want:
            fn(huffman_ref)
        with pytest.raises(ValueError, match=str(want.value)):
            fn(port_hf)


@pytest.mark.parametrize(
    "payload",
    [HELLO, ABC, VERSE, UNICODE_TEXT, b"newline\nhandling\n", random_bytes(500, seed=70), random_text(3000, seed=71),
     b"ab\xed\xa0\x80c\xf4\x90\x80\x80\xe0\x80\xc1\xbfd\xf0\x9f\x98"],
)
def test_compress_decompress_equal_the_oracle(payload):
    c = port_hf.compress(payload)
    assert c == huffman_ref.compress(payload)
    assert port_hf.decompress(c) == huffman_ref.decompress(c)
    assert port_hf.go_decode_runes(payload) == huffman_ref.go_decode_runes(payload)


def test_oracle_errors_are_the_same():
    for data, how in ((b"", port_hf.compress), (port_hf.compress(b"aaaa"), port_hf.decompress),
                      (b"no separator", port_hf.decompress), (b"1|a\\\n", port_hf.decompress)):
        with pytest.raises(ValueError) as want:
            getattr(huffman_ref, how.__name__)(data)
        with pytest.raises(ValueError, match=str(want.value).split(" (")[0]):
            how(data)


# ---------------------------------------------------------------------------
# Plain kernels G and H against the Pallas kernels in interpret mode

B_INTERP, STEPS = 128, 2048


@functools.cache
def _interp_case():
    """128 seeded ASCII blocks of <= 2048 bytes; the JAX tables and both packages' rows."""
    rng = np.random.default_rng(5)
    blocks = [b"ab", b"s" * 700, _fibonacci_block(12)]
    while len(blocks) < B_INTERP:
        n = int(rng.integers(2, STEPS + 1))
        k = int(rng.integers(2, 70))
        syms = rng.choice(128, size=k, replace=False)
        blocks.append(bytes(rng.choice(syms, size=n, p=rng.dirichlet(np.ones(k) * 0.4)).astype(np.uint8)))
    ids = np.full((B_INTERP, STEPS), 128, dtype=np.uint8)
    codes = np.zeros((B_INTERP, hp.KPAD), dtype=np.int32)
    tables = np.zeros((B_INTERP, hp.NTAB), dtype=np.int32)
    for r, b in enumerate(blocks):
        ids[r, : len(b)] = np.frombuffer(b, np.uint8)
        tree = huffman_ref.build_tree(_freqs(b))
        for v, c in zip(*huffman_ref.print_codes(tree)):
            codes[r, v] = (int(c, 2) if c else 0) | (len(c) << hp.MAX_CODE_BITS)
        if not isinstance(tree, huffman_ref.Leaf):
            tables[r] = jax_hb._packed_table(tree)
    lengths = np.array([len(b) for b in blocks], dtype=np.int32)
    idw = np.ascontiguousarray(ids).view(np.int32)
    rows_j, bl_j, pads_j, oflow = hp.encode_rows_huffman(
        jnp.asarray(idw), jnp.asarray(lengths), jnp.asarray(codes), steps=STEPS, capw=512, interpret=True
    )
    assert not np.asarray(oflow).any()
    rows_j = np.asarray(rows_j).view(np.uint8).reshape(B_INTERP, -1)
    bl_j, pads_j = np.asarray(bl_j), np.asarray(pads_j)
    steps = int(((8 * bl_j - pads_j).max() + 127) // 128 * 128)
    out_j, cnt_j, ok_j = hp.decode_rows_huffman(
        jnp.asarray(rows_j), jnp.asarray(pads_j), jnp.asarray(bl_j), jnp.asarray(tables),
        num_steps=steps, cap_out=STEPS, interpret=True,
    )
    out_j = np.asarray(out_j).view(np.uint8).reshape(B_INTERP, -1)
    return blocks, ids, lengths, codes, tables, (rows_j, bl_j, pads_j), (out_j, np.asarray(cnt_j), np.asarray(ok_j))


def test_encode_plain_equals_pallas_interpret_and_oracle():
    blocks, ids, lengths, codes, _, (rows_j, bl_j, pads_j), _ = _interp_case()
    c, lens = split_packed_codes(torch.from_numpy(codes))
    rows, bl, pads = huffman_rows.encode_rows(torch.from_numpy(ids), torch.from_numpy(lengths), c, lens, 512)
    rows, bl, pads = rows.numpy(), bl.numpy(), pads.numpy()
    assert np.array_equal(bl, bl_j) and np.array_equal(pads, pads_j)
    for r, b in enumerate(blocks):
        # the Pallas rows hold stitch leftovers past the payload; the port's are zero there
        assert rows[r, : bl[r]].tobytes() == rows_j[r, : bl[r]].tobytes(), r
        assert not rows[r, bl[r] :].any()
        want = huffman_ref.compress(b)
        assert want.endswith(huffman_ref.SEPARATOR + bytes([pads[r]]) + rows[r, : bl[r]].tobytes()), r


def test_decode_plain_equals_pallas_interpret():
    blocks, _, _, _, tables, (rows_j, bl_j, pads_j), (out_j, cnt_j, ok_j) = _interp_case()
    out, cnt, ok = huffman_rows.decode_rows(
        torch.from_numpy(rows_j.copy()), torch.from_numpy(pads_j), torch.from_numpy(bl_j), torch.from_numpy(tables), STEPS
    )
    out, cnt, ok = out.numpy(), cnt.numpy(), ok.numpy()
    assert np.array_equal(cnt, cnt_j) and np.array_equal(ok, ok_j.astype(np.int32)) and ok.all()
    for r, b in enumerate(blocks):
        assert out[r, : cnt[r]].tobytes() == out_j[r, : cnt[r]].tobytes()
        if len(set(b)) > 1:
            assert out[r, : cnt[r]].tobytes() == b
        assert not out[r, cnt[r] :].any()


def test_split_packed_codes_reads_the_jax_layout():
    packed = torch.tensor([[5 | 3 << 26, (1 << 26) - 1 | 26 << 26] + [0] * 130], dtype=torch.int32)
    codes, lens = split_packed_codes(packed)
    assert codes[0, :2].tolist() == [5, (1 << 26) - 1] and lens[0, :2].tolist() == [3, 26]
    assert codes.shape == lens.shape == (1, 128)


def test_decode_counts_symbols_past_its_capacity_and_flags_a_cut_code():
    block = VERSE[:300]
    p = port_hf.compress(block)
    head, rest = p.split(port_hf.SEPARATOR, 1)
    table = huffman_blocks.packed_table(port_hf.build_tree(port_hf.parse_header(head)))
    body = rest[1:] + bytes(-len(rest[1:]) % 4)
    rows = torch.from_numpy(np.frombuffer(body, np.uint8).copy())[None]
    args = (torch.tensor([rest[0]], dtype=torch.int32), torch.from_numpy(table[None]))
    out, cnt, ok = huffman_rows.decode_rows(rows, args[0], torch.tensor([len(rest) - 1], dtype=torch.int32), args[1], 100)
    assert cnt.tolist() == [300] and ok.tolist() == [1] and out[0].numpy().tobytes() == block[:100]
    # one byte short: the walk ends inside a code or on a boundary, as the oracle says
    out, cnt, ok = huffman_rows.decode_rows(rows, args[0], torch.tensor([len(rest) - 2], dtype=torch.int32), args[1], 400)
    try:
        want = huffman_ref.decompress(p[:-1])
    except ValueError:
        assert ok.tolist() == [0]
    else:
        assert ok.tolist() == [1] and out[0, : cnt[0]].numpy().tobytes() == want


# ---------------------------------------------------------------------------
# The container's Huffman layer

LAYER_BLOCKS = [
    HELLO, VERSE, random_text(3000, seed=72), b"ab", b"x", b"\x00\x01\x02\x03" * 64,
    UNICODE_TEXT, random_bytes(900, seed=73), _fibonacci_block(22),
]


@functools.cache
def _layer():
    x, n = _tensor(LAYER_BLOCKS)
    huffman_blocks.reset_host_split()
    flat, sizes = huffman_blocks.encode_blocks(x, n)
    return flat, sizes, dict(huffman_blocks.host_split)


def test_layer_encode_equals_jax_and_the_oracle():
    flat, sizes, split = _layer()
    body = flat.numpy().tobytes()
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    got = [body[a : a + k] for a, k in zip(starts, sizes)]
    assert got == jax_hb.encode_blocks(LAYER_BLOCKS) == [huffman_ref.compress(b) for b in LAYER_BLOCKS]
    assert split == {"encode": 2, "decode": 0}  # UNICODE_TEXT and the random bytes


def test_layer_decode_equals_jax():
    flat, sizes, _ = _layer()
    keep = [i for i, b in enumerate(LAYER_BLOCKS) if len(set(b)) > 1]  # one symbol: the oracle refuses
    body = flat.numpy().tobytes()
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    payloads = [body[starts[i] : starts[i] + sizes[i]] for i in keep]
    data = b"".join(payloads)
    k = np.array([len(p) for p in payloads], dtype=np.int64)
    huffman_blocks.reset_host_split()
    rows, counts, host = huffman_blocks.decode_blocks(
        torch.from_numpy(np.frombuffer(data, np.uint8).copy()), data, np.concatenate([[0], np.cumsum(k)[:-1]]), k, 50000
    )
    want = jax_hb.decode_blocks(payloads)
    got = [host[j] if j in host else rows[j, : counts[j]].numpy().tobytes() for j in range(len(keep))]
    assert got == want
    assert sorted(host) == [j for j, i in enumerate(keep) if max(LAYER_BLOCKS[i]) >= 0x80]
    assert huffman_blocks.host_split["decode"] == len(host)


def test_layer_takes_a_21_bit_code_on_the_plain_kernels():
    block = _fibonacci_block(22)
    assert max(map(len, port_hf.print_codes(port_hf.build_tree(_freqs(block)))[1])) == 21
    x, n = _tensor([block])
    flat, sizes = huffman_blocks.encode_blocks(x, n)
    assert flat.numpy().tobytes() == huffman_ref.compress(block)


def test_single_symbol_block_encodes_like_the_oracle_and_refuses_to_decode():
    x, n = _tensor([b"q" * 333])
    flat, sizes = huffman_blocks.encode_blocks(x, n)
    p = flat.numpy().tobytes()
    assert p == huffman_ref.compress(b"q" * 333) == jax_hb.encode_blocks([b"q" * 333])[0]
    for decode in (lambda: jax_hb.decode_blocks([p]),
                   lambda: huffman_blocks.decode_blocks(flat, p, np.array([0]), np.array([len(p)]), 400)):
        with pytest.raises(ValueError, match="single-symbol stream is not decodable"):
            decode()


def test_empty_block_raises_like_the_oracle():
    x, n = _tensor([b"abc", b""])
    with pytest.raises(ValueError, match="cannot compress empty input"):
        jax_hb.encode_blocks([b"abc", b""])
    with pytest.raises(ValueError, match="cannot compress empty input"):
        huffman_blocks.encode_blocks(x, n)


def test_code_past_32_bits_names_its_roadmap_item():
    counts = np.zeros((1, 256), dtype=np.int64)
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    counts[0, 40 : 40 + 34] = fib  # 34 symbols: the longest code has 33 bits
    with pytest.raises(ValueError, match="33-bit code.*ROADMAP Queue 1 item 18"):
        huffman_blocks.code_tables(counts)


@pytest.mark.parametrize("flip", [1, 2, 5])
def test_corrupt_stream_raises_like_jax(flip):
    p = huffman_ref.compress(VERSE)
    bad = p[:-flip] + bytes([p[-flip] ^ 0xA5]) + p[len(p) - flip + 1 :]
    try:
        want = jax_hb.decode_blocks([bad])[0]
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            huffman_blocks.decode_blocks(torch.from_numpy(np.frombuffer(bad, np.uint8).copy()), bad,
                                         np.array([0]), np.array([len(bad)]), 4 * len(VERSE))
    else:
        rows, counts, _ = huffman_blocks.decode_blocks(
            torch.from_numpy(np.frombuffer(bad, np.uint8).copy()), bad, np.array([0]), np.array([len(bad)]), 4 * len(VERSE)
        )
        assert rows[0, : counts[0]].numpy().tobytes() == want


def test_truncated_stream_raises_like_jax():
    p = huffman_ref.compress(VERSE)
    for cut in range(1, 4):
        bad = p[:-cut]
        try:
            jax_hb.decode_blocks([bad])
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                huffman_blocks.decode_blocks(torch.from_numpy(np.frombuffer(bad, np.uint8).copy()), bad,
                                             np.array([0]), np.array([len(bad)]), 4 * len(VERSE))
            return
    pytest.fail("no cut ended inside a code")


def test_packed_table_equals_jax():
    for block in (VERSE, random_text(2000, seed=74), _fibonacci_block(22), bytes(range(128)) * 3):
        tree = huffman_ref.build_tree(_freqs(block))
        assert np.array_equal(huffman_blocks.packed_table(port_hf.build_tree(_freqs(block))), jax_hb._packed_table(tree))
    assert huffman_blocks.packed_table(port_hf.build_tree({200: 3, 65: 1})) is None


def test_cpu_wrappers_launch_no_kernel():
    huffman_rows.encode_rows.launches = huffman_rows.decode_rows.launches = 0
    x, n = _tensor([VERSE])
    flat, sizes = huffman_blocks.encode_blocks(x, n)
    p = flat.numpy().tobytes()
    rows, counts, _ = huffman_blocks.decode_blocks(flat, p, np.array([0]), np.array([len(p)]), len(VERSE))
    assert rows[0, : counts[0]].numpy().tobytes() == VERSE
    assert huffman_rows.encode_rows.launches == huffman_rows.decode_rows.launches == 0
