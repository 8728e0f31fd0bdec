"""Kernel I's plain version and the single-stream arithmetic codec against the JAX package.

``raisin_tpu_torch.ops.arithmetic_rows.encode_events`` on CPU tensors runs
the plain PyTorch version of kernel I; here it is held against
``raisin_tpu.ops.arithmetic_pallas.encode_blocks_events`` in Pallas
interpret mode (as tests/test_ops_pallas.py runs it) and against the XLA
scan ``raisin_tpu.ops.arithmetic_scan._events_xla``.
``raisin_tpu_torch.ops.arithmetic_scan`` (events, expansion, ``compress``,
``decompress``) is held against ``raisin_tpu.ops.arithmetic_scan`` and the
host oracle, and the port's copy of the oracle against the original.
Outputs are bytes and integers, so every comparison is exact (tolerance
0). Inputs come from seeded numpy or the fixtures; the JAX device calls
stay at 1 KiB or less, where each compiles once.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raisin_tpu.bitkit import packing
from raisin_tpu.formats import arithmetic_ref
from raisin_tpu.ops import arithmetic_pallas as ap
from raisin_tpu.ops import arithmetic_scan as jax_scan
from raisin_tpu_torch.formats import arithmetic as port_arith
from raisin_tpu_torch.ops import arithmetic_rows as ar
from raisin_tpu_torch.ops import arithmetic_scan as port_scan
from tests.fixtures import UNICODE_TEXT, VERSE, random_bytes, random_text
from tests.test_ops_pallas import _block_batch, _payload_matrix

torch.set_num_threads(1)

S = 256  # the edge matrix's steps; B = 128, the Pallas kernel's lane count


@functools.cache
def _edge():
    """tests/test_ops_pallas.py's edge payloads at S = 256 in a batch of 128 blocks."""
    return _block_batch(_payload_matrix(S), 128, S)


@functools.cache
def _port_events():
    symbols, lengths = _edge()
    slots, slot0 = ar.encode_events(torch.from_numpy(symbols), torch.from_numpy(lengths))
    return slots.numpy(), slot0.numpy()


def test_plain_events_equal_the_pallas_kernel():
    symbols, lengths = _edge()
    slots, slot0 = ap.encode_blocks_events(symbols, lengths, interpret=True)
    got_slots, got_slot0 = _port_events()
    assert got_slots.dtype == np.uint8 and got_slots.shape == (128, S, 16)
    assert got_slot0.dtype == np.int32 and got_slot0.shape == (128, S)
    assert np.array_equal(got_slots, np.asarray(slots))
    assert np.array_equal(got_slot0, np.asarray(slot0))


def test_plain_events_equal_the_xla_scan():
    symbols, lengths = _edge()
    slots, slot0 = jax_scan._events_xla(jnp.asarray(symbols), jnp.asarray(lengths), S)
    got_slots, got_slot0 = _port_events()
    assert np.array_equal(got_slots, np.asarray(slots).astype(np.uint8))
    assert np.array_equal(got_slot0, np.asarray(slot0))


def test_steps_past_eof_are_zero():
    symbols, lengths = _edge()
    slots, slot0 = _port_events()
    past = np.arange(S)[None, :] > lengths[:, None]
    assert not slots[past].any() and not slot0[past].any()
    assert slots[~past].any()


def test_plain_events_equal_the_xla_scan_past_the_freeze():
    # lengths above 16,383: the model freezes after 16,126 updates
    rng = np.random.default_rng(5)
    steps = 16_600
    blocks = [
        bytes(rng.integers(0, 256, size=16_500, dtype=np.uint8)),
        (VERSE * 60)[:16_450],
    ]
    symbols, lengths = _block_batch(blocks, 2, steps)
    slots, slot0 = jax_scan._events_xla(jnp.asarray(symbols), jnp.asarray(lengths), steps)
    slots = np.asarray(slots).astype(np.uint8)
    got_slots, got_slot0 = ar.encode_events(torch.from_numpy(symbols), torch.from_numpy(lengths))
    assert np.array_equal(got_slots.numpy(), slots)
    assert np.array_equal(got_slot0.numpy(), np.asarray(slot0))
    # an E3 shift leaves the interval straddling the half: no emission
    # follows one within its step, so the in-step pending field stays 0
    assert not (slots & 0x1F).any()
    assert int(np.asarray(slot0).max()) > 0


@pytest.mark.parametrize("max_bits", [None, 96])
def test_encode_blocks_equals_jax(max_bits):
    # 96 bits overflow most blocks; bit_lengths stays right all the same
    symbols, lengths = _block_batch(_payload_matrix(S), 16, S)
    want_bits, want_lens = jax_scan.encode_blocks(symbols, lengths, S, max_bits=max_bits)
    bits, lens = port_scan.encode_blocks(torch.from_numpy(symbols), torch.from_numpy(lengths), max_bits=max_bits)
    assert bits.dtype == torch.uint8 and lens.dtype == torch.int32
    assert np.array_equal(bits.numpy(), np.asarray(want_bits))
    assert np.array_equal(lens.numpy(), np.asarray(want_lens))
    if max_bits is not None:
        assert int(lens.max()) > max_bits


def test_expansion_in_small_pieces_gives_the_same_bits(monkeypatch):
    symbols, lengths = _block_batch(_payload_matrix(S), 16, S)
    whole = port_scan.encode_blocks(torch.from_numpy(symbols), torch.from_numpy(lengths))
    data = random_text(900, seed=40)
    stream = port_scan.compress(data, device="cpu")
    monkeypatch.setattr(port_scan, "EXPAND_PIECE", 40)
    pieces = port_scan.encode_blocks(torch.from_numpy(symbols), torch.from_numpy(lengths))
    assert all(torch.equal(a, b) for a, b in zip(whole, pieces))
    assert port_scan.compress(data, device="cpu") == stream == arithmetic_ref.compress(data)


def test_encode_blocks_rejects_symbols_out_of_range():
    symbols = torch.tensor([[1, 2, 257]], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[0, 256\]"):
        port_scan.encode_blocks(symbols, torch.tensor([2], dtype=torch.int32))


STREAMS = {
    "empty": b"",
    "one_byte": b"a",
    "binary": random_bytes(800, seed=41),
    "escape_heavy": (b"<<<\\\xff,,>>>" * 90)[:900],
    "text": random_text(1000, seed=42),
    "unicode": UNICODE_TEXT,
}


@pytest.mark.parametrize("name", STREAMS)
def test_compress_equals_the_oracle_and_jax(name):
    data = STREAMS[name]
    got = port_scan.compress(data, device="cpu")
    assert got == arithmetic_ref.compress(data)
    assert got == jax_scan.compress(data)


@pytest.mark.parametrize("name", STREAMS)
def test_decompress_round_trips(name):
    data = STREAMS[name]
    stream = arithmetic_ref.compress(data)
    assert port_scan.decompress(stream, device="cpu") == data  # the port's copy of the oracle
    assert port_scan.decompress(stream, out_len=len(data), device="cpu") == data  # kernel C's plain version


def test_corrupt_streams_raise_like_jax():
    data = random_text(600, seed=43)
    cut = arithmetic_ref.compress(data)[:150]
    for decode in (arithmetic_ref.decompress, functools.partial(port_scan.decompress, device="cpu")):
        with pytest.raises(ValueError, match="stream ended without EOF symbol"):
            decode(cut)
    for decode in (jax_scan.decompress, functools.partial(port_scan.decompress, device="cpu")):
        with pytest.raises(ValueError, match="EOF symbol not found where expected"):
            decode(cut, len(data))
        with pytest.raises(ValueError, match="no sentinel bit found"):
            decode(b"\x00\x00", 3)


def test_decompress_with_length_strips_leading_zero_bytes_like_jax():
    # bits.go:63 strips through the first 1 bit, wherever it lies
    data = random_text(300, seed=44)
    stream = b"\x00\x00" + arithmetic_ref.compress(data)
    assert jax_scan.decompress(stream, len(data)) == data
    assert port_scan.decompress(stream, out_len=len(data), device="cpu") == data


@pytest.mark.parametrize("name", STREAMS)
def test_copied_oracle_equals_the_original(name):
    data = STREAMS[name]
    stream = arithmetic_ref.compress(data)
    assert port_arith.compress(data) == stream
    assert np.array_equal(port_arith.encode_bits(data), arithmetic_ref.encode_bits(data))
    assert port_arith.decompress(stream) == arithmetic_ref.decompress(stream) == data


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64, 1001])
def test_copied_prepad_helpers_equal_the_originals(n):
    bits = np.random.default_rng(n).integers(0, 2, size=n, dtype=np.uint8)
    packed = packing.pack_prepad_sentinel(bits)
    assert port_arith.pack_prepad_sentinel(bits) == packed
    assert np.array_equal(port_arith.unpack_prepad_sentinel(packed), packing.unpack_prepad_sentinel(packed))
    with pytest.raises(ValueError, match="no sentinel bit found"):
        port_arith.unpack_prepad_sentinel(b"\x00" * (n % 3))
