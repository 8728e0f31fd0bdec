"""LZSS containers past the card's search window (65535), against the JAX package and the oracle.

Past its device search (window 8191) the JAX package codes ``lzss`` and
``lzss,arithmetic`` containers block by block on the host, each block's
tokens from the native C runtime; the port does the same past 65535, where
its kernel D stops. ``lzss,huffman`` there carries the oracle's tokens under
the card's Huffman layer, with the aux table of token lengths that every
JAX ``lzss,huffman`` container carries. Held here, exactly, on 150,000
seeded bytes of text whose first 20,000 come back 70,000 and 120,000 bytes
later, in 128 KiB blocks, at windows 65536, 100000 and 2**20: the bytes of
both packages, each package's decode of them (of ``lzss,huffman`` the JAX
decode at window 100000 only: it takes ~20 s on the CPU), and the tokens
against ``lzss_ref``. Also pinned: the JAX package's ``lzss,huffman`` at window
20000 writes wrong tokens (its device search packs distances in 14 bits),
where the port writes the oracle's.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import pytest

from raisin_tpu.formats import huffman_ref, lzss_ref
from raisin_tpu.ops import lzss_jax
from raisin_tpu.parallel import blocks as jax_blocks
from raisin_tpu_torch.engine import core as port_core
from raisin_tpu_torch.engine import registry as port_registry
from raisin_tpu_torch.parallel import blocks as port_blocks
from tests.go_heap import jax_heap_at_go_rule  # noqa: F401  (a fixture)

# the JAX oracle builds Go's Huffman tree here, as the port does (tests/go_heap.py)
pytestmark = pytest.mark.usefixtures("jax_heap_at_go_rule")

CPU = "cpu"
BLOCK = 128 << 10
WINDOWS = [65536, 100000, 1 << 20]
LETTERS = np.frombuffer(b"etaoinshrdlucmfwypvbgkjqxz ETAOIN.,\n", np.uint8)  # no '<': its escape is not UTF-8


@functools.cache
def _data() -> bytes:
    rng = np.random.default_rng(70)
    text = lambda n: rng.choice(LETTERS, n)  # noqa: E731
    head = text(20000)
    return np.concatenate([head, text(50000), head[:8000], text(42000), head, text(10000)]).tobytes()


@pytest.fixture
def native_first():
    """The port prefers native C, whose bytes are the auto order's (native C takes LZSS past the card's
    search; its arithmetic equals the card's) in a fraction of the plain versions' time on the CPU."""
    port_registry.set_preferred_backend("native")
    yield
    port_registry.set_preferred_backend("auto")


def _tokens(data: bytes, window: int) -> list[bytes]:
    return [lzss_ref.compress(data[i : i + BLOCK], window) for i in range(0, len(data), BLOCK)]


def _farthest(tokens: list[bytes]) -> int:
    return max(int(d) for t in tokens for d in re.findall(rb"<(\d+),", t))


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("algorithms", [("lzss",), ("lzss", "arithmetic")])
def test_lzss_containers_past_the_card_window_equal_jax(native_first, algorithms, window):
    data = _data()
    got = port_blocks.compress_container(data, algorithms, block_size=BLOCK, window=window, device=CPU)
    assert got == jax_blocks.compress_container(data, algorithms, block_size=BLOCK, window=window)
    _, _, _, payloads, aux, w = port_blocks.parse_container(got)
    assert aux == [] and w == window
    if algorithms == ("lzss",):
        assert payloads == _tokens(data, window)
    assert jax_blocks.decompress_container(got) == data
    assert port_blocks.decompress_container(got, device=CPU) == data


@pytest.mark.parametrize("window", WINDOWS)
def test_lzss_huffman_past_the_card_window_carries_the_oracle_tokens(native_first, window):
    data = _data()
    got = port_blocks.compress_container(data, ("lzss", "huffman"), block_size=BLOCK, window=window, device=CPU)
    _, _, _, payloads, aux, w = port_blocks.parse_container(got)
    tokens = _tokens(data, window)
    assert _farthest(tokens) == {65536: 50000, 100000: 70000}.get(window, 120000)  # matches past 65535 at 100000+
    assert w == window and aux == [[len(t) for t in tokens]]
    assert payloads == [huffman_ref.compress(t) for t in tokens]
    assert port_blocks.decompress_container(got, device=CPU) == data
    if window == 100000:  # the JAX decode walks its Huffman bits in an XLA scan on the CPU, ~20 s a call
        assert jax_blocks.decompress_container(got) == data


def test_device_lzss_past_the_card_window_raises():
    """The card's search asked for by name keeps its ValueError past 65535, in a stream and in a container."""
    with pytest.raises(ValueError, match="the card's match search takes windows up to 65535"):
        port_core.compress_bytes(b"abc" * 10, ["lzss"], backend="device", window=65536, device=CPU)
    port_registry.set_preferred_backend("device")
    try:
        with pytest.raises(ValueError, match="the card's match search takes windows up to 65535"):
            port_blocks.compress_container(b"abc" * 10, ("lzss", "huffman"), block_size=16, window=65536,
                                           device=CPU)
    finally:
        port_registry.set_preferred_backend("auto")


def test_jax_lzss_huffman_past_16383_writes_wrong_tokens():
    """The JAX device search packs distances in 14 bits (raisin_tpu/ops/lzss_jax.py:127-134), and its
    lzss,huffman container takes it at every window: 18,000 becomes 18,000 - 16,384 = 1,616. The port's
    kernel D (its plain version here) writes the oracle's tokens, and its container round-trips."""
    head = np.random.default_rng(1).choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8), 18000)
    data = np.concatenate([head, head[:3000]]).tobytes()  # its first 3,000 bytes again 18,000 later
    want = lzss_ref.compress(data, 20000)
    assert want.endswith(b"<18000,3000>") and lzss_jax.compress(data, 20000).endswith(b"<1616,2999>")
    jax_c = jax_blocks.compress_container(data, ("lzss", "huffman"), block_size=1 << 16, window=20000)
    port_c = port_blocks.compress_container(data, ("lzss", "huffman"), block_size=1 << 16, window=20000, device=CPU)
    assert port_blocks.parse_container(port_c)[3] == [huffman_ref.compress(want)]
    assert huffman_ref.decompress(jax_blocks.parse_container(jax_c)[3][0]).endswith(b"<1616,2999>")
    assert port_blocks.decompress_container(port_c, device=CPU) == jax_blocks.decompress_container(port_c) == data
    with pytest.raises(ValueError):
        jax_blocks.decompress_container(jax_c)
