"""The port's host ranges: the ``sync.*`` and ``copy.*`` ranges of ``ops/device.py`` and the
container's ``rsnb.range``, on the CPU; and, on a card, that every wait for the card that PyTorch's
sync debug mode reports happens inside a ``sync.*`` range.

The card tests are marked ``card`` and skip without one. On a machine with a card (this file
imports no JAX; the directory's conftest.py does, so it is left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -m card
"""

from __future__ import annotations

import random
import threading
import traceback
import warnings

import pytest
import torch

from raisin_tpu_torch.engine.core import compress_bytes
from raisin_tpu_torch.ops import device, huffman_blocks, lzss_match
from raisin_tpu_torch.parallel import blocks
from raisin_tpu_torch.parallel.mesh import data_mesh

PREFIXES = ("rsnb.", "sync.", "copy.", "stream.")


def _text(n: int, seed: int) -> bytes:
    """Words with the escape layer's bytes (0x5C, 0xFF) and '<' among them."""
    r = random.Random(seed)
    words = [b"alpha", b"beta", b"gamma", b"<delta>", b"eps\\ilon", b"\xffzeta", b"eta", b"theta\n"]
    out = bytearray()
    while len(out) < n:
        out += r.choice(words) + b" "
    return bytes(out[:n])


def _ranges(fn) -> list[str]:
    """The name of every range of the port that ``fn()`` opens, in the order they start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted((e for e in prof.events() if e.name.startswith(PREFIXES)), key=lambda e: e.time_range.start)
    return [e.name for e in events]


def test_sync_counts_the_open_ranges_of_its_own_thread():
    assert not device.waiting()
    seen = {}

    def other():
        seen["other"] = device.waiting()

    with device.sync("h2d"):
        with device.sync("lengths"):
            assert device.waiting()
        assert device.waiting()
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert not device.waiting() and seen == {"other": False}
    with pytest.raises(ValueError), device.sync("width"):
        raise ValueError
    assert not device.waiting()


def test_copies_record_their_ranges_on_the_cpu():
    names = _ranges(lambda: device.d2h(device.h2d(b"abc", torch.device("cpu"))))
    assert names == ["sync.h2d", "copy.bytes"]  # no pinned buffer and no copy back from the CPU


def test_a_stream_compress_records_its_copies_and_waits():
    data = _text(1500, seed=3)
    names = _ranges(lambda: compress_bytes(data, ("lzss", "arithmetic"), window=64, device="cpu"))
    assert names.count("copy.bytes") == 2  # one a layer
    waits = {n for n in names if n.startswith("sync.")}
    assert {"sync.h2d", "sync.any", "sync.width", "sync.mask", "sync.lengths"} <= waits
    assert {"stream.enc.escape", "stream.enc.expand", "stream.enc.d2h"} <= set(names)


@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_a_cpu_mesh_records_one_range_a_block_range(direction):
    data = _text(1200, seed=4)
    mesh = data_mesh(2, device="cpu")
    blob = blocks.compress_container(data, block_size=256, mesh=mesh, window=64, device="cpu")
    if direction == "compress":
        names = _ranges(lambda: blocks.compress_container(data, block_size=256, mesh=mesh, window=64, device="cpu"))
    else:
        names = _ranges(lambda: blocks.decompress_container(blob, mesh=mesh, device="cpu"))
    assert blocks.decompress_container(blob, mesh=mesh, device="cpu") == data
    assert names.count("rsnb.range") == 2  # 5 blocks: [0, 3) and [3, 5)
    assert names.count("rsnb.enc.h2d" if direction == "compress" else "rsnb.dec.h2d") == 2
    if direction == "compress":
        assert names.count("rsnb.enc.frame") == 1
    assert names.count("copy.pin") == 1 and names.count("copy.bytes") == 1  # one host buffer, one bytes


@pytest.mark.parametrize("direction", ["compress", "decompress"])
@pytest.mark.parametrize("algorithms", blocks.PIPELINES, ids=",".join)
def test_every_card_pipeline_comes_back_through_one_host_buffer(algorithms, direction):
    """On a two-entry mesh, each pipeline's header and both ranges' payloads, or both ranges' decoded
    bytes, are put into one host buffer and copied into ``bytes`` once."""
    data = _text(1200, seed=9)
    mesh = data_mesh(2, device="cpu")
    blob = blocks.compress_container(data, algorithms, block_size=256, mesh=mesh, window=64, device="cpu")
    if direction == "compress":
        names = _ranges(lambda: blocks.compress_container(data, algorithms, block_size=256, mesh=mesh, window=64,
                                                          device="cpu"))
    else:
        names = _ranges(lambda: blocks.decompress_container(blob, mesh=mesh, device="cpu"))
    assert names.count("rsnb.range") == 2
    assert names.count("copy.pin") == 1 and names.count("copy.bytes") == 1
    assert names.index("copy.pin") < names.index("copy.bytes") and names[-1] == "copy.bytes"
    assert blocks.decompress_container(blob, mesh=mesh, device="cpu") == data


def test_huffman_oracle_blocks_come_back_in_the_rows():
    """A ("huffman",) container of ASCII blocks and valid UTF-8 blocks, which the host oracle codes and
    decodes, round-trips with the oracle's blocks put back through the card's rows: one copy into bytes."""
    ascii_block, utf8_block = _no_lt(_text(256, seed=10)), ("naïve résumé " * 40).encode()[:256]
    data = ascii_block + utf8_block + ascii_block + utf8_block[:-1] + b"z" + _no_lt(_text(100, seed=11))
    assert data.decode() and not utf8_block.isascii()
    blob = blocks.compress_container(data, ("huffman",), block_size=256, device="cpu")
    huffman_blocks.reset_host_split()
    names = _ranges(lambda: blocks.decompress_container(blob, device="cpu"))
    assert huffman_blocks.host_split == {"encode": 0, "decode": 2}
    assert names.count("copy.bytes") == 1 and names.count("rsnb.dec.d2h") == 1
    assert blocks.decompress_container(blob, device="cpu") == data


def _no_lt(data: bytes) -> bytes:
    """``data`` without '<' and 0xFF, which the LZSS escape turns into 0xFF: a rune that Go's Huffman
    layer writes as U+FFFD, so an lzss,huffman container of them does not decode."""
    return data.replace(b"<", b"(").replace(b"\xff", b"y")


@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_a_huffman_container_records_its_stages_and_waits(direction):
    data = _no_lt(_text(1500, seed=8))
    blob = blocks.compress_container(data, ("lzss", "huffman"), block_size=512, window=64, device="cpu")
    if direction == "compress":
        names = _ranges(lambda: blocks.compress_container(data, ("lzss", "huffman"), block_size=512, window=64,
                                                          device="cpu"))
        assert {"rsnb.enc.count", "rsnb.enc.tree", "rsnb.enc.huffman", "rsnb.enc.hframe"} <= set(names)
        assert names.count("rsnb.enc.frame") == 1  # the container's; the payloads' own is rsnb.enc.hframe
        waits = {"sync.d2h", "sync.h2d", "sync.mask"}  # counts, tables, the framed payloads (G's check word: a card's)
    else:
        names = _ranges(lambda: blocks.decompress_container(blob, device="cpu"))
        assert {"rsnb.dec.tree", "rsnb.dec.rows", "rsnb.dec.huffman"} <= set(names)
        waits = {"sync.h2d", "sync.faults", "sync.lengths"}  # tables, H's flags, its counts
    assert waits <= {n for n in names if n.startswith("sync.")}
    assert blocks.decompress_container(blob, device="cpu") == data


def test_match_tile_counts_start_at_zero_on_the_cpu():
    lzss_match.reset_tile_counts()
    x = torch.frombuffer(bytearray(b"abcabcabcabc"), dtype=torch.uint8)[None]
    lzss_match.find_matches(x, torch.tensor([12], dtype=torch.int32), 16)
    assert lzss_match.tile_counts() == {"chain": 0, "sweep": 0}  # the plain version counts no tiles


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _syncs(fn) -> tuple[int, list[str]]:
    """Run ``fn()`` under PyTorch's sync debug mode; -> (the synchronisations it reported, the stacks
    of those outside a sync.* range)."""
    seen, outside = [0], []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            seen[0] += 1
            if not device.waiting():
                outside.append("".join(traceback.format_stack(limit=8)[:-1]))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return seen[0], outside


@pytest.mark.card
def test_every_wait_for_the_card_is_inside_a_sync_range(card):
    data = _text(3 * 65536 + 1000, seed=5)
    stream_in = _text(200_000, seed=6)

    def container():
        blob = blocks.compress_container(data, ("lzss", "arithmetic"), device=card)
        assert blocks.decompress_container(blob, device=card) == data

    def stream():
        compress_bytes(stream_in, ("lzss", "arithmetic"), device=card)

    huffman_in = _no_lt(data)

    def huffman_container():
        blob = blocks.compress_container(huffman_in, ("lzss", "huffman"), device=card)
        assert blocks.decompress_container(blob, device=card) == huffman_in

    for fn in (container, stream, huffman_container):
        fn()  # the kernels' build and first launches, outside the count
        seen, outside = _syncs(fn)
        assert seen > 0, "the sync debug mode reported nothing"
        assert not outside, f"{len(outside)} of {seen} waits outside a sync range:\n" + "\n".join(outside)


@pytest.mark.card
def test_match_tile_counts_add_up_on_the_card(card):
    lzss_match.reset_tile_counts()
    x = torch.frombuffer(bytearray(_text(65536, seed=7)), dtype=torch.uint8).to(card)[None]
    n = torch.tensor([65536], dtype=torch.int32, device=card)
    lzss_match.find_matches(x, n, 4096)
    one = lzss_match.tile_counts()
    assert one["chain"] + one["sweep"] > 0
    lzss_match.find_matches(x, n, 4096)
    assert lzss_match.tile_counts() == {k: 2 * v for k, v in one.items()}
    lzss_match.reset_tile_counts()
    assert lzss_match.tile_counts() == {"chain": 0, "sweep": 0}
