"""The port's engine and single-stream codecs against the JAX package's, byte for byte.

``raisin_tpu_torch.compress_bytes`` / ``decompress_bytes`` and the file
functions run here on the CPU (``device="cpu"``: the kernels' plain
versions) and are held against ``raisin_tpu``'s with ``backend="host"``
and ``backend="device"`` (CPU JAX), and against the host oracles; the
``lzss`` and ``huffman`` stream codecs and the port's copy of the LZSS
oracle likewise. Outputs are bytes, so every comparison is exact
(tolerance 0). The JAX device calls stay at 2 KiB or less, where its XLA
scans compile in seconds; ``chip_smoke.ORACLE_STREAM`` is recomputed with
the oracles at its full 1 MiB.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import raisin_tpu
import raisin_tpu_torch
from raisin_tpu.formats import arithmetic_ref, huffman_ref, lzss_ref
from raisin_tpu.ops import huffman_jax, lzss_jax
from raisin_tpu_torch.engine import core, registry
from raisin_tpu_torch.formats import lzss as port_lzss
from raisin_tpu_torch.ops import arithmetic_scan, huffman_blocks, huffman_stream, lzss_stream
from raisin_tpu_torch.parallel import blocks as port_blocks
from tests.fixtures import ABC, HELLO, UNICODE_TEXT, VERSE, random_bytes, random_text

torch.set_num_threads(1)

CPU = "cpu"
PIPELINES = [("arithmetic",), ("lzss",), ("huffman",), ("lzss", "arithmetic"), ("lzss", "huffman")]
# ASCII with the LZSS escape byte (0x5C) and token syntax; no "<", which LZSS
# escapes to 0xFF, so that every pipeline round-trips (Huffman reads runes)
DATA = (random_text(700, seed=60) + b" a\\b ,> \\\\ " + VERSE[:200])[:960]


@functools.cache
def _jax_streams(pipeline: tuple[str, ...], window: int | None) -> tuple[bytes, bytes]:
    """raisin_tpu.compress_bytes(DATA) with backend host and device."""
    return tuple(
        raisin_tpu.compress_bytes(DATA, list(pipeline), backend=b, window=window) for b in ("host", "device")
    )


@pytest.mark.parametrize("window", [None, 2048])
@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("pipeline", PIPELINES, ids=",".join)
def test_compress_bytes_equals_jax(pipeline, backend, window):
    host, device = _jax_streams(pipeline, window)
    got = raisin_tpu_torch.compress_bytes(DATA, list(pipeline), backend=backend, window=window, device=CPU)
    assert got == host == device
    # each package decodes the other's streams
    assert raisin_tpu_torch.decompress_bytes(device, list(pipeline), backend=backend, device=CPU) == DATA
    assert raisin_tpu.decompress_bytes(got, list(pipeline), backend="host") == DATA


def test_compress_bytes_binary_equals_jax():
    data = random_bytes(700, seed=61) + b"<\\\xff" * 30
    for pipeline in (("arithmetic",), ("lzss",), ("lzss", "arithmetic")):
        want = raisin_tpu.compress_bytes(data, list(pipeline), backend="device")
        got = raisin_tpu_torch.compress_bytes(data, list(pipeline), backend="device", device=CPU)
        assert got == want
        assert raisin_tpu_torch.decompress_bytes(got, list(pipeline), backend="device", device=CPU) == data


@pytest.mark.parametrize("container", [False, True], ids=["raw", "container"])
def test_file_round_trip(tmp_path, container):
    src = tmp_path / "in.txt"
    src.write_bytes(DATA)
    out = tmp_path / "in.txt.rsn"
    algorithms = ["lzss", "arithmetic"]
    c = raisin_tpu_torch.compress_file(algorithms, str(src), str(out), quiet=True, backend="device",
                                       container=container, block_size=512, window=2048, device=CPU)
    assert out.read_bytes() == c
    if container:
        assert c[:4] == b"RSNB"
        assert c == port_blocks.compress_container(DATA, tuple(algorithms), 512, window=2048, device=CPU)
    else:
        assert c == raisin_tpu.compress_bytes(DATA, algorithms, backend="host", window=2048)
    back = tmp_path / "back.txt"
    assert raisin_tpu_torch.decompress_file(algorithms, str(out), str(back), quiet=True, backend="device",
                                            device=CPU) == DATA
    assert back.read_bytes() == DATA


def test_files_functions_name_their_outputs(tmp_path):
    paths = []
    for i in range(2):
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(DATA[i * 100 : i * 100 + 300])
        paths.append(str(p))
    raisin_tpu_torch.compress_files(["huffman"], paths, ".rsn", quiet=True, device=CPU)
    for p in paths:
        with open(p, "rb") as f, open(p + ".rsn", "rb") as g:
            assert g.read() == huffman_ref.compress(f.read())
    raisin_tpu_torch.decompress_files(["huffman"], [p + ".rsn" for p in paths], ".out", quiet=True, device=CPU)
    for p in paths:
        with open(p, "rb") as f, open(p + ".rsn.out", "rb") as g:
            assert g.read() == f.read()


def test_compressed_file_writes_and_reads(tmp_path):
    cf = raisin_tpu_torch.CompressedFile("lzss", device=CPU)
    assert cf.write(DATA) == len(cf.compressed)
    assert cf.compressed == lzss_ref.compress(DATA)
    assert cf.read(10) + cf.read() == DATA
    path = tmp_path / "x.rsn"
    path.write_bytes(cf.compressed)
    again = core.get_compressed_file_from_path(str(path), device=CPU)
    again.compression_engine = "lzss"
    assert again.read() == DATA


def test_several_devices_name_their_roadmap_item(tmp_path, monkeypatch):
    """``devices`` shards the container: 2 and "auto" (one CPU entry) give the unsharded bytes,
    raw streams ignore it, and 99 raises ValueError before any file is written. (The name dates
    from when the port refused ``devices``.)"""
    src = tmp_path / "in.txt"
    src.write_bytes(DATA)
    want = raisin_tpu.compress_file(["lzss", "arithmetic"], str(src), str(tmp_path / "jax.rsn"), quiet=True,
                                    container=True, block_size=256)
    for devices in (2, "auto", None):
        out = tmp_path / f"{devices}.rsn"
        got = raisin_tpu_torch.compress_file(["lzss", "arithmetic"], str(src), str(out), quiet=True, container=True,
                                             block_size=256, devices=devices, device=CPU)
        assert got == want == out.read_bytes()
        back = raisin_tpu_torch.decompress_file(["lzss", "arithmetic"], str(out), str(out) + ".out", quiet=True,
                                                devices=devices, device=CPU)
        assert back == DATA
    raw = raisin_tpu_torch.compress_file(["lzss"], str(src), str(src) + ".rsn", quiet=True, devices=2, device=CPU)
    monkeypatch.setattr("os.cpu_count", lambda: 8)  # the CPU entries a count may name
    assert raw == lzss_ref.compress(DATA)
    for call in (
        lambda: raisin_tpu_torch.compress_file(["lzss"], str(src), str(tmp_path / "x.rsn"), quiet=True, devices=99,
                                               container=True, device=CPU),
        lambda: raisin_tpu_torch.decompress_file(["lzss"], str(src), str(tmp_path / "x.out"), quiet=True,
                                                 devices=99, device=CPU),
    ):
        with pytest.raises(ValueError, match="devices=99: more than the"):
            call()
    assert not (tmp_path / "x.rsn").exists() and not (tmp_path / "x.out").exists()


@pytest.mark.parametrize("name", ["mcc", "dmc", "flate", "gzip", "lzw", "zlib", "all", "suite"])
def test_host_only_codecs_name_their_roadmap_item(name):
    """The host-only codecs of ROADMAP Queue 1 item 19, and ``all`` and ``suite`` through them,
    write the JAX package's bytes under the auto order, and each package decodes the other's."""
    algorithms = ["lzss", name]
    want = raisin_tpu.compress_bytes(DATA, algorithms)
    got = raisin_tpu_torch.compress_bytes(DATA, algorithms, device=CPU)
    assert got == want
    # dmc's decoder is the reference's stub (b"Hello!"), so `all` and `suite` do not round-trip
    back = raisin_tpu.decompress_bytes(got, algorithms)
    assert raisin_tpu_torch.decompress_bytes(want, algorithms, device=CPU) == back
    assert (back == DATA) == (name not in ("dmc", "all", "suite"))


def test_unknown_codec_raises_like_jax():
    for compress in (raisin_tpu.compress_bytes, functools.partial(raisin_tpu_torch.compress_bytes, device=CPU)):
        with pytest.raises(KeyError, match="unknown compression algorithm"):
            compress(b"abc", ["bogus"])


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: raisin_tpu_torch.compress_bytes(DATA, ["arithmetic"]),  # auto: the card first
        lambda: raisin_tpu_torch.compress_bytes(DATA, ["huffman"]),
        lambda: raisin_tpu_torch.compress_bytes(DATA, ["lzss"], backend="device"),
        lambda: raisin_tpu_torch.decompress_bytes(huffman_ref.compress(DATA), ["huffman"], backend="device"),
        lambda: raisin_tpu_torch.compress_container(DATA),
        lambda: lzss_stream.compress(DATA, 2048),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the host and native backends never touch a device, nor does auto where no device codec exists
    for backend in ("host", "native"):
        assert raisin_tpu_torch.compress_bytes(DATA, ["arithmetic"], backend=backend) == arithmetic_ref.compress(DATA)
    assert raisin_tpu_torch.compress_bytes(DATA, ["mcc"]) == raisin_tpu_torch.compress_bytes(DATA, ["mcc"], "host")


def test_raw_stream_decode_needs_no_card(monkeypatch):
    """Raw lzss and arithmetic streams decode on the host, as in the JAX package: the device
    codecs, first in the auto order, take them with the native C runtime, without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layered = arithmetic_ref.compress(lzss_ref.compress(DATA))
    for algorithms, stream in ((["lzss", "arithmetic"], layered), (["arithmetic"], arithmetic_ref.compress(DATA)),
                               (["lzss"], lzss_ref.compress(DATA))):
        assert raisin_tpu_torch.decompress_bytes(stream, algorithms) == DATA
        assert raisin_tpu_torch.decompress_bytes(stream, algorithms, backend="device") == DATA
    with pytest.raises(RuntimeError, match="no CUDA device"):  # a decode by kernel C still needs the card
        arithmetic_scan.decompress(arithmetic_ref.compress(DATA), out_len=len(DATA))


def test_registry_matches_jax():
    from raisin_tpu.engine import registry as jax_registry

    assert registry.ENGINES == jax_registry.ENGINES and registry.SUITES == jax_registry.SUITES
    assert registry.expand_algorithms(["all"]) == jax_registry.expand_algorithms(["all"])
    for name in ("arithmetic", "lzss"):
        assert registry.available_backends(name) == ["device", "host", "native"]
        assert registry.get_codec(name, device=CPU).backend == "device"  # auto: the card first
        assert registry.get_codec(name, "native").backend == "native"
        assert registry.get_codec(name, "host").backend == "host"
    assert registry.available_backends("huffman") == ["device", "host"]
    assert registry.get_codec("huffman", device=CPU).backend == "device"
    assert registry.get_codec("huffman", "native", device=CPU).backend == "device"  # absent: the auto order
    # a window past the card's search takes the next backend of the auto order, and no other
    assert registry.get_codec("lzss", device=CPU, window=1 << 16).backend == "native"
    assert registry.get_codec("lzss", device=CPU, window=65535).backend == "device"
    assert registry.get_codec("lzss", "device", device=CPU, window=1 << 16).backend == "device"
    assert registry.get_codec("arithmetic", device=CPU, window=1 << 16).backend == "device"
    for name in ("mcc", "dmc"):
        assert registry.available_backends(name) == ["host", "native"]
        assert registry.get_codec(name).backend == "native"
    for name in ("flate", "gzip", "lzw", "zlib"):
        assert registry.available_backends(name) == jax_registry.available_backends(name) == ["host"]
        assert registry.get_codec(name, "device").backend == "host"
    assert registry._FALLBACK_ORDER == ("device", "native", "host")


def test_stream_ranges_are_recorded():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        c = raisin_tpu_torch.compress_bytes(DATA[:300], ["lzss", "arithmetic"], backend="device", device=CPU)
        raisin_tpu_torch.compress_bytes(DATA[:300], ["huffman"], backend="device", device=CPU)
        raisin_tpu_torch.decompress_bytes(c, ["lzss", "arithmetic"], backend="device", device=CPU)
    names = {e.name for e in prof.events() if e.name.startswith("stream.")}
    assert names == {
        "stream.compress", "stream.decompress", "stream.enc.h2d", "stream.enc.escape", "stream.enc.match",
        "stream.enc.commit", "stream.enc.events", "stream.enc.expand", "stream.enc.huffman", "stream.enc.d2h",
    }


LZSS_INPUTS = {
    "text": random_text(1000, seed=62),
    "escape_heavy": (b"<<<\\\xff,,>>>" * 60)[:480],
    "binary": random_bytes(900, seed=63),
    "verse": VERSE[:1000],
}


@pytest.mark.parametrize("window", [16, 4096, 8191])
@pytest.mark.parametrize("name", LZSS_INPUTS)
def test_lzss_stream_equals_jax_and_the_oracle(name, window):
    data = LZSS_INPUTS[name]
    got = lzss_stream.compress(data, window, device=CPU)
    assert got == lzss_jax.compress(data, window) == lzss_ref.compress(data, window)
    assert lzss_stream.decompress(got, device=CPU) == data


def test_lzss_stream_at_the_widest_window_equals_the_oracle():
    data = (bytes(range(256)) * 4 + b"\x00" * 2000 + bytes(range(256)) * 2)
    got = lzss_stream.compress(data, 65535, device=CPU)
    assert got == lzss_ref.compress(data, 65535)
    assert b"<" in got and lzss_stream.decompress(got, device=CPU) == data


def test_lzss_stream_edges():
    assert lzss_stream.compress(b"", device=CPU) == b"" == lzss_jax.compress(b"")
    for window in (0, 65536):
        with pytest.raises(ValueError, match="ROADMAP Queue 1 item 16"):
            lzss_stream.compress(b"abc", window, device=CPU)


HUFFMAN_INPUTS = {
    "hello": HELLO,
    "abc": ABC,
    "verse": VERSE,
    "text": random_text(1500, seed=64),
    "unicode": UNICODE_TEXT,  # non-ASCII: wide kernels G and H on the runes
    "binary": random_bytes(600, seed=65),  # non-ASCII: wide kernels G and H on the runes
}


@pytest.mark.parametrize("name", HUFFMAN_INPUTS)
def test_huffman_stream_equals_jax_and_the_oracle(name):
    data = HUFFMAN_INPUTS[name]
    huffman_blocks.reset_host_split()
    got = huffman_stream.compress(data, device=CPU)
    assert got == huffman_jax.compress(data) == huffman_ref.compress(data)
    assert huffman_stream.decompress(got, device=CPU) == huffman_jax.decompress(got) == huffman_ref.decompress(got)
    assert huffman_blocks.host_split == {"encode": 0, "decode": 0}  # the stream never takes the host split


def test_huffman_stream_edges():
    with pytest.raises(ValueError, match="cannot compress empty input"):
        huffman_stream.compress(b"", device=CPU)
    one = huffman_stream.compress(b"s" * 50, device=CPU)
    assert one == huffman_jax.compress(b"s" * 50) == huffman_ref.compress(b"s" * 50)
    for decode in (huffman_jax.decompress, huffman_ref.decompress,
                   functools.partial(huffman_stream.decompress, device=CPU)):
        with pytest.raises(ValueError, match="single-symbol stream is not decodable"):
            decode(one)
        with pytest.raises(ValueError, match="missing header separator"):
            decode(b"no separator")


def test_huffman_stream_takes_a_large_block():
    # one block of the whole input, well past the container's 64 KiB
    data = random_text(200_000, seed=66)
    got = huffman_stream.compress(data, device=CPU)
    assert got == huffman_ref.compress(data)
    assert huffman_stream.decompress(got, device=CPU) == data


LZSS_ORACLE_INPUTS = [b"", HELLO, ABC, VERSE, (b"<<<\\\xff,,>>>" * 40), random_bytes(500, seed=67)]


@pytest.mark.parametrize("i", range(len(LZSS_ORACLE_INPUTS)))
def test_copied_lzss_oracle_equals_the_original(i):
    data = LZSS_ORACLE_INPUTS[i]
    enc = lzss_ref.encode_opening_symbols(data)
    assert port_lzss.encode_opening_symbols(data) == enc
    assert port_lzss.decode_opening_symbols(enc) == port_lzss.decode_opening_symbols_np(enc) == data
    for window in (16, 4096):
        refs = lzss_ref.find_matches(enc, window)
        assert port_lzss.find_matches(enc, window) == refs
        assert port_lzss.commit_tokens(enc, refs) == lzss_ref.commit_tokens(enc, refs)
        stream = lzss_ref.compress(data, window)
        assert port_lzss.compress(data, window) == stream
        assert port_lzss.decompress(stream) == lzss_ref.decompress(stream) == data
    assert port_lzss._go_atoi(bytearray(b"12")) == 12 and port_lzss._go_atoi(bytearray(b"x")) == 0


@pytest.mark.parametrize("window", [1, 7, 64, 4096])
@pytest.mark.parametrize("kind", ["random", "repetitive", "runs"])
def test_copied_match_search_equals_the_original(kind, window):
    """The copy finds each match length by doubling and halving it, where lzss_ref grows it a
    byte a search: every position's (D, L) must be the original's."""
    data = {
        "random": random_bytes(400, seed=68),
        "repetitive": random_text(37, seed=69) * 12,
        "runs": b"a" * 200 + b"ab" * 60 + b"<\\>" * 30 + b"a" * 90,
    }[kind]
    enc = lzss_ref.encode_opening_symbols(data)
    assert [port_lzss._match_at(enc, i, window) for i in range(len(enc))] == \
        [lzss_ref._match_at(enc, i, window) for i in range(len(enc))]


@pytest.mark.parametrize("name", ["arithmetic", "lzss,arithmetic"])
def test_chip_smoke_oracle_stream_is_the_oracles(name):
    import bench
    import chip_smoke

    data = bench.make_corpus(chip_smoke.STREAM_BYTES)
    in_sha, size, out_sha = chip_smoke.ORACLE_STREAM[name]
    assert chip_smoke.sha(data) == in_sha
    if name == "lzss,arithmetic":
        data = lzss_ref.compress(data, chip_smoke.WINDOW)
    stream = arithmetic_ref.compress(data)
    assert (len(stream), chip_smoke.sha(stream)) == (size, out_sha)


def test_port_engine_runs_without_jax():
    repo = Path(__file__).resolve().parent.parent
    code = (
        "import sys\n"
        "import raisin_tpu_torch as rt\n"
        "d = b'the engine runs without jax ' * 40\n"
        "for algs in (['lzss', 'arithmetic'], ['huffman'], ['lzss', 'huffman']):\n"
        "    c = rt.compress_bytes(d, algs, backend='device', device='cpu')\n"
        "    assert rt.decompress_bytes(c, algs, backend='device', device='cpu') == d, algs\n"
        "leaked = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raisin_tpu.')))\n"
        "assert not leaked and 'raisin_tpu' not in sys.modules, leaked\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(repo)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
