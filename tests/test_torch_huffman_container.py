"""The port's ("huffman",), ("lzss", "huffman") and ("lzss",) containers against the JAX package's.

``raisin_tpu_torch.parallel`` on the CPU runs the plain PyTorch versions
of its kernels; ``raisin_tpu.parallel`` runs on CPU JAX. The two must write
identical containers, aux tables included, and each must decode the
other's (tolerance 0: the outputs are bytes); where the JAX package
raises, the port raises the same message. The JAX package decodes the
LZSS pipelines through ``get_codec("lzss", backend="native")``, whose
library build is pointed at a directory of this module's own.
"""

from __future__ import annotations

import functools

import pytest
import torch

import raisin_tpu.native
import tests.test_torch_container as base
from raisin_tpu.formats import huffman_ref, lzss_ref
from raisin_tpu.parallel import blocks as jax_blocks
from raisin_tpu_torch.ops import huffman_blocks
from raisin_tpu_torch.parallel import blocks as port_blocks
from tests.fixtures import random_text

torch.set_num_threads(1)

HUFF, LZ_HUFF, LZ = ("huffman",), ("lzss", "huffman"), ("lzss",)
BLOCK_SIZES = base.BLOCK_SIZES
# ASCII inputs decode; the others change length through Go's rune
# iteration (huffman) or carry '<', 0x5C or 0xFF (escaped to non-ASCII tokens)
ROUND_TRIPS = {HUFF: {"text", "ragged_tail", "one_block"}, LZ_HUFF: {"text", "ragged_tail", "one_block"}}
CASES = [(algs, name, bs, 4096) for algs in (HUFF, LZ_HUFF, LZ) for name in base.INPUTS for bs in BLOCK_SIZES] + [
    (algs, name, 2048, window) for algs in (LZ_HUFF, LZ) for name in ("text", "escape_heavy") for window in (2048, 8191)
]


@pytest.fixture(scope="module", autouse=True)
def _own_native_cache(tmp_path_factory):
    """Builds of the JAX package's native library go to this module's directory."""
    patch = pytest.MonkeyPatch()
    patch.setattr(raisin_tpu.native, "_CACHE", str(tmp_path_factory.mktemp("native")))
    yield
    patch.undo()


def _call(fn, *args, **kwargs):
    """fn's result, or the message of the ValueError it raised."""
    try:
        return fn(*args, **kwargs)
    except ValueError as e:
        return ValueError(str(e))


@functools.cache
def _containers(algs, name: str, bs: int, window: int):
    """(data, JAX container or its error, port container or its error) for one case."""
    data = base.INPUTS[name](bs)
    jax_c = _call(jax_blocks.compress_container, data, algs, block_size=bs, window=window)
    port_c = _call(port_blocks.compress_container, data, algs, block_size=bs, window=window, device="cpu")
    return data, jax_c, port_c


def _same(a, b) -> bool:
    return a == b if isinstance(a, bytes) else isinstance(b, ValueError) and str(a) == str(b)


@pytest.mark.parametrize("algs, name, bs, window", CASES)
def test_port_container_equals_jax(algs, name, bs, window):
    data, jax_c, port_c = _containers(algs, name, bs, window)
    assert _same(jax_c, port_c)
    if name == "empty" and algs != LZ:
        assert "cannot compress empty input" in str(port_c)
        return
    got_algs, _, orig, payloads, aux, got_window = port_blocks.parse_container(port_c)
    assert (got_algs, orig, got_window) == (algs, len(data), window)
    blocks = [data[i : i + bs] for i in range(0, len(data), bs)] or [b""]
    tokens = [lzss_ref.compress(b, window) for b in blocks] if algs != HUFF else blocks
    assert aux == ([[len(t) for t in tokens]] if algs == LZ_HUFF else [])
    assert payloads == (tokens if algs == LZ else [huffman_ref.compress(t) for t in tokens])


@pytest.mark.parametrize("algs, name, bs, window", CASES)
def test_port_decodes_jax_container(algs, name, bs, window):
    data, jax_c, _ = _containers(algs, name, bs, window)
    if not isinstance(jax_c, bytes):
        return
    got = _call(port_blocks.decompress_container, jax_c, device="cpu")
    if algs == LZ or name in ROUND_TRIPS[algs]:
        assert got == data
    elif algs == HUFF:
        assert _same(_call(jax_blocks.decompress_container, jax_c), got)  # "decoded N bytes, expected M"
    else:
        # non-ASCII tokens decode to more token bytes than the aux table says:
        # the port raises there, the JAX package on the total length
        assert "its aux table says" in str(got)


@pytest.mark.parametrize("algs, name, bs, window", CASES)
def test_jax_decodes_port_container(algs, name, bs, window):
    data, jax_c, port_c = _containers(algs, name, bs, window)
    if not isinstance(port_c, bytes):
        return
    assert _same(_call(jax_blocks.decompress_container, port_c), _call(jax_blocks.decompress_container, jax_c))
    if algs == LZ or name in ROUND_TRIPS[algs]:
        assert jax_blocks.decompress_container(port_c) == data


@pytest.mark.parametrize("algs", [LZ_HUFF, LZ])
def test_window_past_8191_round_trips_with_the_oracle_payloads(algs):
    # zeros reach a match at distance 12000 at window 12000: a five-digit token
    data = b"\x00" * 21000 + random_text(500, seed=110)
    c = port_blocks.compress_container(data, algs, block_size=1 << 16, window=12000, device="cpu")
    _, _, _, payloads, aux, _ = port_blocks.parse_container(c)
    tokens = lzss_ref.compress(data, 12000)
    assert b"<12000," in tokens
    assert payloads == ([huffman_ref.compress(tokens)] if algs == LZ_HUFF else [tokens])
    assert aux == ([[len(tokens)]] if algs == LZ_HUFF else [])
    assert port_blocks.decompress_container(c, device="cpu") == data
    assert jax_blocks.decompress_container(c) == data


def test_aux_entry_disagreeing_with_the_decoded_tokens_raises():
    toks = [lzss_ref.compress(b"abcabcabcabc", 4096), lzss_ref.compress(b"xyzxyzxy", 4096)]
    payloads = [huffman_ref.compress(t) for t in toks]
    c = port_blocks.assemble_container(payloads, [[len(toks[0]), len(toks[1]) + 1]], LZ_HUFF, 12, 4096, 20)
    with pytest.raises(ValueError, match="block 1 decoded 8 token bytes, its aux table says 9"):
        port_blocks.decompress_container(c, device="cpu")


def test_lzss_huffman_without_an_aux_table_decodes():
    data = random_text(3000, seed=111)
    c = port_blocks.compress_container(data, LZ_HUFF, block_size=1024, device="cpu")
    _, bs, orig, payloads, _, window = port_blocks.parse_container(c)
    bare = port_blocks.assemble_container(payloads, [], LZ_HUFF, bs, window, orig)
    assert port_blocks.decompress_container(bare, device="cpu") == data == jax_blocks.decompress_container(bare)


def test_stream_ending_inside_a_code_raises_like_jax():
    data = random_text(1500, seed=112)
    c = port_blocks.compress_container(data, HUFF, block_size=512, device="cpu")
    algs, bs, orig, payloads, aux, window = port_blocks.parse_container(c)
    for cut in range(1, 4):
        bad = port_blocks.assemble_container([payloads[0], payloads[1][:-cut], payloads[2]], aux, algs, bs, window, orig)
        want = _call(jax_blocks.decompress_container, bad)
        if isinstance(want, ValueError) and "inside a code" in str(want):
            assert _same(want, _call(port_blocks.decompress_container, bad, device="cpu"))
            return
    pytest.fail("no cut ended inside a code")


def test_non_ascii_blocks_take_the_host_split_and_are_counted():
    data = random_text(1200, seed=113) + "naïve résumé".encode() * 40
    huffman_blocks.reset_host_split()
    c = port_blocks.compress_container(data, HUFF, block_size=512, device="cpu")
    assert c == jax_blocks.compress_container(data, HUFF, block_size=512)
    assert huffman_blocks.host_split == {"encode": 2, "decode": 0}
    assert port_blocks.decompress_container(c, device="cpu") == data
    assert huffman_blocks.host_split == {"encode": 2, "decode": 2}


@pytest.mark.parametrize(
    "algs, stages",
    [
        (HUFF, {"rsnb.enc.count", "rsnb.enc.tree", "rsnb.enc.huffman", "rsnb.enc.frame",
                "rsnb.dec.tree", "rsnb.dec.rows", "rsnb.dec.huffman", "rsnb.dec.d2h"}),
        (LZ_HUFF, {"rsnb.enc.escape", "rsnb.enc.match", "rsnb.enc.commit", "rsnb.enc.count", "rsnb.enc.tree",
                   "rsnb.enc.huffman", "rsnb.enc.frame", "rsnb.dec.tree", "rsnb.dec.rows", "rsnb.dec.huffman",
                   "rsnb.dec.walk", "rsnb.dec.unescape", "rsnb.dec.d2h"}),
        (LZ, {"rsnb.enc.escape", "rsnb.enc.match", "rsnb.enc.commit", "rsnb.enc.select",
              "rsnb.dec.walk", "rsnb.dec.unescape", "rsnb.dec.d2h"}),
    ],
)
def test_entry_points_record_their_stages(algs, stages):
    data = random_text(600, seed=114)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        c = port_blocks.compress_container(data, algs, block_size=256, window=64, device="cpu")
        assert port_blocks.decompress_container(c, device="cpu") == data
    names = {e.name for e in prof.events() if e.name.startswith("rsnb.")}
    assert names == stages | {"rsnb.compress", "rsnb.enc.h2d", "rsnb.enc.d2h", "rsnb.decompress", "rsnb.dec.h2d"}


def test_batches_give_the_same_container(monkeypatch):
    data = random_text(3000, seed=115)
    one = {a: port_blocks.compress_container(data, a, block_size=256, device="cpu") for a in (HUFF, LZ_HUFF, LZ)}
    monkeypatch.setattr(port_blocks, "CPU_BATCH_BYTES", 3 * (port_blocks.CPU_BYTES_PER_STEP * 513 + 64))
    for a, c in one.items():
        assert port_blocks.compress_container(data, a, block_size=256, device="cpu") == c
        assert port_blocks.decompress_container(c, device="cpu") == data


def test_chip_smoke_huffman_oracle_blocks_are_the_oracles():
    import bench
    import chip_smoke

    data = bench.make_corpus(chip_smoke.MAIN_BYTES)
    bs = chip_smoke.BLOCK_SIZE
    payloads = [b""] * (len(data) // bs)
    tok_lens = [0] * len(payloads)
    for i in chip_smoke.ORACLE_BLOCKS_HUFF:
        tokens = lzss_ref.compress(data[i * bs : (i + 1) * bs], chip_smoke.WINDOW)
        payloads[i] = huffman_ref.compress(tokens)
        tok_lens[i] = len(tokens)
    chip_smoke.check_oracle_blocks_huff(data, payloads, tok_lens)
