"""The port's RSNB container against the JAX package's, byte for byte.

``raisin_tpu_torch.parallel`` on the CPU runs the plain PyTorch versions of
its kernels; ``raisin_tpu.parallel`` runs on CPU JAX. For the
``("arithmetic",)`` and ``("lzss", "arithmetic")`` pipelines the two must
write identical containers and each must decode the other's (tolerance 0:
the outputs are bytes). The Huffman and LZSS-only containers are in
tests/test_torch_huffman_container.py.
"""

from __future__ import annotations

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raisin_tpu.native
from raisin_tpu.formats import arithmetic_ref, lzss_ref
from raisin_tpu.parallel import blocks as jax_blocks
from raisin_tpu_torch.parallel import blocks as port_blocks
from tests.fixtures import random_bytes, random_text

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BLOCK_SIZES = [512, 2048]
INPUTS = {
    "text": lambda bs: random_text(5000, seed=90),
    "binary": lambda bs: random_bytes(3000, seed=91),
    "escape_heavy": lambda bs: (b"<<<\\\xff,,>>>" * 400)[:3500],
    "ragged_tail": lambda bs: random_text(2 * bs + 77, seed=92),
    "empty": lambda bs: b"",
    "one_block": lambda bs: random_text(bs, seed=93),
}
CASES = [(name, bs) for name in INPUTS for bs in BLOCK_SIZES]


@pytest.fixture(scope="module", autouse=True)
def _own_native_cache(tmp_path_factory):
    """Builds of the JAX package's native library (its host encode above window 8191) go to
    this module's directory."""
    patch = pytest.MonkeyPatch()
    patch.setattr(raisin_tpu.native, "_CACHE", str(tmp_path_factory.mktemp("native")))
    yield
    patch.undo()


@functools.cache
def _containers(name: str, bs: int):
    """(data, JAX container, port container) for one case."""
    data = INPUTS[name](bs)
    jax_c = jax_blocks.compress_container(data, ("arithmetic",), block_size=bs)
    port_c = port_blocks.compress_container(data, ("arithmetic",), block_size=bs, device="cpu")
    return data, jax_c, port_c


@pytest.mark.parametrize("name, bs", CASES)
def test_port_container_equals_jax(name, bs):
    data, jax_c, port_c = _containers(name, bs)
    assert port_c == jax_c
    _, _, orig, payloads, aux, _ = port_blocks.parse_container(port_c)
    assert orig == len(data) and aux == []
    assert payloads == [arithmetic_ref.compress(data[i : i + bs]) for i in range(0, max(len(data), 1), bs)]


@pytest.mark.parametrize("name, bs", CASES)
def test_port_decodes_jax_container(name, bs):
    data, jax_c, _ = _containers(name, bs)
    assert port_blocks.decompress_container(jax_c, device="cpu") == data


@pytest.mark.parametrize("name, bs", CASES)
def test_jax_decodes_port_container(name, bs):
    data, _, port_c = _containers(name, bs)
    assert jax_blocks.decompress_container(port_c) == data


def test_framing_matches_jax():
    data, jax_c, _ = _containers("ragged_tail", 512)
    parsed = port_blocks.parse_container(jax_c)
    assert parsed == jax_blocks.parse_container(jax_c)
    algorithms, bs, orig, payloads, aux, window = parsed
    assert port_blocks.assemble_container(payloads, aux, algorithms, bs, window, orig) == jax_c
    aux_tables = [[len(p) + 1 for p in payloads], [7] * len(payloads)]
    assert port_blocks.assemble_container(
        payloads, aux_tables, ("lzss", "arithmetic"), bs, 2048, orig
    ) == jax_blocks.assemble_container(payloads, aux_tables, ("lzss", "arithmetic"), bs, 2048, orig)


@pytest.mark.parametrize("algorithms", [("huffman", "arithmetic"), ("mcc",), ("gzip",)])
def test_unported_pipelines_name_their_roadmap_item(algorithms):
    """Pipelines without a device path (ROADMAP Queue 1 item 19) go block by block through the
    engine, as in the JAX package: the same containers, and each package decodes the other's."""
    data = INPUTS["text"](512)
    want = jax_blocks.compress_container(data, algorithms, block_size=512, window=2048)
    got = port_blocks.compress_container(data, algorithms, block_size=512, window=2048, device="cpu")
    assert got == want
    assert port_blocks.decompress_container(want, device="cpu") == data
    assert jax_blocks.decompress_container(got) == data


def test_missing_eof_raises_like_jax():
    # block 0 holds 5 bytes but its stream goes on past them: no EOF at 5
    c = port_blocks.assemble_container(
        [arithmetic_ref.compress(b"abcdefgh"), arithmetic_ref.compress(b"de")],
        [], ("arithmetic",), 5, 4096, 7,
    )
    for decode in (jax_blocks.decompress_container, functools.partial(port_blocks.decompress_container, device="cpu")):
        with pytest.raises(ValueError, match="block 0 missing EOF"):
            decode(c)


def test_length_check_raises_like_jax():
    # header says 10 bytes in blocks of 4, but only two payloads follow
    c = port_blocks.assemble_container(
        [arithmetic_ref.compress(b"abcd"), arithmetic_ref.compress(b"efgh")],
        [], ("arithmetic",), 4, 4096, 10,
    )
    for decode in (jax_blocks.decompress_container, functools.partial(port_blocks.decompress_container, device="cpu")):
        with pytest.raises(ValueError, match="decoded 8 bytes, expected 10"):
            decode(c)


def test_port_runs_without_jax():
    code = (
        "import sys\n"
        "import raisin_tpu_torch, raisin_tpu_torch.parallel.blocks as b\n"
        "d = bytes(range(256)) * 16\n"
        "c = b.compress_container(d, ('arithmetic',), block_size=1024, device='cpu')\n"
        "assert b.decompress_container(c, device='cpu') == d\n"
        "e = b'<lzss \\\\ round trip \\xff> ' * 200\n"
        "c = b.compress_container(e, ('lzss', 'arithmetic'), block_size=1024, window=512, device='cpu')\n"
        "assert b.decompress_container(c, device='cpu') == e\n"
        "t = b'the huffman and lzss containers round trip ' * 60\n"
        "for algs in (('huffman',), ('lzss', 'huffman'), ('lzss',)):\n"
        "    c = b.compress_container(t, algs, block_size=1024, window=512, device='cpu')\n"
        "    assert b.decompress_container(c, device='cpu') == t, algs\n"
        "leaked = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raisin_tpu.')))\n"
        "assert not leaked and 'raisin_tpu' not in sys.modules, leaked\n"
        "print('ok', len(c))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_never_import_jax_or_the_jax_package():
    sources = sorted((REPO / "raisin_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                    REPO / "scripts" / "ci_bench_torch.sh"]
    assert len(sources) > 10
    for path in sources:
        text = path.read_text()
        # at any indentation, lazily or not; comments and docstrings may name JAX files
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
        assert not re.search(r"^\s*(import|from)\s+raisin_tpu\b(?!_torch)", text, re.M), path


@pytest.mark.parametrize(
    "n, bs, want_lengths",
    [(0, 4, [0]), (3, 4, [3]), (4, 4, [4]), (9, 4, [4, 4, 1]), (12, 4, [4, 4, 4])],
)
def test_block_lengths_split_like_jax(n, bs, want_lengths):
    data = bytes(range(1, n + 1))
    W, lengths = port_blocks._block_lengths(n, bs)
    assert lengths.tolist() == want_lengths and W == max(want_lengths)
    jax_split = [data[i : i + bs] for i in range(0, len(data), bs)] or [b""]
    assert [data[i * W : i * W + k] for i, k in enumerate(lengths)] == jax_split


def test_host_device_bytes_round_trip():
    for buf in (b"", b"abc", memoryview(b"xyzw")[1:3]):
        t = port_blocks._h2d(buf, torch.device("cpu"))
        assert t.dtype == torch.uint8 and port_blocks._d2h(t) == bytes(buf)


def test_rows_payloads_and_payload_rows_invert():
    rows = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], dtype=torch.uint8)
    lens = torch.tensor([2, 0, 4], dtype=torch.int32)
    flat = port_blocks._rows_payloads(rows, lens)
    assert flat.tolist() == [1, 2, 9, 10, 11, 12]
    back = port_blocks._payload_rows(flat, lens, 5)
    assert back.tolist() == [[1, 2, 0, 0, 0], [0] * 5, [9, 10, 11, 12, 0]]


def test_batches_give_the_same_container(monkeypatch):
    assert port_blocks._batch_blocks(torch.device("cpu"), 9, 65537) >= 64
    data = np.random.default_rng(3).integers(0, 256, 3000, dtype=np.uint8).tobytes()
    one = port_blocks.compress_container(data, ("arithmetic",), block_size=256, device="cpu")
    monkeypatch.setattr(
        port_blocks, "CPU_BATCH_BYTES", 3 * (port_blocks.CPU_BYTES_PER_STEP * 257 + 64)
    )
    assert port_blocks._batch_blocks(torch.device("cpu"), 9, 257) == 3
    many = port_blocks.compress_container(data, ("arithmetic",), block_size=256, device="cpu")
    assert many == one
    assert port_blocks.decompress_container(many, device="cpu") == data


def test_overflow_flag_raises_on_the_cpu(monkeypatch):
    # the row bound keeps oflow 0, on the plain versions as on the card;
    # a forced flag for block 1 raises on the CPU too, no host re-encode
    encode = port_blocks.pipeline.arith_encode_rows

    def flag_block_1(x, lengths):
        rows, byte_lens, oflow = encode(x, lengths)
        oflow[1] = 1
        return rows, byte_lens, oflow

    monkeypatch.setattr(port_blocks.pipeline, "arith_encode_rows", flag_block_1)
    data = INPUTS["ragged_tail"](512)
    with pytest.raises(RuntimeError, match="block 1 over the row bound"):
        port_blocks.compress_container(data, ("arithmetic",), block_size=512, device="cpu")


def test_overflow_flag_from_the_card_raises():
    with pytest.raises(RuntimeError, match="block 9 over the row bound"):
        port_blocks._check_no_overflow(np.array([0, 1, 0, 1], dtype=np.int32), 8)
    port_blocks._check_no_overflow(np.zeros(4, np.int32), 0)


def test_entry_points_record_their_stages():
    data = random_text(1500, seed=94)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        c = port_blocks.compress_container(data, ("arithmetic",), block_size=512, device="cpu")
        assert port_blocks.decompress_container(c, device="cpu") == data
    names = {e.name for e in prof.events() if e.name.startswith("rsnb.")}
    assert names == {
        "rsnb.compress", "rsnb.enc.h2d", "rsnb.enc.coder", "rsnb.enc.select", "rsnb.enc.d2h",
        "rsnb.decompress", "rsnb.dec.h2d", "rsnb.dec.coder", "rsnb.dec.eof_check", "rsnb.dec.d2h",
    }


def test_truncated_container_raises():
    c = port_blocks.compress_container(b"truncate me " * 50, ("arithmetic",), block_size=256, device="cpu")
    with pytest.raises(ValueError, match="past the end"):
        port_blocks.decompress_container(c[:-1], device="cpu")


def test_chip_smoke_oracle_blocks_are_the_oracles():
    import bench
    import chip_smoke

    data = bench.make_corpus(chip_smoke.MAIN_BYTES)
    bs = chip_smoke.BLOCK_SIZE
    payloads = [b""] * (len(data) // bs)
    for i in chip_smoke.ORACLE_BLOCKS:
        payloads[i] = arithmetic_ref.compress(data[i * bs : (i + 1) * bs])
    chip_smoke.check_oracle_blocks(data, payloads)


# ---------------------------------------------------------------------------
# ("lzss", "arithmetic"), the default pipeline

LZ = ("lzss", "arithmetic")
LZ_INPUTS = {
    "text": lambda bs: random_text(bs + bs // 2, seed=95),
    "binary": lambda bs: random_bytes(bs + bs // 2, seed=96),
    "escape_heavy": lambda bs: (b"<<\\\\\xff,<\\x>>\xff\xff" * bs)[: bs + bs // 2],
    "zeros": lambda bs: b"\x00" * (bs + bs // 2),
    "ragged_tail": lambda bs: random_text(2 * bs + 77, seed=97),
    "empty": lambda bs: b"",
    "one_block": lambda bs: random_text(bs, seed=98),
}
# every input at the default window; the other windows on the inputs that
# reach them (JAX compiles each shape and window once, which sets the cost)
LZ_CASES = [(name, bs, 4096) for name in LZ_INPUTS for bs in (512, 4096)] + [
    (name, 4096, window) for name in ("text", "escape_heavy") for window in (2048, 8191)
]


@functools.cache
def _lz_containers(name: str, bs: int, window: int):
    """(data, JAX container, port container) for one lzss,arithmetic case."""
    data = LZ_INPUTS[name](bs)
    jax_c = jax_blocks.compress_container(data, LZ, block_size=bs, window=window)
    port_c = port_blocks.compress_container(data, LZ, block_size=bs, window=window, device="cpu")
    return data, jax_c, port_c


@pytest.mark.parametrize("name, bs, window", LZ_CASES)
def test_port_lzss_container_equals_jax(name, bs, window):
    data, jax_c, port_c = _lz_containers(name, bs, window)
    assert port_c == jax_c
    algorithms, _, orig, payloads, aux, got_window = port_blocks.parse_container(port_c)
    assert (algorithms, orig, got_window) == (LZ, len(data), window)
    blocks = [data[i : i + bs] for i in range(0, len(data), bs)] or [b""]
    assert aux == [[len(lzss_ref.compress(b, window)) for b in blocks]]
    if bs == 512:  # the pure-Python arithmetic oracle, where it is quick
        assert payloads == [arithmetic_ref.compress(lzss_ref.compress(b, window)) for b in blocks]


@pytest.mark.parametrize("name, bs, window", LZ_CASES)
def test_port_decodes_jax_lzss_container(name, bs, window):
    data, jax_c, _ = _lz_containers(name, bs, window)
    assert port_blocks.decompress_container(jax_c, device="cpu") == data


@pytest.mark.parametrize("name, bs, window", LZ_CASES)
def test_jax_decodes_port_lzss_container(name, bs, window):
    data, _, port_c = _lz_containers(name, bs, window)
    assert jax_blocks.decompress_container(port_c) == data


def test_default_pipeline_is_lzss_arithmetic():
    data = random_text(700, seed=99)
    c = port_blocks.compress_container(data, block_size=512, device="cpu")
    assert c == port_blocks.compress_container(data, LZ, block_size=512, window=4096, device="cpu")
    assert port_blocks.parse_container(c)[0] == LZ


@pytest.mark.parametrize("window", [0, 65536])
def test_lzss_window_outside_the_card_range_raises(window):
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 16"):
        port_blocks.compress_container(b"abc" * 10, LZ, block_size=16, window=window, device="cpu")


def test_lzss_five_digit_window_round_trips_through_the_oracle():
    # zeros reach a match at distance 12000 at window 12000: a five-digit token
    data = b"\x00" * 21000 + random_text(500, seed=100)
    c = port_blocks.compress_container(data, LZ, block_size=1 << 16, window=12000, device="cpu")
    assert c == jax_blocks.compress_container(data, LZ, block_size=1 << 16, window=12000)
    _, _, _, payloads, aux, _ = port_blocks.parse_container(c)
    tokens = lzss_ref.compress(data, 12000)
    assert b"<12000," in tokens and aux == []
    assert payloads == [arithmetic_ref.compress(tokens)]
    assert port_blocks.decompress_container(c, device="cpu") == data
    assert jax_blocks.decompress_container(c) == data


def test_lzss_container_without_aux_names_its_roadmap_item():
    """An lzss,arithmetic container without an aux table (ROADMAP Queue 1 item 17) decodes, in
    both packages, block by block on the host."""
    data = b"no aux table " * 20
    payload = arithmetic_ref.compress(lzss_ref.compress(data, 4096))
    c = port_blocks.assemble_container([payload], [], LZ, 4096, 4096, len(data))
    assert port_blocks.decompress_container(c, device="cpu") == data == jax_blocks.decompress_container(c)


# above window 8191 the JAX package encodes lzss,arithmetic on the host and writes no aux table
WIDE_WINDOWS = [8191, 8192, 16384, 65535]


@functools.cache
def _wide_window_containers(window: int):
    """(data, JAX container, port container): three blocks of 5000 B and a ragged one."""
    data = (random_text(6000, seed=101) * 3)[:15700]
    jax_c = jax_blocks.compress_container(data, LZ, block_size=5000, window=window)
    port_c = port_blocks.compress_container(data, LZ, block_size=5000, window=window, device="cpu")
    return data, jax_c, port_c


@pytest.mark.parametrize("window", WIDE_WINDOWS)
def test_lzss_container_at_wide_windows_equals_jax(window):
    data, jax_c, port_c = _wide_window_containers(window)
    assert port_c == jax_c
    _, _, orig, payloads, aux, got_window = port_blocks.parse_container(port_c)
    blocks = [data[i : i + 5000] for i in range(0, len(data), 5000)]
    tokens = [lzss_ref.compress(b, window) for b in blocks]
    assert (orig, got_window, len(payloads)) == (len(data), window, 4)
    assert aux == ([[len(t) for t in tokens]] if window <= 8191 else [])


@pytest.mark.parametrize("window", WIDE_WINDOWS)
def test_lzss_containers_at_wide_windows_decode_in_both_packages(window):
    data, jax_c, port_c = _wide_window_containers(window)
    assert port_blocks.decompress_container(jax_c, device="cpu") == data
    assert jax_blocks.decompress_container(port_c) == data


def test_lzss_container_without_aux_raises_on_a_corrupt_payload_like_jax():
    data = random_text(3000, seed=102)
    payload = arithmetic_ref.compress(lzss_ref.compress(data, 16384))
    c = port_blocks.assemble_container([payload[: len(payload) // 2]], [], LZ, 4096, 16384, len(data))
    with pytest.raises(ValueError) as jax_err:
        jax_blocks.decompress_container(c)
    # both decode the block through decompress_bytes, so through the native C runtime
    with pytest.raises(ValueError, match=r"^rsn_arith_decompress: malformed stream \(ended without EOF symbol\?\)$"):
        port_blocks.decompress_container(c, device="cpu")
    assert str(jax_err.value) == "rsn_arith_decompress: malformed stream (ended without EOF symbol?)"


def test_lzss_container_without_aux_checks_the_total_like_jax():
    # the header says 5 bytes more than the block decodes to
    data = random_text(900, seed=103)
    payload = arithmetic_ref.compress(lzss_ref.compress(data, 16384))
    c = port_blocks.assemble_container([payload], [], LZ, 4096, 16384, len(data) + 5)
    for decode in (jax_blocks.decompress_container, functools.partial(port_blocks.decompress_container, device="cpu")):
        with pytest.raises(ValueError, match=f"decoded {len(data)} bytes, expected {len(data) + 5}"):
            decode(c)


def test_lzss_missing_eof_raises_like_jax():
    # the aux table says 3 token bytes, but the stream goes on past them
    tok = lzss_ref.compress(b"abcdefgh", 4096)
    c = port_blocks.assemble_container([arithmetic_ref.compress(tok)], [[3]], LZ, 8, 4096, 8)
    for decode in (jax_blocks.decompress_container, functools.partial(port_blocks.decompress_container, device="cpu")):
        with pytest.raises(ValueError, match="block 0 missing EOF"):
            decode(c)


def test_lzss_decoded_length_check_raises_like_jax():
    # block 1's tokens decode to 3 bytes where the header expects 4; the
    # port checks each block, as the JAX package's device path does
    # (_dec_tail), and its CPU path the whole output
    toks = [lzss_ref.compress(b"abcd", 4096), lzss_ref.compress(b"efg", 4096)]
    c = port_blocks.assemble_container(
        [arithmetic_ref.compress(t) for t in toks], [[len(t) for t in toks]], LZ, 4, 4096, 8
    )
    with pytest.raises(ValueError, match="decoded 7 bytes, expected 8"):
        jax_blocks.decompress_container(c)
    with pytest.raises(ValueError, match="block 1 decoded 3 bytes, expected 4"):
        port_blocks.decompress_container(c, device="cpu")


def test_lzss_reference_outside_the_output_raises():
    tok = b"ab<5,2>"
    c = port_blocks.assemble_container([arithmetic_ref.compress(tok)], [[len(tok)]], LZ, 4, 4096, 4)
    with pytest.raises(ValueError, match="reference outside decoded window"):
        lzss_ref.decompress(tok)
    with pytest.raises(ValueError, match="block 0: reference outside decoded window"):
        port_blocks.decompress_container(c, device="cpu")


def test_lzss_entry_points_record_their_stages():
    data = random_text(600, seed=101)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        c = port_blocks.compress_container(data, LZ, block_size=256, window=64, device="cpu")
        assert port_blocks.decompress_container(c, device="cpu") == data
    names = {e.name for e in prof.events() if e.name.startswith("rsnb.")}
    assert names == {
        "rsnb.compress", "rsnb.enc.h2d", "rsnb.enc.escape", "rsnb.enc.match", "rsnb.enc.commit",
        "rsnb.enc.coder", "rsnb.enc.select", "rsnb.enc.d2h",
        "rsnb.decompress", "rsnb.dec.h2d", "rsnb.dec.coder", "rsnb.dec.eof_check", "rsnb.dec.walk",
        "rsnb.dec.unescape", "rsnb.dec.d2h",
    }


def test_lzss_batches_give_the_same_container(monkeypatch):
    data = random_text(3000, seed=102)
    one = port_blocks.compress_container(data, LZ, block_size=256, device="cpu")
    monkeypatch.setattr(port_blocks, "CPU_BATCH_BYTES", 3 * (port_blocks.CPU_BYTES_PER_STEP * 257 + 64))
    many = port_blocks.compress_container(data, LZ, block_size=256, device="cpu")
    assert many == one
    assert port_blocks.decompress_container(many, device="cpu") == data


def test_lzss_overflow_flag_raises_on_the_cpu(monkeypatch):
    # as for ("arithmetic",): a forced oflow for block 1 of the token streams' rows raises
    encode = port_blocks.pipeline.arith_encode_rows

    def flag_block_1(x, lengths):
        rows, byte_lens, oflow = encode(x, lengths)
        oflow[1] = 1
        return rows, byte_lens, oflow

    monkeypatch.setattr(port_blocks.pipeline, "arith_encode_rows", flag_block_1)
    data = LZ_INPUTS["ragged_tail"](512)
    with pytest.raises(RuntimeError, match="block 1 over the row bound"):
        port_blocks.compress_container(data, LZ, block_size=512, window=4096, device="cpu")
