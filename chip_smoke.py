#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raisin_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --match    # kernel D alone: build, then time_match without the plain version
    python3 chip_smoke.py --encode   # kernel A alone: build, then time_encode
    python3 chip_smoke.py --decode   # kernel C alone: build, then time_decode without the plain version
    python3 chip_smoke.py --events   # kernel I alone: build, then time_events without the plain version
    python3 chip_smoke.py --hdecode  # kernel H alone: build, then time_hdecode without the plain version
    python3 chip_smoke.py --commit   # kernel E alone: build, then time_commit without the plain version
    python3 chip_smoke.py --walk     # kernel F alone: build, then time_walk without the plain version
    python3 chip_smoke.py --hencode  # kernel G alone: build, then time_hencode without the plain version
    python3 chip_smoke.py --prepad   # kernel B alone: build, then time_prepad without the plain version
    python3 chip_smoke.py --paths    # phase 3 alone: the main paths and the streams, without traces
    python3 chip_smoke.py --cli      # the cli phase alone, after the default container and the wide window
    python3 chip_smoke.py --runes    # the runes phase alone: wide kernels G and H, the rune streams
    python3 chip_smoke.py --ci       # the ci phase alone: the port's CI benchmark page on the card
    python3 chip_smoke.py --cards    # several cards: the mesh, NCCL ranks under torchrun, the sharded step, the dry run
    python3 chip_smoke.py --step-rank R WORLD URL NPZ [--per-card]  # one rank of a sharded step (started by a phase)

Phases, each printing one line; any failure exits nonzero before the
result line:

1. require a CUDA card, print its name and power limit (nvidia-smi), build
   the kernels from raisin_tpu_torch/csrc into raisin_tpu_torch/_build
   (one nvcc per source, all started together);
2. each kernel against its plain PyTorch version on the card, exactly, on
   128 edge-case blocks of <= 2 KiB: A encode, B prepad, C decode (also,
   against the plain version on the host, at row pitches of every residue
   mod 4, on garbage rows and on a block that freezes the model; B also on
   garbage past every stream and on raw rows off 16 bytes), I event
   records, and, at
   windows 16 and 4096, D match search, E commit and F token walk; D, E
   and F also on 24 KiB run-heavy blocks at window 16384 (five-digit
   tokens) and on blocks whose escaped bytes outgrow shared memory, at
   windows 4096 and 16384 (D's device-memory sweep); G
   Huffman encode and H Huffman decode on the ASCII edge blocks, a block
   whose longest code has 21 bits, a single-symbol block, uniform random
   ASCII (7-bit codes), two symbols (1-bit codes), four blocks over
   several of H's spans and kernel E's
   token streams at windows 16 and 4096, while the non-ASCII edge blocks
   take the host split, are counted and equal the port's copy of the
   oracle; D also over the distance sub-ranges (0, w/2], (w/2, w] and
   (3, w - 5] at windows w = 16 and 4096 (the sharded step's search), each
   against its plain version with its tiles by path, and the halves' MAX
   combine against the whole window's launch;
3. each main path through the entry points a user calls, on a 64 MiB
   corpus (bench.make_corpus) at 64 KiB blocks: first
   ``compress_container(data, ("arithmetic",))``, then the default
   ``compress_container(data, ("lzss", "arithmetic"), window=4096)``, then
   ``("lzss", "huffman")`` at window 4096, each with
   ``decompress_container``. The launch counts are reset just before a
   path's runs and read after its first; the round trips must be exact,
   every kernel of the path must have launched, every tile of kernel D
   must have taken its chain path, no lzss,huffman block may take the
   host split, and four sampled payloads must equal the host
   oracle's (ORACLE_BLOCKS, ORACLE_BLOCKS_LZSS, ORACLE_BLOCKS_HUFF); timed
   over TIMED_RUNS round trips; then one more round trip under
   torch.profiler for the time breakdown (host ms per stage range, device
   ms per kernel and copy, and the device's busy share of each call).
   ``("huffman",)`` and ``("lzss",)`` round-trip the same 64 MiB the same
   way, without the trace, and one ``lzss,arithmetic`` container of
   WIDE_BYTES at window WIDE_WINDOW must carry no aux table (as the JAX
   package writes it above window 8191) and round-trip through its
   per-block host decode. Then the stream path: the engine's
   ``compress_bytes(data, algorithms, backend="device")`` on the first
   STREAM_BYTES of the corpus for ``lzss,arithmetic``, ``arithmetic``,
   ``huffman`` and ``lzss`` (one block each, so each kernel runs on one
   SM), whose arithmetic outputs must equal the host oracle's
   (ORACLE_STREAM); kernel A must not launch there; MB/s over TIMED_RUNS
   compress calls, one round trip of each through ``decompress_bytes``
   (raw streams decode on the host, as in the JAX package), one through
   ``compress_file``/``decompress_file`` in raw and container mode, and one
   traced ``lzss,arithmetic`` compress;
3b. the cli phase: the port's command line (``raisin_tpu_torch.cli.main``)
   as a user runs it, on the card. ``raisin -container`` on the 64 MiB
   corpus must write phase 3's default container byte for byte and launch
   kernels A, B, D and E; ``grape`` must give the corpus back and launch C
   and F; the same compress under ``-profile=DIR`` must leave one Chrome
   trace naming kernels D and A. On the 1 MiB stream, ``raisin`` (auto: the
   card, D, E and I) and ``raisin -backend=native`` must write
   ORACLE_STREAM's bytes and ``grape`` must give it back (a raw stream
   decodes with the native C runtime), and the compress and decompress
   MB/s of the auto order and of each backend is printed for CLI_STREAMS
   (over TIMED_RUNS runs, host once: its copies are Python). ``raisin
   -benchmark -backend=device`` on CLI_BENCH_BYTES must print five lossless
   rows and launch D, E, G, H and I; one gzip container of CLI_HOST_BYTES
   (block by block through the engine) must round-trip;
3b'. the runes phase (after the stream phase): wide kernels G and H (the
   Huffman stream's rune alphabet) against their plain versions, exactly, at
   three shapes: the stream of the corpus's kennedy.xls at scale 1.0, an
   alphabet of RUNE_WIDE_DISTINCT code points (past kernel G's shared-memory
   table, so its device-memory table runs) and the RUNE_EDGES rows; the
   ``huffman`` device stream of kennedy.xls through ``compress_bytes`` and
   ``decompress_bytes`` (launch counts from 0) equal to the port's oracle
   copy and to its rune iteration, the RUNE_FAULT_RUNES stream (past the
   oracle's 900,000-rune decode cap) round-tripping, no host split, and
   the compress and decompress MB/s; the ci phase (after the cli phase):
   ``write_ci_page`` (scripts/ci_bench_torch.sh) over the corpus at scale
   0.05 on the card, every row's compressed bytes and lossless flag equal
   to the host backend's, with each row's time;
3c. the mesh phase: ``compress_container(data, ("lzss", "arithmetic"),
   mesh=data_mesh())`` (every card) must equal phase 3's default container
   and ``decompress_container(c, mesh=...)`` give the corpus back, over
   TIMED_RUNS round trips, with launch counts from 0 and the MB/s beside
   phase 3's; ``compress_file(..., container=True, devices="auto")`` and
   ``raisin -container -devices=auto`` must write the same bytes, and
   ``raisin -devices=2`` must exit 1 naming the cards there are;
3d. the two-rank phase: two processes of
   ``raisin_tpu_torch.parallel.multihost_worker`` on the one card (gloo:
   NCCL refuses two ranks on one GPU) encode their block ranges of
   TWO_RANK_BYTES of the corpus, and the rank-order container must equal
   the one-process container; two ranks of this script (``--step-rank``)
   run ``sharded_pipeline_step`` at model_axis=2 on STEP_B blocks of
   STEP_S bytes, which must equal the step at model_axis=1 and
   ``lzss_tokens`` + ``encode_blocks``, each rank launching D, E and I; a
   world-of-1 NCCL group runs its all_reduce(MAX) on the card;
3e. the entry phase: ``entry()``'s forward on the card (D, E and I once
   each) against its plain version, and ``dryrun_multichip(2)`` on the
   card (gloo), which holds every payload and block against the oracle
   copies;
4. each kernel at its main path's shapes, timed with CUDA events, beside
   its plain version, outputs compared exactly (the plain A and C run on
   the first PLAIN_BLOCKS blocks at full step length, the plain I on the
   stream's whole shape, all three as CPU tensors on the host; the
   arithmetic main path's first PLAIN_BLOCKS blocks equal the plain A + B's
   and every block the plain prepad of kernel A's rows, and the CPU tests
   hold the plain versions against the host oracle), with the least time the card could take for the same work (``bound_ms``: the
   larger of the bytes it must move over the H100 SXM's 3.35 TB/s and
   the integer operations that the function needs on these inputs, by
   the least-work method known for it, over the card's INT32 issue rate,
   PEAK_INT_OPS_PER_S). Kernels A and C run on four inputs
   (``DECODE_INPUTS``): the corpus in the arithmetic and the lzss,arithmetic
   containers, and MAIN_BYTES of random bytes and of zero bytes, each as the
   container hands it to the kernel (A: with a digest of its output, no
   overflow; C: the rows of kernels A + B, held against the plain version on
   the containers' rows, and giving back each input). Kernel I, whose main path is the
   stream, is timed at the stream's shape, and at the
   arithmetic container's shape beside kernel A, where its records,
   expanded and packed, must equal kernels A + B on every block; the
   device ms of each of its three passes at both shapes come from the
   profiler's kernel names. Kernel D
   runs on four inputs (``MATCH_INPUTS``): the corpus at the container's
   shape, the stream's shape, and MAIN_BYTES of zero bytes and of random
   bytes in 64 KiB blocks, each held exactly against its plain version; its
   tile counters must show the chain path on the corpus, the stream and
   the random bytes, and the sweep path on the zeros. Kernel H is held
   against its plain version at the lzss,huffman container's shape, at the
   huffman stream's (B = 1) and on uniform random ASCII in 64 KiB blocks
   (the plain version on the first PLAIN_BLOCKS), with the device ms of
   its three kernels at the first two shapes. Kernel E is held against its
   plain version at the container's shape and at the lzss,arithmetic
   stream's (B = 1), with the device ms of its three kernels at both.
   Kernel F is held against its plain version at the lzss,arithmetic
   container's shape, on MAIN_BYTES of zero bytes through kernels D and E,
   and on a chain of tokens "<6,6>" that each copy the one before.
   Kernel D is also timed over the sub-ranges (0, 2048] and (2048, 4096] at
   the container's shape, each held against its plain version with its
   tiles by path, and their MAX combine against the whole window.
   Kernel G is held against its plain version on each of HENCODE_INPUTS
   (both Huffman containers' rows, the huffman stream and the whole corpus
   as one block, uniform ASCII and skewed bytes in BLOCK_SIZE blocks), with
   the host's bit totals as the container hands them over, and kernel B on
   kernel A's rows of each of PREPAD_INPUTS (DECODE_INPUTS); G's stream row
   joins its entry in the kernel table.

``--match`` runs phase 1 and then only kernel D on its four inputs, with a
digest of its output per input and no plain version; ``--encode`` and
``--decode`` do the same for kernels A and C on theirs, and ``--events``
for kernel I on ``EVENTS_INPUTS`` (the 1 MiB stream, the 1 MiB
lzss,arithmetic stream's tokens, 1 MiB of random bytes and of zeros, each
at B = 1, and the arithmetic container's shape), with each device
kernel's ms from the profiler; ``--hdecode`` does the same for kernel H
on ``HDECODE_INPUTS`` (the lzss,huffman and huffman containers' rows,
the 1 MiB huffman stream at B = 1, uniform random ASCII at both shapes),
each checked to give back its blocks; ``--commit`` does the same for
kernel E on ``COMMIT_INPUTS`` (the corpus and zeros at the container's
shape and at the 1 MiB stream's, B = 1, MAIN_BYTES of random bytes in
64 KiB blocks, each with L and D from kernel D, and the field L = 2 after
a literal at both shapes); ``--walk`` does the same for kernel F on
``WALK_INPUTS`` (the lzss,arithmetic container's token rows, MAIN_BYTES of
zero bytes and of random bytes through kernels D and E, and two chains of
tokens at the container's shape), each checked to give back its input, with
the kernel's rounds where it reports them; ``--hencode`` does the same for
kernel G on ``HENCODE_INPUTS`` (also each call followed by the host's read
of byte_lens, as the container reads G's result) and ``--prepad`` for
kernel B on ``PREPAD_INPUTS``, each with its device kernels' ms from the
profiler; ``--cli`` runs phase 1, the default container, the WIDE_WINDOW
container and the cli phase; ``--runes`` and ``--ci`` run phase 1 and then
the runes or the ci phase; ``--paths`` runs phase 1 and then
phase 3 without its traces and without the WIDE_WINDOW container (an
earlier tree writes an aux table there). Copied into another checkout of the
repository (an earlier commit, say), the script measures that tree's code
the same way, so two trees compare on one card; equal digests mean equal
outputs.

The second-to-last line is the kernel table as JSON, the last line the
result object. Nothing of JAX is imported.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MAIN_BYTES = 64 << 20  # bench.py's input size and block size
BLOCK_SIZE = 65536
TIMED_RUNS = 5  # timed round trips of the main path; MB/s as median, min, max
# Sampled blocks of bench.make_corpus(MAIN_BYTES): block index -> (sha256
# of the input block, payload length, sha256 of the payload that the host
# oracle raisin_tpu.formats.arithmetic_ref.compress writes for it), first
# 32 hex digits each. tests/test_torch_container.py recomputes them with the
# oracle; here they stand in for it, since this script imports nothing of
# the JAX package.
ORACLE_BLOCKS = {
    0: ("9de9388755bcc78e3ceb1a7319b3403d", 36207, "681b0b7bd393d7c6f4fa1ce38fbd31cf"),
    341: ("3be9ca082e2c2bbbcf62566eb1ce58df", 36212, "393800dfb5d2cbfeb5c467ae53d3c5df"),
    682: ("4ac05729736bf2a137f7a2d3413b2921", 36205, "a2ca2910ff85fa64fc2bca92a7307261"),
    1023: ("63f616a552d407d5841d9c0319a2bc3a", 36199, "754934cc456c9487993e704a402c9da6"),
}
# The same for ("lzss", "arithmetic") at window 4096: block index -> (sha256
# of the input block, token-stream length, payload length, sha256 of the
# payload of raisin_tpu.formats.arithmetic_ref.compress(lzss_ref.compress(
# block, 4096))); tests/test_torch_lzss.py recomputes them.
WINDOW = 4096
ORACLE_BLOCKS_LZSS = {
    0: ("9de9388755bcc78e3ceb1a7319b3403d", 44035, 23934, "f2f47a7205d14f1584f9f2ac09f4c23e"),
    341: ("3be9ca082e2c2bbbcf62566eb1ce58df", 44012, 23925, "60d6e358e5a84e5e0030bd60a67cf545"),
    682: ("4ac05729736bf2a137f7a2d3413b2921", 44003, 23995, "7c60e15d15a103303f26ee3fa46bfcb7"),
    1023: ("63f616a552d407d5841d9c0319a2bc3a", 43926, 23782, "01981d0c5856ca297d58e33b5ca28257"),
}
LZ = ("lzss", "arithmetic")
# The same for ("lzss", "huffman") at window 4096: block index -> (sha256 of
# the input block, token-stream length, payload length, sha256 of the
# payload of raisin_tpu.formats.huffman_ref.compress(lzss_ref.compress(
# block, 4096))); tests/test_torch_huffman_container.py recomputes them.
ORACLE_BLOCKS_HUFF = {
    0: ("9de9388755bcc78e3ceb1a7319b3403d", 44035, 24027, "329d93bf4d7db38169e707683e78181c"),
    341: ("3be9ca082e2c2bbbcf62566eb1ce58df", 44012, 24002, "6a60e9a1b3ce9adb90be9537a456cc9a"),
    682: ("4ac05729736bf2a137f7a2d3413b2921", 44003, 24085, "a03371ed0db63cb7f7b036cff869448b"),
    1023: ("63f616a552d407d5841d9c0319a2bc3a", 43926, 23864, "713c5178e361512c98a2d8696ae829f2"),
}
LZ_HUFF = ("lzss", "huffman")
# phase 3's container above window 8191: the corpus's first WIDE_BYTES in BLOCK_SIZE blocks
WIDE_WINDOW = 16384
WIDE_BYTES = 384 << 10
# The stream phase: the engine's single-stream codecs on the first
# STREAM_BYTES of the corpus (bench.make_corpus(STREAM_BYTES), the same
# bytes). Pipeline -> (sha256 of the input, output length, sha256 of the
# output of raisin_tpu.formats.arithmetic_ref.compress, after
# lzss_ref.compress(data, 4096) for lzss,arithmetic), first 32 hex digits
# each; tests/test_torch_engine.py recomputes them with the oracles.
STREAM_BYTES = 1 << 20
ORACLE_STREAM = {
    "lzss,arithmetic": ("412b3ce7f53d52966faf766423478f56", 374556, "e7de00ff37b7f3157b8390fdf3bdb052"),
    "arithmetic": ("412b3ce7f53d52966faf766423478f56", 576680, "4a0d0b800446c548ae9cc868b099d444"),
}
# The cli phase: the benchmark table's input and the host-pipeline (gzip) container's
CLI_BENCH_BYTES = 256 << 10
CLI_HOST_BYTES = 4 << 20
# the raw streams timed on each backend (native, device, host)
CLI_STREAMS = ("lzss", "arithmetic", "lzss,arithmetic")

# The runes phase: the Huffman stream on inputs with bytes >= 0x80 (wide kernels G and H).
# Invalid UTF-8 edge inputs, each a row of one batch: overlongs, surrogates, past U+10FFFF,
# bytes that never lead, lone continuations, sequences cut at the end (each beside the valid
# rune next to it); tests/test_torch_runes.py holds the port's rune decode against the
# oracle's on each
RUNE_EDGES = (
    b"\xc0\x80", b"\xc1\xbf", b"\xe0\x80\x80", b"\xe0\x9f\xbf", b"\xf0\x80\x80\x80", b"\xf0\x8f\xbf\xbf",
    b"\xed\xa0\x80", b"\xed\xbf\xbf", b"\xed\x9f\xbf",
    b"\xf4\x90\x80\x80", b"\xf4\x8f\xbf\xbf",
    b"\xf5\x80\x80\x80", b"\xf8\x88\x80\x80\x80", b"\xfe\xff", b"\xff",
    b"\x80", b"\xbf\xbf", b"a\x80b\x80\x80\x80c",
    b"\xc3", b"\xe2\x82", b"\xf0\x9f\x98", b"ab\xe2\x82",
    "naïve € 中 😀".encode() + b"\xe2\x28\xa1\xf0\x28\x8c\x28\xc3",
)
RUNE_WIDE_DISTINCT = 100_000  # the runes phase's alphabet past kernel G's shared-memory table
RUNE_FAULT_RUNES = 950_000  # runes of "abcdé€ñ中" from seed 0: past the oracle's 900,000-rune decode cap
RUNE_FAULT_ALPHABET = "abcdé€ñ中"

# the card's peaks for bound_ms: the H100 SXM data sheet's memory rate, and
# its INT32 issue rate: 132 SMs x 64 INT32 lanes (Hopper architecture) at the
# 1.98 GHz that the data sheet's 67 TFLOP/s float32 implies (132 SMs x 128
# lanes x 2 operations an FMA); a quarter of that float32 figure
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 132 * 64 * 1.98e9

KERNELS = {
    "arith_encode": (
        "raisin_tpu_torch/csrc/arith_encode.cu",
        "raisin_tpu/ops/arithmetic_pallas.py:272",
    ),
    "arith_prepad": (
        "raisin_tpu_torch/csrc/arith_prepad.cu",
        "raisin_tpu/ops/arithmetic_pallas.py:473",
    ),
    "arith_decode": (
        "raisin_tpu_torch/csrc/arith_decode.cu",
        "raisin_tpu/ops/arithmetic_pallas.py:674",
    ),
    "lzss_match": (
        "raisin_tpu_torch/csrc/lzss_match.cu",
        "raisin_tpu/ops/lzss_jax.py:51",
    ),
    "lzss_commit": (
        "raisin_tpu_torch/csrc/lzss_commit.cu",
        "raisin_tpu/ops/lzss_commit_pallas.py:41",
    ),
    "lzss_decode": (
        "raisin_tpu_torch/csrc/lzss_decode.cu",
        "raisin_tpu/ops/lzss_decode_pallas.py:42",
    ),
    "huffman_encode": (
        "raisin_tpu_torch/csrc/huffman_encode.cu",
        "raisin_tpu/ops/huffman_pallas.py:63",
    ),
    "huffman_decode": (
        "raisin_tpu_torch/csrc/huffman_decode.cu",
        "raisin_tpu/ops/huffman_pallas.py:211",
    ),
    "arith_events": (
        "raisin_tpu_torch/csrc/arith_events.cu",
        "raisin_tpu/ops/arithmetic_pallas.py:58",
    ),
    # kernels G and H widened to the Huffman stream's runes: the JAX stream's device encode and decode
    "huffman_encode_wide": (
        "raisin_tpu_torch/csrc/huffman_encode.cu",
        "raisin_tpu/ops/huffman_jax.py:42",
    ),
    "huffman_decode_wide": (
        "raisin_tpu_torch/csrc/huffman_decode.cu",
        "raisin_tpu/ops/huffman_jax.py:61",
    ),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def edge_blocks(n_blocks: int = 128, size: int = 2048) -> list[bytes]:
    """The shapes of tests/test_ops_pallas.py:_payload_matrix at ``size``,
    then seeded blocks of mixed content and length up to ``size``."""
    rng = np.random.default_rng(7)
    verse = (
        b"the quick brown fox jumps over the lazy dog\n"
        b"pack my box with five dozen liquor jugs\n"
    ) * 64
    out = [
        b"",
        b"a",
        b"hello world, hello world, hello",
        b"\xff" * (size - 20),
        (b"ab" * size)[: size - 13],
        bytes(rng.integers(0, 256, size=size - 40, dtype=np.uint8)),
        (verse * 6)[: size - 9],
        b"<<<<,,,>>>>" * 8,
        b"\x00" * size,
        bytes(rng.integers(0, 256, size=size, dtype=np.uint8)),
        bytes(rng.choice(np.array([0x5C, 0xFF], dtype=np.uint8), size=size)),  # escapes to 2x
    ]
    while len(out) < n_blocks:
        n = int(rng.integers(0, size + 1))
        kind = len(out) % 3
        if kind == 0:
            out.append(bytes(rng.integers(0, 256, size=n, dtype=np.uint8)))
        elif kind == 1:
            out.append(bytes(rng.integers(97, 101, size=n, dtype=np.uint8)))
        else:
            out.append((verse[int(rng.integers(0, 64)) :] * 2)[:n])
    return out


def fault_stream() -> bytes:
    """RUNE_FAULT_RUNES runes drawn from RUNE_FAULT_ALPHABET with seed 0, as UTF-8."""
    alphabet = np.array(list(RUNE_FAULT_ALPHABET))
    return "".join(alphabet[np.random.default_rng(0).integers(0, len(alphabet), RUNE_FAULT_RUNES)]).encode()


def wide_alphabet_stream(distinct: int = RUNE_WIDE_DISTINCT, seed: int = 16) -> bytes:
    """``distinct`` valid code points >= U+0080 drawn from ``seed``, each 1-19 times, shuffled, as UTF-8."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([np.arange(0x80, 0xD800), np.arange(0xE000, 0x110000)])
    runes = np.repeat(rng.choice(pool, distinct, replace=False), rng.integers(1, 20, distinct))
    rng.shuffle(runes)
    return "".join(map(chr, runes.tolist())).encode()


def padded(blocks: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Block bytes -> ((B, max length) uint8 zero-padded, lengths (B,) int32)."""
    m = np.zeros((len(blocks), max(len(b) for b in blocks)), dtype=np.uint8)
    for i, b in enumerate(blocks):
        m[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return m, np.array([len(b) for b in blocks], dtype=np.int32)


def batch(matrix: np.ndarray, lengths: np.ndarray, device):
    """Blocks -> (coder symbols (B, W + 1) int32, lengths (B,) int32) on ``device``."""
    import torch
    import torch.nn.functional as F

    from raisin_tpu_torch.ops import pipeline

    x = F.pad(torch.from_numpy(matrix).to(device), (0, 1))
    n = torch.from_numpy(lengths).to(device)
    return pipeline.arith_symbols(x, n), n


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()[:32]


def check_oracle_blocks(data: bytes, payloads: list[bytes]) -> None:
    """The sampled blocks' payloads equal the host oracle's (ORACLE_BLOCKS)."""
    for i, (in_sha, size, out_sha) in ORACLE_BLOCKS.items():
        check(sha(data[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE]) == in_sha, f"corpus block {i} is not the one sampled")
        check((len(payloads[i]), sha(payloads[i])) == (size, out_sha), f"block {i} differs from the oracle's payload")


def check_oracle_blocks_lzss(data: bytes, payloads: list[bytes], tok_lens: list[int]) -> None:
    """The sampled lzss,arithmetic blocks equal the host oracle's (ORACLE_BLOCKS_LZSS)."""
    for i, (in_sha, tok_len, size, out_sha) in ORACLE_BLOCKS_LZSS.items():
        check(sha(data[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE]) == in_sha, f"corpus block {i} is not the one sampled")
        check(tok_lens[i] == tok_len, f"block {i}'s token length differs from the oracle's")
        check((len(payloads[i]), sha(payloads[i])) == (size, out_sha), f"lzss block {i} differs from the oracle's payload")


def check_oracle_blocks_huff(data: bytes, payloads: list[bytes], tok_lens: list[int]) -> None:
    """The sampled lzss,huffman blocks equal the host oracle's (ORACLE_BLOCKS_HUFF)."""
    for i, (in_sha, tok_len, size, out_sha) in ORACLE_BLOCKS_HUFF.items():
        check(sha(data[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE]) == in_sha, f"corpus block {i} is not the one sampled")
        check(tok_lens[i] == tok_len, f"block {i}'s token length differs from the oracle's")
        check((len(payloads[i]), sha(payloads[i])) == (size, out_sha), f"huffman block {i} differs from the oracle's payload")


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what sets it): bytes over the memory rate or operations over the peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_abs_err(*pairs) -> int:
    """Largest |a - b| over the pairs (0 when the outputs are identical)."""
    import torch

    err = 0
    for a, b in pairs:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_ms(fn):
    """(result, milliseconds) of one call of a plain version, host clock around a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _union_ms(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def _device_group(name: str) -> str:
    """A device event's row in the breakdown: one of KERNELS, a copy kind, or torch's kernels."""
    for kernel in KERNELS:
        if f"{kernel}_kernel" in name:
            return kernel
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    return "torch kernels"


def device_kernel_ms(run, reps: int = 5) -> dict:
    """Device milliseconds of each kernel that ``run()`` launches, by the kernel's name without
    its namespace and arguments: the median over the launches that one torch.profiler session
    of ``reps`` calls recorded (empty when it recorded none). Once a process has run for a
    while, the profiler was seen to drop the device events of a session's first calls, so
    one call a session is not enough."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    launches: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            found = re.search(r"\w*_kernel\w*", e.name)
            launches.setdefault(found.group(0) if found else e.name, []).append(e.time_range.elapsed_us() / 1e3)
    return {name: float(np.median(ms)) for name, ms in launches.items()}


def trace_breakdown(run, prefix: str, calls: tuple[str, ...]) -> dict:
    """Where ``run()`` spends its time, under torch.profiler.

    Reads the trace: host milliseconds of each range whose name starts
    with ``prefix`` (the ``rsnb.*`` ranges of raisin_tpu_torch.parallel.blocks,
    the ``stream.*`` ranges of the engine and its stream codecs), device
    milliseconds by kernel or copy, and for each range name in ``calls``
    the share of its wall time in which the card ran anything. ``device``
    is empty when the trace holds no device activity.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    host: dict[str, float] = {}
    spans_of: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(prefix):
            host[e.name] = host.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            if e.name in calls:
                spans_of.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    spans = [(_device_group(e.name), e.time_range.start, e.time_range.end)
             for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device: dict[str, float] = {}
    for name, s, e in spans:
        device[name] = device.get(name, 0.0) + (e - s) / 1e3
    busy = {}
    if spans:
        for call, ranges in spans_of.items():
            inside = [_union_ms([(max(s, lo), min(e, hi)) for _, s, e in spans if e > lo and s < hi])
                      for lo, hi in ranges]
            busy[call] = sum(inside) / (sum(hi - lo for lo, hi in ranges) / 1e3)
    return {"host_ms": host, "device_ms": device, "device_busy_share": busy}


def trace_container(data: bytes, dev, algorithms: tuple[str, ...]) -> dict:
    """One container compress + decompress through the entry points, traced (:func:`trace_breakdown`)."""
    from raisin_tpu_torch.parallel import blocks

    def run():
        c = blocks.compress_container(data, algorithms, block_size=BLOCK_SIZE, window=WINDOW, device=dev)
        check(blocks.decompress_container(c, device=dev) == data, "traced round trip differs")

    return trace_breakdown(run, "rsnb.", ("rsnb.compress", "rsnb.decompress"))


def phase_kernels_vs_plain(ar, dev) -> None:
    """Phase 2: each kernel equals its plain version on edge-case blocks."""
    import torch

    blocks = edge_blocks()
    symbols, lengths = batch(*padded(blocks), dev)
    capw = ar.capw_bound(symbols.shape[1])

    raw_k, bits_k, of_k = ar.encode_bits(symbols, lengths, capw)
    raw_p, bits_p, of_p = ar._encode_bits_torch(symbols, lengths, capw)
    torch.cuda.synchronize()
    err = max_abs_err((raw_k, raw_p), (bits_k, bits_p), (of_k, of_p))
    check(err == 0, f"kernel A differs from its plain version (max abs err {err})")
    check(int(of_k.max()) == 0, "kernel A flagged an overflow under the row bound")
    print(f"phase kernel A (encode) vs plain: equal on {len(blocks)} blocks, max_abs_err 0", flush=True)

    rows_k, bl_k = ar.prepad_rows(raw_p, bits_p)
    rows_p, bl_p = ar._prepad_torch(raw_p, bits_p)
    torch.cuda.synchronize()
    err = max_abs_err((rows_k, rows_p), (bl_k, bl_p))
    check(err == 0, f"kernel B differs from its plain version (max abs err {err})")
    print(f"phase kernel B (prepad) vs plain: equal on {len(blocks)} blocks, max_abs_err 0", flush=True)
    # garbage in every bit past each stream, which kernel B must clear or not read, and the same
    # rows one row on (off 16 bytes where capw % 4 != 0), whose raw rows are aligned unlike the output's
    T = bits_p.to(torch.int64)[:, None]
    keep = (T - 32 * torch.arange(capw, device=dev)[None, :]).clamp(0, 32)
    past = ((0xFFFFFFFF >> keep) & 0xFFFFFFFF) * (keep < 32)
    junk = torch.randint(0, 2**32, raw_p.shape, generator=torch.Generator(dev).manual_seed(5), device=dev,
                         dtype=torch.int64)
    raw_g = ar._words_to_int32((raw_p.to(torch.int64) & 0xFFFFFFFF) | (junk & past))
    for r, t, what in ((raw_g, bits_p, "garbage past each stream"),
                       (raw_g.view(-1)[capw:].view(-1, capw), bits_p[1:].contiguous(), "rows off 16 bytes")):
        rows_k, bl_k = ar.prepad_rows(r, t)
        rows_p, bl_p = ar._prepad_torch(r, t)
        torch.cuda.synchronize()
        err = max_abs_err((rows_k, rows_p), (bl_k, bl_p))
        check(err == 0, f"kernel B differs from its plain version on {what} (max abs err {err})")
    check(capw % 4 != 0, "the edge rows' pitch is a multiple of 16 bytes")
    print(f"phase kernel B vs plain on garbage past each stream and on raw rows off 16 bytes: equal, "
          f"max_abs_err 0", flush=True)
    rows_p, bl_p = ar._prepad_torch(raw_p, bits_p)

    steps = symbols.shape[1]
    syms_k, eof_k = ar.decode_rows(rows_p, bl_p, lengths, steps)
    syms_p, eof_p = ar._decode_rows_torch(rows_p, bl_p, lengths, steps)
    torch.cuda.synchronize()
    err = max_abs_err((syms_k, syms_p), (eof_k, eof_p))
    check(err == 0, f"kernel C differs from its plain version (max abs err {err})")
    check(bool((eof_k == 1).all()), "kernel C missed an EOF")
    syms_np = syms_k.cpu().numpy()
    for i, b in enumerate(blocks):
        check(syms_np[i, : len(b)].tobytes() == b, f"kernel C did not restore edge block {i}")
    print(f"phase kernel C (decode) vs plain: equal on {len(blocks)} blocks, round trip exact", flush=True)
    decode_edges_vs_plain(ar, rows_p, bl_p, lengths, steps, dev)

    slots_k, s0_k = ar.encode_events(symbols, lengths)
    slots_p, s0_p = ar._encode_events_torch(symbols, lengths)
    torch.cuda.synchronize()
    err = max_abs_err((slots_k, slots_p), (s0_k, s0_p))
    check(err == 0, f"kernel I differs from its plain version (max abs err {err})")
    print(f"phase kernel I (event records) vs plain: slots and slot0 equal on {len(blocks)} blocks, "
          f"max_abs_err 0", flush=True)


def decode_vs_plain(ar, prows, blens, out_lens, steps: int, tag: str):
    """Kernel C against its plain version (on CPU copies of the inputs, the wrapper's route
    for them) on one batch, exactly; returns the kernel's (syms, eof_ok)."""
    syms_k, eof_k = ar.decode_rows(prows, blens, out_lens, steps)
    syms_p, eof_p = ar._decode_rows_torch(prows.cpu(), blens.cpu(), out_lens.cpu(), steps)
    err = max_abs_err((syms_k.cpu(), syms_p), (eof_k.cpu(), eof_p))
    check(err == 0, f"kernel C differs from its plain version on {tag} (max abs err {err})")
    return syms_k, eof_k


def decode_edges_vs_plain(ar, rows, blens, lengths, steps: int, dev) -> None:
    """Phase 2, kernel C on the edges of its design, each held exactly against the plain version
    (run on the host, as in phase 4):
    the edge blocks' payloads at row pitches of every residue mod 4 (rows start unaligned),
    garbage rows (random bytes, lengths and out_lens), and a block long enough to freeze the model."""
    import torch

    from raisin_tpu_torch.parallel import blocks as container

    flat = container._rows_payloads(rows, blens)
    pitches = [int(blens.max()) + extra for extra in (1, 2, 3, 4)]
    for pitch in pitches:
        decode_vs_plain(ar, container._payload_rows(flat, blens, pitch), blens, lengths, steps, f"pitch {pitch}")

    rng = np.random.default_rng(12)
    garbage = (1001, 4099)
    for pitch in garbage:
        B = 64
        prows = torch.from_numpy(rng.integers(0, 256, (B, pitch), dtype=np.uint8)).to(dev)
        bl = torch.from_numpy(rng.integers(-3, pitch + 6, B).astype(np.int32)).to(dev)
        ol = torch.from_numpy(rng.integers(-2, 3000, B).astype(np.int32)).to(dev)
        decode_vs_plain(ar, prows, bl, ol, 2048, f"garbage rows at pitch {pitch}")

    long = [bytes(rng.choice(np.frombuffer(b"abcdefgh  \n<>", np.uint8), size=ar.MAX_FREQ + 4000))]
    symbols, n = batch(*padded(long), dev)
    rows_l, bl_l, _ = ar.encode_rows(symbols, n)
    syms, eof = decode_vs_plain(ar, rows_l, bl_l, n, symbols.shape[1], "a block that freezes the model")
    check(bool(eof.all()) and syms[0, : len(long[0])].cpu().numpy().tobytes() == long[0],
          "kernel C did not restore the block that freezes the model")
    print(f"phase kernel C vs plain on its edges: equal on the edge blocks at pitches {pitches}, on 64 "
          f"garbage rows at each of pitches {list(garbage)}, and on a block of {len(long[0])} B (past the "
          f"model's freeze), max_abs_err 0", flush=True)


def lzss_stages(lz, xe, en, window: int, tag: str):
    """Kernels D, E and F against their plain versions on escaped blocks.

    Returns (max_abs_err per kernel, the kernel's tokens and lengths).
    Every launch here is a comparison launch, not a main-path one.
    """
    import torch

    match, commit, walk = lz
    L_k, D_k = match.find_matches(xe, en, window)
    L_p, D_p = match._find_matches_torch(xe, en, window)
    torch.cuda.synchronize()
    err_d = max_abs_err((L_k, L_p), (D_k, D_p))
    check(err_d == 0, f"kernel D differs from its plain version ({tag}, max abs err {err_d})")
    tok_k, tl_k = commit.commit_tokens(xe, L_k, D_k, en)
    tok_p, tl_p = commit._commit_tokens_torch(xe, L_k, D_k, en)
    torch.cuda.synchronize()
    err_e = max_abs_err((tok_k, tok_p), (tl_k, tl_p))
    check(err_e == 0, f"kernel E differs from its plain version ({tag}, max abs err {err_e})")
    cap_out = 2 * xe.shape[1]
    rows_k, ol_k, fl_k = walk.walk_tokens(tok_k, tl_k, cap_out)
    rows_p, ol_p, fl_p = walk._walk_tokens_torch(tok_k, tl_k, cap_out)
    torch.cuda.synchronize()
    err_f = max_abs_err((rows_k, rows_p), (ol_k, ol_p), (fl_k, fl_p))
    check(err_f == 0, f"kernel F differs from its plain version ({tag}, max abs err {err_f})")
    check(int(fl_k.abs().sum()) == 0 and torch.equal(ol_k, en), f"kernel F faulted ({tag})")
    width = xe.shape[1]
    check(torch.equal(rows_k[:, :width], xe) and not rows_k[:, width:].any(),
          f"kernel F did not restore the escaped blocks ({tag})")
    return {"lzss_match": err_d, "lzss_commit": err_e, "lzss_decode": err_f}, tok_k, tl_k


def phase_lzss_vs_plain(dev) -> None:
    """Phase 2, LZSS: kernels D, E, F equal their plain versions on edge cases."""
    import torch

    from raisin_tpu_torch.ops import escape, lzss_commit, lzss_decode, lzss_match

    lz = (lzss_match, lzss_commit, lzss_decode)
    blocks = edge_blocks()
    m, n = padded(blocks)
    x, n = torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev)
    xe, en = escape.escape_blocks(x, n)
    check(xe.shape[1] == 2 * x.shape[1], "the escape-heavy edge block did not escape to 2x")
    for window in (16, WINDOW):
        lzss_stages(lz, xe, en, window, f"window {window}")
    flat, dec_lens = escape.unescape_rows(xe, en)
    check(flat.cpu().numpy().tobytes() == b"".join(blocks), "the escape layer did not round-trip the edge blocks")
    print(f"phase kernels D (match), E (commit), F (walk) vs plain: equal on {len(blocks)} blocks "
          f"(escaped to {xe.shape[1]} B) at windows 16 and {WINDOW}, walk restores them, max_abs_err 0",
          flush=True)

    # five-digit tokens: matches of 10000+ at window 16384
    size, window = 24 << 10, 16384
    rng = np.random.default_rng(8)
    period = bytes(rng.integers(0, 256, size=12000, dtype=np.uint8))
    big = [b"\x00" * size, (period * 3)[:size], (b"ab" * size)[:size]]
    m, n = padded(big)
    xe, en = escape.escape_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
    _, tok, tl = lzss_stages(lz, xe, en, window, f"window {window}")
    toks = [tok[i, : int(tl[i])].cpu().numpy().tobytes() for i in range(len(big))]
    five = re.compile(rb"<\d{5},|,\d{5}>")
    check(all(five.search(t) for t in toks[:2]), "no five-digit token at window 16384")
    print(f"phase kernels D, E, F vs plain at window {window}: equal on {len(big)} blocks of {size} B "
          f"with five-digit tokens, max_abs_err 0", flush=True)

    # blocks whose escaped bytes outgrow shared memory: at window 4096 kernel D
    # tiles them, at 16384 it sweeps each whole block from device memory
    verse = b"the quick brown fox jumps over the lazy dog\n" * 1200
    huge = [b"\xff" * (110 << 10) + verse, verse * 2]
    m, n = padded(huge)
    xe, en = escape.escape_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
    check(xe.shape[1] > 211 << 10, "the escaped block fits shared memory after all")
    for window in (WINDOW, 16384):
        lzss_stages(lz, xe, en, window, f"{xe.shape[1]} B escaped, window {window}")
    print(f"phase kernels D, E, F vs plain on {xe.shape[1]} B escaped blocks (past shared memory) at "
          f"windows {WINDOW} and 16384: equal, max_abs_err 0", flush=True)


def child_tables(counts: np.ndarray) -> np.ndarray:
    """Kernel H's (B, 64) child tables for blocks of these symbol counts (zero for a single symbol)."""
    from raisin_tpu_torch.formats import huffman as hf
    from raisin_tpu_torch.ops import huffman_blocks as hb
    from raisin_tpu_torch.ops import huffman_rows as hr

    tables = np.zeros((len(counts), hr.NTAB), dtype=np.int32)
    for b, row in enumerate(counts):
        syms = np.nonzero(row)[0]
        if syms.size > 1:
            tables[b] = hb.packed_table(hf.build_tree(dict(zip(syms.tolist(), row[syms].tolist()))))
    return tables


def huffman_stages(x, n, tag: str) -> dict:
    """Kernels G and H against their plain versions on blocks of ASCII bytes.

    The code tables come as the container makes them (counts on the card,
    trees on the host); H walks G's rows back, and every block of two or
    more symbols must decode to itself. Returns max_abs_err per kernel.
    Every launch here is a comparison launch, not a main-path one.
    """
    import torch

    from raisin_tpu_torch.ops import huffman_rows as hr

    dev = x.device
    args, bits, counts = huffman_encode_args(x, n)
    want = ((bits + 7) // 8).cpu().numpy()
    rows_k, bl_k, pad_k = hr.encode_rows(*args)  # the wrapper sums the bits itself
    rows_p, bl_p, pad_p = hr._encode_rows_torch(*args)
    torch.cuda.synchronize()
    err_g = max_abs_err((rows_k, rows_p), (bl_k, bl_p), (pad_k, pad_p))
    check(err_g == 0, f"kernel G differs from its plain version ({tag}, max abs err {err_g})")
    check(bl_k.cpu().numpy().tolist() == want.tolist(), f"kernel G's payload lengths differ from the code tables' ({tag})")

    multi = (counts > 0).sum(1) > 1  # a single-symbol block has no bits to walk
    tables_t = torch.from_numpy(child_tables(counts)).to(dev)
    width = int(n.max())
    cap_out = -(-width // 4) * 4
    out_k, cnt_k, ok_k = hr.decode_rows(rows_k, pad_k, bl_k, tables_t, cap_out)
    out_p, cnt_p, ok_p = hr._decode_rows_torch(rows_k, pad_k, bl_k, tables_t, cap_out)
    torch.cuda.synchronize()
    err_h = max_abs_err((out_k, out_p), (cnt_k, cnt_p), (ok_k, ok_p))
    check(err_h == 0, f"kernel H differs from its plain version ({tag}, max abs err {err_h})")
    m = torch.from_numpy(multi).to(dev)
    check(bool(ok_k.all()) and torch.equal(cnt_k[m], n[m]), f"kernel H did not end every walk at the root ({tag})")
    check(torch.equal(out_k[m][:, :width], x[m][:, :width]), f"kernel H did not restore the blocks ({tag})")
    return {"huffman_encode": err_g, "huffman_decode": err_h}


def uniform_ascii(n: int) -> bytes:
    """Seeded uniform random bytes 0..127: every code of their tree has 7 bits, so walks from
    different bits never resynchronise."""
    return np.random.default_rng(23).integers(0, 128, n, dtype=np.uint8).tobytes()


def fibonacci_block(symbols: int = 22) -> bytes:
    """A shuffled block whose symbol counts are Fibonacci numbers: its longest code has symbols - 1 bits."""
    fib = [1, 1]
    while len(fib) < symbols:
        fib.append(fib[-1] + fib[-2])
    block = np.repeat(np.arange(65, 65 + symbols, dtype=np.uint8), fib)
    np.random.default_rng(9).shuffle(block)
    return block.tobytes()


def phase_huffman_vs_plain(dev) -> None:
    """Phase 2, Huffman: kernels G, H equal their plain versions on edge cases."""
    import torch

    import bench
    from raisin_tpu_torch.formats import huffman as hf
    from raisin_tpu_torch.ops import escape, huffman_blocks, huffman_rows, lzss_commit, lzss_match

    edge = [b for b in edge_blocks() if b]
    ascii_blocks = [b for b in edge if max(b) < 0x80]
    fib = fibonacci_block()
    longest = max(len(c) for c in hf.print_codes(hf.build_tree({s: fib.count(s) for s in set(fib)}))[1])
    check(longest >= 20, f"the Fibonacci block's longest code has {longest} bits")
    rng = np.random.default_rng(29)
    two = bytes(rng.choice(np.frombuffer(b"ab", np.uint8), 2001))
    blocks = ascii_blocks + [fib, b"s" * 1000, uniform_ascii(2043), two]
    m, n = padded(blocks)
    x, n = torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev)
    huffman_stages(x, n, "edge blocks")
    # the wrapper holds kernel G's own bit totals against the caller's and raises where they differ
    args, bits, _ = huffman_encode_args(x, n)
    try:
        huffman_rows.encode_rows(*args, bits=bits + (torch.arange(len(bits), device=dev) == 3))
        raised = False
    except RuntimeError as e:
        raised = "block 3 codes to" in str(e)
    check(raised, "kernel G's wrapper took bit totals that disagree with its own")
    print(f"phase kernels G (huffman encode), H (huffman decode) vs plain: equal on {len(ascii_blocks)} ASCII "
          f"edge blocks, a block with a {longest}-bit code, a single-symbol block, uniform ASCII (7-bit codes) "
          f"and two symbols (1-bit codes), H restores them, max_abs_err 0", flush=True)
    # blocks over several of kernel H's spans (huffman_rows.SUB_BITS * SPAN_SUBS bits each), so its
    # chain repairs a span's first entry from the exit of the one before
    span = huffman_rows.SUB_BITS * huffman_rows.SPAN_SUBS
    blocks = [uniform_ascii(50_001), bytes(rng.choice(np.frombuffer(b"ab", np.uint8), 300_007)),
              bench.make_corpus(90_007), fibonacci_block(24)]
    m, n = padded(blocks)
    x, n = torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev)
    huffman_stages(x, n, "blocks over several spans")
    print(f"phase kernels G, H vs plain on 4 blocks of 2-4 spans of {span} bits (uniform ASCII, two symbols, the "
          f"corpus, a 23-bit code): equal, max_abs_err 0", flush=True)

    m, n = padded(ascii_blocks)
    xe, en = escape.escape_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
    for window in (16, WINDOW):
        L, D = lzss_match.find_matches(xe, en, window)
        tok, tl = lzss_commit.commit_tokens(xe, L, D, en)
        cols = torch.arange(tok.shape[1], device=dev)[None, :]
        clean = ~((tok >= 0x80) & (cols < tl[:, None])).any(1)  # '<' escapes to 0xFF
        huffman_stages(tok[clean].contiguous(), tl[clean].contiguous(), f"tokens at window {window}")
        print(f"phase kernels G, H vs plain on kernel E's token streams at window {window}: equal on "
              f"{int(clean.sum())} ASCII streams, max_abs_err 0", flush=True)

    # the whole edge set through the container's Huffman layer: the
    # non-ASCII blocks take the host split and are counted
    m, n = padded(edge)
    huffman_blocks.reset_host_split()
    flat, sizes = huffman_blocks.encode_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
    body = flat.cpu().numpy().tobytes()
    nonascii = len(edge) - len(ascii_blocks)
    check(huffman_blocks.host_split["encode"] == nonascii, "the non-ASCII edge blocks did not all take the host split")
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    check(all(body[a : a + k] == hf.compress(b) for a, k, b in zip(starts, sizes, edge)),
          "a Huffman edge payload differs from the port's copy of the oracle")
    # decode the blocks of two or more symbols (one symbol has a zero-length code, which the oracle refuses)
    keep = [i for i, b in enumerate(edge) if len(set(b)) > 1]
    payloads = [body[starts[i] : starts[i] + sizes[i]] for i in keep]
    body = b"".join(payloads)
    sizes = np.array([len(p) for p in payloads], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    flat = torch.from_numpy(np.frombuffer(body, np.uint8).copy()).to(dev)
    rows, counts, host = huffman_blocks.decode_blocks(flat, body, starts, sizes, max(map(len, edge)))
    rows_np = rows.cpu().numpy()
    check(sorted(host) == [k for k, i in enumerate(keep) if max(edge[i]) >= 0x80]
          and all(rows_np[k, : counts[k]].tobytes() == edge[i] for k, i in enumerate(keep) if k not in host),
          "the Huffman layer did not decode the edge blocks")
    print(f"phase huffman layer: {len(edge)} edge blocks equal the port's copy of the oracle; "
          f"{nonascii} non-ASCII blocks took the host split (counted, not compared with a kernel)", flush=True)


def phase_main(data: bytes, algorithms: tuple[str, ...], wrappers: dict, reset, card: str, dev):
    """Phase 3 for one pipeline: timed exact round trips through the entry points.

    Returns (launches of the first run per kernel, the last container,
    kernel D's tiles by path in the first run, or None without kernel D,
    the median encode and decode MB/s).
    """
    import torch

    from raisin_tpu_torch.parallel import blocks

    def run():
        return blocks.compress_container(data, algorithms, block_size=BLOCK_SIZE, window=WINDOW, device=dev)

    check(blocks.decompress_container(run(), device=dev) == data, f"{algorithms} warm-up round trip differs")
    reset()
    torch.cuda.synchronize()
    t_enc, t_dec = [], []
    for rep in range(TIMED_RUNS):
        t0 = time.perf_counter()
        c = run()
        torch.cuda.synchronize()
        t_enc.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = blocks.decompress_container(c, device=dev)
        torch.cuda.synchronize()
        t_dec.append(time.perf_counter() - t0)
        check(back == data, f"{algorithms} main path round trip {rep} differs")
        if rep == 0:
            launches = {name: fn.launches for name, fn in wrappers.items()}
            tiles = match_tiles() if "lzss_match" in wrappers else None
    for name, n in launches.items():
        check(n > 0, f"the {algorithms} main path never launched {name}")
    if tiles is not None:  # the corpus's tiles all take kernel D's chain path (trees that count them)
        check(tiles["chain"] > 0 and tiles["sweep"] == 0, f"the {algorithms} main path's match tiles: {tiles}")
    mb = len(data) / 1e6
    enc_mbs = sorted(mb / t for t in t_enc)
    dec_mbs = sorted(mb / t for t in t_dec)
    print(
        f"phase main path {','.join(algorithms)}: {len(data)} B in {BLOCK_SIZE} B blocks (window {WINDOW}) "
        f"round trip exact {TIMED_RUNS} times; over {TIMED_RUNS} runs "
        f"encode MB/s median {np.median(enc_mbs):.3f} (min {enc_mbs[0]:.3f}, max {enc_mbs[-1]:.3f}), "
        f"decode MB/s median {np.median(dec_mbs):.3f} (min {dec_mbs[0]:.3f}, max {dec_mbs[-1]:.3f}), "
        f"ratio {len(c) / len(data) * 100:.4f}%, launches of the first run {launches}"
        f"{f', kernel D tiles by path {tiles}' if tiles else ''}; card {card}",
        flush=True,
    )
    return launches, c, tiles, {"encode": float(np.median(enc_mbs)), "decode": float(np.median(dec_mbs))}


def phase_wide_window(data: bytes, dev) -> None:
    """Phase 3: an lzss,arithmetic container above window 8191 through the entry points. It
    carries no aux table, as the JAX package writes it, and decodes block by block through
    decompress_bytes (under the auto order, whose raw decodes are the native C runtime)."""
    from raisin_tpu_torch.parallel import blocks

    part = data[:WIDE_BYTES]
    t0 = time.perf_counter()
    c = blocks.compress_container(part, LZ, block_size=BLOCK_SIZE, window=WIDE_WINDOW, device=dev)
    t_enc = time.perf_counter() - t0
    algorithms, _, orig, payloads, aux, window = blocks.parse_container(c)
    check((algorithms, orig, window, aux) == (LZ, len(part), WIDE_WINDOW, []),
          f"the lzss,arithmetic container at window {WIDE_WINDOW} carries an aux table or the wrong header")
    t_dec = []
    for _ in range(2):  # the first decode may build the native C runtime
        t0 = time.perf_counter()
        check(blocks.decompress_container(c, device=dev) == part,
              f"the lzss,arithmetic container at window {WIDE_WINDOW} did not round-trip")
        t_dec.append(time.perf_counter() - t0)
    print(f"phase wide window: lzss,arithmetic container of {len(part)} B at window {WIDE_WINDOW}, "
          f"{len(payloads)} blocks, no aux table, ratio {len(c) / len(part) * 100:.4f}%; compress "
          f"{t_enc * 1e3:.1f} ms on the card, decompress block by block on the host (decompress_bytes, "
          f"auto order) {t_dec[0] * 1e3:.1f} ms the first time, {t_dec[1] * 1e3:.1f} ms the second, "
          f"round trip exact", flush=True)


# the stream path: pipeline -> the kernels each compress must launch
STREAM_KERNELS = {
    LZ: ("lzss_match", "lzss_commit", "arith_events"),
    ("arithmetic",): ("arith_events",),
    ("huffman",): ("huffman_encode",),
    ("lzss",): ("lzss_match", "lzss_commit"),
}


def phase_stream(data: bytes, wrappers: dict, reset, card: str, dev, trace: bool = True) -> dict:
    """Phase 3, the stream path: the engine's single-stream device codecs on ``data``,
    with two traced calls unless ``trace`` is False.

    Returns, per pipeline, the launches of its first timed compress.
    """
    import os
    import tempfile

    import torch

    import raisin_tpu_torch as rt
    from raisin_tpu_torch.ops import huffman_blocks

    check(sha(data) == ORACLE_STREAM["arithmetic"][0], "the stream input is not the one sampled")
    launches = {}
    for algorithms, kernels in STREAM_KERNELS.items():
        name = ",".join(algorithms)

        def run():
            return rt.compress_bytes(data, list(algorithms), backend="device", device=dev)

        run()  # warm-up
        huffman_blocks.reset_host_split()
        reset()
        torch.cuda.synchronize()
        times = []
        for rep in range(TIMED_RUNS):
            t0 = time.perf_counter()
            c = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if rep == 0:
                launches[name] = {k: fn.launches for k, fn in wrappers.items()}
        got = launches[name]
        check(all(got[k] > 0 for k in kernels), f"the {name} stream did not launch all of {kernels}: {got}")
        check(got["arith_encode"] == 0, f"the {name} stream launched kernel A")
        if name in ORACLE_STREAM:
            _, size, out_sha = ORACLE_STREAM[name]
            check((len(c), sha(c)) == (size, out_sha), f"the {name} stream differs from the host oracle's")
        reset()
        t0 = time.perf_counter()
        check(rt.decompress_bytes(c, list(algorithms), backend="device", device=dev) == data,
              f"the {name} stream did not round-trip through decompress_bytes")
        t_dec = time.perf_counter() - t0
        if algorithms == ("huffman",):  # the one stream that decodes on the card: kernel H, no host split
            split = dict(huffman_blocks.host_split)
            check(split == {"encode": 0, "decode": 0}, f"the huffman stream took the host split: {split}")
            check(wrappers["huffman_decode"].launches > 0, "the huffman stream's decompress_bytes never launched kernel H")
        mbs = sorted(len(data) / 1e6 / t for t in times)
        print(
            f"phase stream {name}: compress_bytes of {len(data)} B on the card, {len(c)} B out"
            f"{' = ORACLE_STREAM' if name in ORACLE_STREAM else ''}; over {TIMED_RUNS} runs compress MB/s "
            f"median {np.median(mbs):.3f} (min {mbs[0]:.3f}, max {mbs[-1]:.3f}); decompress_bytes round trip "
            f"exact in {t_dec * 1e3:.1f} ms (its launches {({k: fn.launches for k, fn in wrappers.items() if fn.launches})}, "
            f"Huffman host split {dict(huffman_blocks.host_split)}); launches of the first run {got}; card {card}",
            flush=True,
        )

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "stream.txt")
        with open(src, "wb") as f:
            f.write(data)
        for container in (False, True):
            out = src + (".rsnb" if container else ".rsn")
            rt.compress_file(list(LZ), src, out, quiet=True, backend="device", container=container, device=dev)
            back = rt.decompress_file(list(LZ), out, src + ".back", quiet=True, backend="device", device=dev)
            with open(src + ".back", "rb") as f:
                check(back == data and f.read() == data, f"the file round trip (container={container}) differs")
    print(f"phase stream files: compress_file and decompress_file of {len(data)} B round-trip, raw and "
          f"container", flush=True)

    if not trace:
        return launches

    def huffman_round_trip():
        c = rt.compress_bytes(data, ["huffman"], backend="device", device=dev)
        check(rt.decompress_bytes(c, ["huffman"], backend="device", device=dev) == data, "traced round trip differs")

    traces = {
        "lzss,arithmetic (one compress_bytes)": trace_breakdown(
            lambda: rt.compress_bytes(data, list(LZ), backend="device", device=dev), "stream.", ("stream.compress",)),
        # kernels G and H on one block of the whole input
        "huffman (one compress_bytes + decompress_bytes)": trace_breakdown(
            huffman_round_trip, "stream.", ("stream.compress", "stream.decompress")),
    }
    for name, trace in traces.items():
        if not trace["device_ms"]:
            print(f"phase trace stream {name}: the profiler recorded no device activity; device times not measured",
                  flush=True)
        print(f"phase trace stream {name}, ms under torch.profiler: " + json.dumps(trace), flush=True)
    return launches


WIDE_KERNELS = ("huffman_encode_wide", "huffman_decode_wide")


def wide_rows(rows: list[bytes], dev) -> tuple:
    """Byte rows -> (ids (B, S) int32, lengths (B,) int32, the wide tables) of one tree over all their runes,
    each rune counted as often as it occurs; the rune decode and the ids on the card."""
    import torch

    from raisin_tpu_torch.formats import huffman as hf
    from raisin_tpu_torch.ops import huffman_blocks, runes

    rs = [runes.decode(torch.from_numpy(np.frombuffer(r, np.uint8).copy()).to(dev)) for r in rows]
    uniq, inv, counts = torch.unique(torch.cat(rs), sorted=True, return_inverse=True, return_counts=True)
    tables = huffman_blocks.wide_tables(hf.build_tree(dict(zip(uniq.cpu().tolist(), counts.cpu().tolist()))))
    lengths = torch.tensor([r.numel() for r in rs], dtype=torch.int32, device=dev)
    ids = torch.full((len(rs), int(lengths.max())), -1, dtype=torch.int32, device=dev)
    for b, part in enumerate(torch.split(inv.to(torch.int32), lengths.tolist())):
        ids[b, : part.numel()] = part
    return ids, lengths, tables


def wide_vs_plain(ids, lengths, tables, dev, reps: int = 20) -> dict:
    """Wide kernels G and H on one tree's id rows, each beside its plain version on the card (exact),
    H giving back the ids; _result's keys for each, ms by CUDA events over ``reps`` launches."""
    import torch

    from raisin_tpu_torch.ops import huffman_rows

    codes, lens = torch.from_numpy(tables.codes).to(dev), torch.from_numpy(tables.code_lens).to(dev)
    bits = torch.where(ids >= 0, lens.to(torch.int64)[ids.clamp(min=0).to(torch.int64)], 0).sum(1)
    capw = max(1, -(-int(bits.max()) // 32))
    enc = (ids, lengths, codes, lens, capw)
    got = huffman_rows.encode_rows_wide(*enc, bits=bits)
    want, plain_g = plain_ms(lambda: huffman_rows._encode_rows_wide_torch(*enc))
    ms_g = cuda_ms(lambda: huffman_rows.encode_rows_wide(*enc, bits=bits), reps)
    rows, byte_lens, pads = got
    children = torch.from_numpy(tables.children).to(dev)
    dec = (rows, pads, byte_lens, children, tables.lattice, ids.shape[1])
    out = huffman_rows.decode_rows_wide(*dec)
    want_d, plain_h = plain_ms(lambda: huffman_rows._decode_rows_wide_torch(*dec[:4], dec[5]))
    ms_h = cuda_ms(lambda: huffman_rows.decode_rows_wide(*dec), reps)
    check(torch.equal(out[1], lengths) and bool(out[2].all()), "wide kernel H did not end every row at its length")
    check(torch.equal(torch.where(ids >= 0, out[0], -1), ids), "wide kernel H did not give back the ids")
    B, toks, K = ids.shape[0], float(lengths.to(torch.int64).sum()), len(tables.codes)
    payload = float(byte_lens.to(torch.int64).sum())
    # G: ids and the table in, payload out, per symbol a code load, a scan add, a shift and an OR;
    # H: payload and child table in, ids out, a table step a symbol (as phase 4's bounds of G and H)
    return {
        "huffman_encode_wide": _result(max_abs_err(*zip(got, want)), ms_g, plain_g, 4 * toks + 8 * K + payload + 8 * B,
                                       4 * toks),
        "huffman_decode_wide": _result(max_abs_err(*zip(out, want_d)), ms_h, plain_h,
                                       payload + 8 * (K - 1) + 4 * toks + 8 * B, 4 * toks),
        "runes": int(toks), "distinct": K, "longest_code": int(tables.code_lens.max()), "rows": B,
    }


def phase_runes(wrappers: dict, reset, card: str, dev) -> tuple[dict, dict]:
    """The runes phase: the Huffman stream's full rune alphabet on the card (wide kernels G and H).

    Wide G and H against their plain versions (exact) at three shapes: the
    stream of the corpus's kennedy.xls at scale 1.0 (B = 1), an alphabet of
    RUNE_WIDE_DISTINCT code points, past kernel G's shared-memory table, and
    the RUNE_EDGES rows of one tree. The main path, launch counts from 0:
    ``compress_bytes``/``decompress_bytes`` of kennedy.xls through the
    ``huffman`` device codec, equal to the port's oracle copy (compress) and
    to its rune iteration in UTF-8 (decompress); the RUNE_FAULT_RUNES stream
    round-trips; the host split stays 0; compress and decompress MB/s over
    TIMED_RUNS. Returns (the main path's launches, the wide kernels' entries
    of the kernel table).
    """
    import torch

    import raisin_tpu_torch as rt
    from raisin_tpu_torch.formats import huffman as hf
    from raisin_tpu_torch.ops import huffman_blocks, huffman_rows
    from raisin_tpu_torch.utils import corpus

    kennedy = corpus.generate(1.0)["kennedy.xls"]
    shapes = {"kennedy.xls stream": [kennedy], f"{RUNE_WIDE_DISTINCT} distinct runes": [wide_alphabet_stream()],
              "invalid UTF-8 edges": list(RUNE_EDGES)}
    per_shape = {}
    for name, rows in shapes.items():
        r = wide_vs_plain(*wide_rows(rows, dev), dev)
        per_shape[name] = r
        for k in WIDE_KERNELS:
            check(r[k]["max_abs_err"] == 0, f"{k} differs from its plain version on {name} (err {r[k]['max_abs_err']})")
        print(f"phase runes {name}: {r['rows']} rows, {r['runes']} runes, {r['distinct']} distinct, longest code "
              f"{r['longest_code']} bits; wide G {r['huffman_encode_wide']['ms']:.4f} ms (plain "
              f"{r['huffman_encode_wide']['plain_ms']:.1f}, bound {r['huffman_encode_wide']['bound_ms']:.4f}), "
              f"wide H {r['huffman_decode_wide']['ms']:.4f} ms (plain {r['huffman_decode_wide']['plain_ms']:.1f}, "
              f"bound {r['huffman_decode_wide']['bound_ms']:.4f}), max_abs_err 0, H gives back the ids", flush=True)
    check(per_shape[f"{RUNE_WIDE_DISTINCT} distinct runes"]["distinct"] > huffman_rows.WIDE_TABLE,
          "the wide alphabet fits kernel G's shared-memory table: its device-memory path did not run")

    huffman_blocks.reset_host_split()
    reset()
    torch.cuda.synchronize()
    c = rt.compress_bytes(kennedy, ["huffman"], backend="device", device=dev)
    back = rt.decompress_bytes(c, ["huffman"], backend="device", device=dev)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    check(all(launches[k] > 0 for k in WIDE_KERNELS), f"the rune stream did not launch wide G and H: {launches}")
    check(c == hf.compress(kennedy), "the kennedy.xls stream differs from the oracle copy's")
    check(back == b"".join(hf.rune_to_utf8(r) for r in hf.go_decode_runes(kennedy)),
          "the kennedy.xls stream's decode differs from the oracle's runes")
    fault = fault_stream()
    check(rt.decompress_bytes(rt.compress_bytes(fault, ["huffman"], backend="device", device=dev), ["huffman"],
                              backend="device", device=dev) == fault, "the 950,000-rune stream did not round-trip")
    split = dict(huffman_blocks.host_split)
    check(split == {"encode": 0, "decode": 0}, f"the rune streams took the host split: {split}")
    rates = {}
    for what, fn in (("compress", lambda: rt.compress_bytes(kennedy, ["huffman"], backend="device", device=dev)),
                     ("decompress", lambda: rt.decompress_bytes(c, ["huffman"], backend="device", device=dev))):
        times = []
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        mbs = sorted(len(kennedy) / 1e6 / t for t in times)
        rates[what] = {"median": float(np.median(mbs)), "min": mbs[0], "max": mbs[-1]}
    print(f"phase runes stream: kennedy.xls ({len(kennedy)} B, {per_shape['kennedy.xls stream']['runes']} runes) "
          f"-> {len(c)} B = the oracle copy's, decode = the oracle's runes; the {RUNE_FAULT_RUNES}-rune stream "
          f"round-trips; host split {split}; launches {launches}; MB/s over {TIMED_RUNS} runs "
          + json.dumps(rates) + f"; card {card}", flush=True)
    main = per_shape["kennedy.xls stream"]
    results = {k: {**main[k], "max_abs_err": max(r[k]["max_abs_err"] for r in per_shape.values()),
                   "shapes": {n: r[k] for n, r in per_shape.items()}} for k in WIDE_KERNELS}
    return launches, results


def phase_ci(wrappers: dict, reset, card: str, dev) -> None:
    """The ci phase: scripts/ci_bench_torch.sh's page (``write_ci_page``) over the corpus at scale 0.05
    on the card; every row's compressed bytes and lossless flag equal the host backend's on the
    same file and layers, and the Huffman rows launch wide G and H on the binary files."""
    import contextlib
    import io
    import tempfile

    import raisin_tpu_torch as rt
    from raisin_tpu_torch.engine.benchmark import CI_ALGORITHMS, write_ci_page

    with tempfile.TemporaryDirectory() as out:
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the page's tables; the rows are checked below
            rows = write_ci_page(out, 0.05, dev)
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
        names = sorted(os.listdir(os.path.join(out, "corpus")))
        check(len(rows) == len(names) * len(CI_ALGORITHMS), f"the page has {len(rows)} rows")
        per = len(CI_ALGORITHMS)
        for f, name in enumerate(names):
            with open(os.path.join(out, "corpus", name), "rb") as fh:
                data = fh.read()
            for row in rows[f * per : (f + 1) * per]:
                layers = row["engine"].split(",")
                try:
                    c = rt.compress_bytes(data, layers, backend="host")
                    lossless = rt.decompress_bytes(c, layers, backend="host") == data
                except Exception as e:  # noqa: BLE001 - a failed row must fail on the host too
                    check(row["failed"], f"{name} {row['engine']}: the host raises ({e}), the page's row did not")
                    continue
                check(not row["failed"] and (row["compressed_bytes"], row["lossless"]) == (len(c), lossless),
                      f"{name} {row['engine']}: the page's row {row} differs from the host's ({len(c)}, {lossless})")
        check(all(launches.get(k, 0) > 0 for k in ("lzss_match", "lzss_commit", "arith_events", "huffman_encode",
                                                     "huffman_decode", *WIDE_KERNELS)),
              f"the page did not launch every kernel of its paths: {launches}")
    times = {f"{names[i // per]} {r['engine']}": r["time_taken"] for i, r in enumerate(rows)}
    print(f"phase ci: write_ci_page at scale 0.05 on the card in {seconds:.1f} s, {len(rows)} rows equal to the "
          f"host backend's bytes and lossless flags; launches {launches}; row times " + json.dumps(times, ensure_ascii=False)
          + f"; card {card}", flush=True)


def run_cli(argv: list[str]) -> tuple[int, str]:
    """raisin_tpu_torch.cli.main(argv) on the card -> (exit code, what it printed)."""
    import contextlib
    import io

    from raisin_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def table_rows(out: str) -> list[list[str]]:
    """The benchmark table's body rows (the header and the footer dropped), each cell stripped."""
    rows = [[c.strip() for c in line.strip("│").split("│")] for line in out.splitlines() if line.startswith("│")]
    return rows[1:-1]


def phase_cli(data: bytes, lz_container: bytes, wrappers: dict, reset, card: str, dev) -> None:
    """The cli phase: the port's `raisin`/`grape` command line on the card, as a user runs it.

    The default container of the whole corpus (kernels A, B, D and E), equal to phase 3's
    ``compress_container``, and its decode by ``grape`` (C and F); the same compress under
    ``-profile``, whose trace must name kernels D and A; the raw 1 MiB stream, auto (the card: D,
    E and I) against ``-backend=native``, with the MB/s of auto and each backend on CLI_STREAMS; the
    benchmark table with ``-backend=device`` on CLI_BENCH_BYTES, every row lossless; one gzip
    container (a pipeline without a device path) of CLI_HOST_BYTES round trip.
    """
    import glob
    import os
    import tempfile

    import torch

    import raisin_tpu_torch as rt
    from raisin_tpu_torch.engine import registry

    def launched(names: tuple[str, ...], what: str) -> dict:
        got = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
        check(all(got.get(k, 0) > 0 for k in names), f"{what} did not launch all of {names}: {got}")
        return got

    def read(path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write(path: str, b: bytes) -> None:
        with open(path, "wb") as f:
            f.write(b)

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "corpus.bin")
        write(src, data)
        reset()
        t0 = time.perf_counter()
        rc, _ = run_cli(["raisin", "-container", src])
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        check(rc == 0, f"raisin -container exited {rc}")
        enc = launched(("arith_encode", "arith_prepad", "lzss_match", "lzss_commit"), "raisin -container")
        check(sha(read(src + ".rsn")) == sha(lz_container), "raisin -container differs from compress_container")
        os.remove(src)
        reset()
        t0 = time.perf_counter()
        rc, _ = run_cli(["grape", src + ".rsn"])
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        check(rc == 0 and read(src) == data and not os.path.exists(src + ".rsn"), "grape did not round-trip")
        dec = launched(("arith_decode", "lzss_decode"), "grape")
        trace_dir = os.path.join(tmp, "trace")
        rc, _ = run_cli(["raisin", "-container", src, f"-out={src}.p", f"-profile={trace_dir}"])
        check(rc == 0 and sha(read(src + ".p")) == sha(lz_container), "raisin -container -profile differs")
        traces = glob.glob(os.path.join(trace_dir, "*.json"))
        check(len(traces) == 1, f"-profile wrote {len(traces)} trace files")
        with open(traces[0]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        found = {k: any(f"{k}_kernel" in n for n in names) for k in ("lzss_match", "arith_encode")}
        check(all(found.values()) and "rsnb.compress" in names, f"the -profile trace lacks a kernel: {found}")
        print(f"phase cli container: raisin -container on {len(data)} B = phase 3's container "
              f"({len(lz_container)} B) in {t_enc * 1e3:.1f} ms, launches {enc}; grape round trip exact in "
              f"{t_dec * 1e3:.1f} ms, launches {dec}; -profile wrote {os.path.basename(traces[0])} "
              f"({os.path.getsize(traces[0])} B) naming {sorted(found)} and rsnb.compress; card {card}", flush=True)

        stream = data[:STREAM_BYTES]
        s = os.path.join(tmp, "stream.bin")
        write(s, stream)
        reset()
        rc, _ = run_cli(["raisin", s, f"-out={s}.auto"])
        check(rc == 0, f"raisin (auto) exited {rc}")
        auto_launches = launched(("lzss_match", "lzss_commit", "arith_events"), "raisin (auto)")
        try:
            rc, _ = run_cli(["raisin", "-backend=native", s, f"-out={s}.native"])
        finally:
            registry.set_preferred_backend("auto")
        check(rc == 0, f"raisin -backend=native exited {rc}")
        auto = read(s + ".auto")
        _, size, out_sha = ORACLE_STREAM["lzss,arithmetic"]
        check(read(s + ".native") == auto and (len(auto), sha(auto)) == (size, out_sha),
              "raisin and raisin -backend=native wrote different streams, or not ORACLE_STREAM's")
        rc, _ = run_cli(["grape", f"{s}.auto", f"-out={s}.back"])
        check(rc == 0 and read(s + ".back") == stream, "grape of the raw stream did not round-trip")
        rates = {}
        for name in CLI_STREAMS:
            algorithms = name.split(",")
            rates[name] = {}
            for backend in ("native", "auto", "device", "host"):
                runs = 1 if backend == "host" else TIMED_RUNS  # the host copies are Python
                t_c, t_d = [], []
                for _ in range(runs):
                    t0 = time.perf_counter()
                    c = rt.compress_bytes(stream, algorithms, backend=backend, device=dev)
                    torch.cuda.synchronize()
                    t_c.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    back = rt.decompress_bytes(c, algorithms, backend=backend, device=dev)
                    t_d.append(time.perf_counter() - t0)
                    check(back == stream, f"the {name} stream did not round-trip on {backend}")
                if backend == "native":
                    want = c
                check(c == want, f"the {name} stream on {backend} differs from native's")
                mb = len(stream) / 1e6
                rates[name][backend] = {"compress_mbs": round(mb / float(np.median(t_c)), 3),
                                        "decompress_mbs": round(mb / float(np.median(t_d)), 3), "runs": runs}
        print(f"phase cli streams: raisin (auto: the card) and raisin -backend=native write the same "
              f"{len(auto)} B = ORACLE_STREAM, auto launches {auto_launches}, grape round trip exact; MB/s of "
              f"compress_bytes and decompress_bytes on {len(stream)} B (median of runs): {json.dumps(rates)}; "
              f"card {card}", flush=True)

        b = os.path.join(tmp, "bench.bin")
        write(b, data[:CLI_BENCH_BYTES])
        reset()
        t0 = time.perf_counter()
        try:
            rc, out = run_cli(["raisin", "-benchmark", "-backend=device", b])
        finally:
            registry.set_preferred_backend("auto")
        t_bench = time.perf_counter() - t0
        rows = table_rows(out)
        check(rc == 0 and len(rows) == 5 and all(r[-1] == "true" and "DNF" not in r for r in rows),
              f"raisin -benchmark -backend=device: rows {rows}")
        bench_launches = launched(("lzss_match", "lzss_commit", "arith_events", "huffman_encode", "huffman_decode"),
                                  "raisin -benchmark -backend=device")
        print(f"phase cli benchmark: raisin -benchmark -backend=device on {CLI_BENCH_BYTES} B in {t_bench:.1f} s, "
              f"rows (engine, time, ratio, entropies, lossless) {rows}, launches {bench_launches}", flush=True)

        g = os.path.join(tmp, "gzip.bin")
        write(g, data[:CLI_HOST_BYTES])
        t0 = time.perf_counter()
        rc, _ = run_cli(["raisin", "-container", "-algorithm=gzip", g])
        t_enc = time.perf_counter() - t0
        check(rc == 0 and read(g + ".rsn")[:4] == b"RSNB", "raisin -container -algorithm=gzip failed")
        size = os.path.getsize(g + ".rsn")
        os.remove(g)
        t0 = time.perf_counter()
        rc, _ = run_cli(["grape", g + ".rsn"])
        t_dec = time.perf_counter() - t0
        check(rc == 0 and read(g) == data[:CLI_HOST_BYTES], "the gzip container did not round-trip")
        print(f"phase cli host container: gzip container of {CLI_HOST_BYTES} B, {size} B, block by block "
              f"through compress_bytes in {t_enc * 1e3:.1f} ms and decompress_bytes in {t_dec * 1e3:.1f} ms, "
              f"round trip exact", flush=True)


def _result(err: int, ms: float, plain: float, nbytes: float, ops: float) -> dict:
    bound_ms, bound_by = bound(nbytes, ops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by}


def _coder_ops(steps: float, bits: float, num_cum: int) -> float:
    """Least integer operations of an adaptive arithmetic coder: per step a
    search and an update of a cumulative-frequency (Fenwick) tree of
    ``num_cum`` entries, ceil(log2) operations each, and ~6 of coder
    arithmetic (range, two multiply-divides, the new low); one a stream bit."""
    return (2 * int(np.ceil(np.log2(num_cum))) + 6) * steps + bits


def _encode_work(ar, lengths, bits) -> tuple[float, float]:
    """Kernel A's (bytes, operations) for its bound: symbols in, bits out, a coder step per
    symbol and EOF."""
    import torch

    coded = float((lengths.to(torch.int64) + 1).sum())
    stream = float(((bits.to(torch.int64) + 7) // 8).sum())
    return 4 * coded + stream + 12 * lengths.numel(), _coder_ops(coded, 8 * stream, ar.NUM_CUM)


def phase_timing_arith(ar, data: bytes, payloads: list[bytes], dev) -> dict:
    """Phase 4, arithmetic: kernels A, B, C at the main path's shapes beside their plain versions
    (A's and C's on the first PLAIN_BLOCKS blocks); A and C also on each of DECODE_INPUTS."""
    import torch

    symbols, lengths = batch(*padded([data[i : i + BLOCK_SIZE] for i in range(0, len(data), BLOCK_SIZE)]), dev)
    capw = ar.capw_bound(symbols.shape[1])
    B = symbols.shape[0]
    results = {}

    ms_a = cuda_ms(lambda: ar.encode_bits(symbols, lengths, capw), 3)
    raw_k, bits_k, of_k = ar.encode_bits(symbols, lengths, capw)
    check(int(of_k.max()) == 0, "kernel A flagged an overflow at the main path's shapes")
    # the plain version on the first PLAIN_BLOCKS blocks at full step length, as CPU tensors
    p = slice(0, PLAIN_BLOCKS)
    sym_p, len_p = symbols[p].cpu(), lengths[p].cpu()
    (raw_p, bits_p, of_p), plain_a = plain_ms(lambda: ar._encode_bits_torch(sym_p, len_p, capw))
    stream = float(((bits_k.to(torch.int64) + 7) // 8).sum())
    err = max_abs_err((raw_k[p].cpu(), raw_p), (bits_k[p].cpu(), bits_p), (of_k[p].cpu(), of_p))
    results["arith_encode"] = _result(err, ms_a, plain_a, *_encode_work(ar, lengths, bits_k))
    # the main path's payloads of those blocks are the plain A + B's
    rows_pp, bl_pp = ar._prepad_torch(raw_p, bits_p)
    for i in range(PLAIN_BLOCKS):
        check(rows_pp[i, : int(bl_pp[i])].numpy().tobytes() == payloads[i],
              f"main-path block {i} differs from the plain versions of kernels A + B")
    del raw_p, rows_pp

    ms_b = cuda_ms(lambda: ar.prepad_rows(raw_k, bits_k), 10)
    rows_k, bl_k = ar.prepad_rows(raw_k, bits_k)  # kernels A + B, also for kernel I's cross-check
    (rows_p, bl_p), plain_b = plain_ms(lambda: ar._prepad_torch(raw_k, bits_k))
    out_bytes = float(bl_p.to(torch.int64).sum())
    results["arith_prepad"] = _result(max_abs_err((rows_k, rows_p), (bl_k, bl_p)), ms_b, plain_b,
                                      stream + out_bytes + 8 * B, 6 * out_bytes / 4)
    del raw_k
    events_vs_ab(ar, symbols, lengths, rows_k, bl_k, ms_a)
    del rows_k

    # every block of the main path's payloads is the plain prepad of kernel A's rows
    bl_np = bl_p.cpu().numpy()
    rows_np = rows_p[:, : int(bl_np.max())].cpu().numpy()
    for i, p in enumerate(payloads):
        check(rows_np[i, : bl_np[i]].tobytes() == p, f"main-path block {i} differs from the plain version")
    del rows_p, rows_np, symbols

    encode = time_encode(data, dev)
    for name, r in encode.items():
        alone = (f", {r['ms_one_warp_per_scheduler']:.4f} ms on its first 4 blocks an SM (one warp a scheduler)"
                 if "ms_one_warp_per_scheduler" in r else "")
        print(f"phase timing arith_encode on {name} {r['shape']}: kernel {r['ms']:.4f} ms{alone}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bits']} bits, oflow 0, digest {r['digest']}", flush=True)
    results["arith_encode"]["inputs"] = encode

    decode = time_decode(data, dev, plain=True)
    for name, r in decode.items():
        check(r["max_abs_err"] in ((0,) if name in DECODE_MAIN else (None,)),
              f"kernel C differs from its plain version on {name} (err {r['max_abs_err']})")
        plain = (f"plain {r['plain_ms']:.1f} ms on its first {PLAIN_BLOCKS} blocks on the host, max_abs_err 0"
                 if name in DECODE_MAIN else "no plain version")
        print(f"phase timing arith_decode on {name} {r['shape']}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), output = input, digest {r['digest']}, {plain}", flush=True)
    timing = ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")  # the arithmetic container's, as for every kernel
    results["arith_decode"] = {k: decode["arithmetic"][k] for k in timing}
    results["arith_decode"]["inputs"] = decode
    return results


# kernels A's and C's timing inputs, each as the container hands it to them: the corpus in the
# arithmetic container and its tokens in the lzss,arithmetic one (window WINDOW), and MAIN_BYTES of
# seeded random bytes and of zero bytes in BLOCK_SIZE blocks through the arithmetic container's coder
DECODE_INPUTS = ("arithmetic", "lzss,arithmetic", "random", "zeros")
DECODE_MAIN = ("arithmetic", "lzss,arithmetic")  # the main paths' shapes, held against the plain version
# blocks of each batch that the plain versions of kernels A and C run on, at full step length, as CPU tensors
PLAIN_BLOCKS = 64


def coder_input(name: str, data: bytes, dev):
    """One of DECODE_INPUTS as the container hands it to kernel A (after D + E for lzss,arithmetic).

    Returns (payload (B, steps) uint8, zero from each block's length on;
    lengths; steps, the longest length + 1).
    """
    import torch
    import torch.nn.functional as F

    from raisin_tpu_torch.ops import escape, pipeline

    src = {
        "arithmetic": lambda: data,
        "lzss,arithmetic": lambda: data,
        "random": lambda: np.random.default_rng(13).integers(0, 256, MAIN_BYTES, dtype=np.uint8).tobytes(),
        "zeros": lambda: bytes(MAIN_BYTES),
    }[name]()
    m, n = padded([src[i : i + BLOCK_SIZE] for i in range(0, len(src), BLOCK_SIZE)])
    x, n = torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev)
    del m, src
    if name == "lzss,arithmetic":
        x, n = pipeline.lzss_tokens(*escape.escape_blocks(x, n), WINDOW)
    steps = int(n.max()) + 1
    payload = F.pad(x[:, : steps - 1], (0, 1))
    return torch.where(torch.arange(steps, device=dev)[None, :] < n[:, None], payload, 0), n, steps


def decode_input(name: str, data: bytes, dev):
    """One of DECODE_INPUTS, coded by kernels A + B (and D + E before them for lzss,arithmetic).

    Returns (payload rows at the container's pitch, the longest payload + 1
    bytes; byte lengths; coded lengths; steps; the (B, steps) uint8 symbols
    that kernel C must give back, 0 from each block's EOF on).
    """
    from raisin_tpu_torch.ops import pipeline
    from raisin_tpu_torch.parallel import blocks

    payload, n, steps = coder_input(name, data, dev)
    rows, blens, oflow = pipeline.arith_encode_rows(payload, n)
    check(not oflow.any(), f"kernel A flagged an overflow on {name}")
    prows = blocks._payload_rows(blocks._rows_payloads(rows, blens), blens, int(blens.max()) + 1)
    return prows, blens, n, steps, payload


def time_encode(data: bytes, dev) -> dict:
    """Kernel A on each of DECODE_INPUTS, as the containers hand them to it.

    Per input: the symbols' shape, ms per launch (CUDA events over 3, after
    a warm-up), the bound for the whole input, and a digest of (raw, bits,
    oflow) (equal digests from two trees mean equal outputs); no row may
    overflow. On the arithmetic container's input also the ms of its first
    4 blocks an SM, one warp a scheduler. The plain version runs in phase 4
    on the arithmetic container's first PLAIN_BLOCKS blocks.
    """
    import torch

    from raisin_tpu_torch.ops import arithmetic_rows as ar
    from raisin_tpu_torch.ops import pipeline

    out = {}
    for name in DECODE_INPUTS:
        payload, n, steps = coder_input(name, data, dev)
        symbols = pipeline.arith_symbols(payload, n)
        del payload
        capw = ar.capw_bound(steps)
        ar.encode_bits(symbols, n, capw)  # warm-up: a process's first launch also loads the kernel
        ms = cuda_ms(lambda: ar.encode_bits(symbols, n, capw), 3)
        raw, bits, oflow = ar.encode_bits(symbols, n, capw)
        check(not oflow.any(), f"kernel A flagged an overflow on {name}")
        words = (int(bits.max()) + 31) // 32
        bound_ms, bound_by = bound(*_encode_work(ar, n, bits))
        out[name] = {"shape": [symbols.shape[0], steps], "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bits": int(bits.to(torch.int64).sum()),
                     "digest": sha(raw[:, :words].cpu().numpy().tobytes() + bits.cpu().numpy().tobytes()
                                   + oflow.cpu().numpy().tobytes())}
        if name == "arithmetic":
            # the first 4 blocks an SM: one CTA of 4 warps on each, one warp on each of its 4
            # schedulers, so the step's latency alone, without a second warp sharing the issue
            few = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
            sym_f, n_f = symbols[:few].contiguous(), n[:few].contiguous()
            out[name]["ms_one_warp_per_scheduler"] = cuda_ms(lambda: ar.encode_bits(sym_f, n_f, capw), 3)
            del sym_f
        del symbols, raw
    return out


def time_decode(data: bytes, dev, plain: bool) -> dict:
    """Kernel C on each of DECODE_INPUTS.

    Per input: the payload rows' shape, the steps, ms per launch (CUDA
    events over 3), and a digest of (syms, eof_ok) (equal digests from two
    trees mean equal outputs); C must give back the input, with eof_ok 1 on
    every block. With ``plain``, also the bound for the whole input and, on
    the main paths' inputs (DECODE_MAIN), the plain version's ms on the first
    PLAIN_BLOCKS blocks as CPU tensors (the wrapper's route for them: a loop
    of small tensor operations a step, cheaper on the host than launched on
    the card) and max_abs_err against the kernel's rows of those blocks.
    """
    import torch

    from raisin_tpu_torch.ops import arithmetic_rows as ar

    out = {}
    for name in DECODE_INPUTS:
        prows, blens, n, steps, want = decode_input(name, data, dev)
        ar.decode_rows(prows, blens, n, steps)  # warm-up: a process's first launch also loads the kernel
        ms = cuda_ms(lambda: ar.decode_rows(prows, blens, n, steps), 3)
        syms, eof = ar.decode_rows(prows, blens, n, steps)
        check(bool(eof.all()) and torch.equal(syms, want), f"kernel C did not give back the {name} input")
        r = {"shape": [*prows.shape, steps], "ms": ms,
             "digest": sha(syms.cpu().numpy().tobytes() + eof.cpu().numpy().tobytes())}
        if plain:
            B = prows.shape[0]
            coded = float((n.to(torch.int64) + 1).sum())  # coder steps, EOF included
            payload = float(blens.to(torch.int64).sum())
            err, plain_c = None, None
            if name in DECODE_MAIN:
                p = slice(0, PLAIN_BLOCKS)
                args = [t[p].cpu() for t in (prows, blens, n)]
                (syms_p, eof_p), plain_c = plain_ms(lambda: ar._decode_rows_torch(*args, steps))
                err = max_abs_err((syms[p].cpu(), syms_p), (eof[p].cpu(), eof_p))
                del syms_p
            # payload in, bytes out
            r.update(_result(err, ms, plain_c, payload + coded - B + 4 * B,
                             _coder_ops(coded, 8 * payload, ar.NUM_CUM)))
        out[name] = r
        del prows, syms, want
    return out


def events_vs_ab(ar, symbols, lengths, rows_ab, bl_ab, ms_a: float, chunk: int = 64) -> None:
    """Phase 4, kernel I at the arithmetic container's shape, beside kernel A.

    Its records, expanded and packed in chunks of ``chunk`` blocks, must
    give every block's `.rsn` bytes as kernels A + B write them.
    """
    import torch

    from raisin_tpu_torch.ops import arithmetic_scan

    B, S = symbols.shape
    ms_i = cuda_ms(lambda: ar.encode_events(symbols, lengths), 3)
    slots, slot0 = ar.encode_events(symbols, lengths)
    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)
        want = bl_ab[lo:hi].to(torch.int64)
        nbytes = int(want.max())
        bits, bit_lengths = arithmetic_scan.expand_events(slots[lo:hi], slot0[lo:hi], 8 * nbytes)
        check(torch.equal(bit_lengths.to(torch.int64), 8 * want), f"kernel I's stream lengths differ from A + B's in blocks {lo}..{hi - 1}")
        cols = torch.arange(nbytes, device=symbols.device)[None, :]
        ab = torch.where(cols < want[:, None], rows_ab[lo:hi, :nbytes], 0)
        check(torch.equal(arithmetic_scan.pack_bits(bits), ab), f"kernel I's streams differ from A + B's in blocks {lo}..{hi - 1}")
    del slots, slot0
    coded = float((lengths.to(torch.int64) + 1).sum())
    bound_ms, bound_by = bound(24 * coded, _coder_ops(coded, 8 * float(bl_ab.to(torch.int64).sum()), ar.NUM_CUM))
    print(f"phase timing arith_events at the arithmetic container's shape ({B} x {S}): kernel {ms_i:.4f} ms "
          f"(kernel A {ms_a:.4f} ms at the same shape), bound {bound_ms:.4f} ms ({bound_by}); its records, "
          f"expanded and packed, equal kernels A + B on all {B} blocks", flush=True)


def phase_timing_events(ar, data: bytes, dev) -> dict:
    """Phase 4, kernel I at the stream path's shape (B = 1, S = n + 1) beside its plain version.

    The plain version runs on the same symbols as CPU tensors, the route
    the wrapper takes for them: one block is a loop of ~30 tensor
    operations a step, which the host's per-operation cost bounds less
    than the card's launch cost does.
    """
    from raisin_tpu_torch.ops import arithmetic_scan

    symbols, lengths = stream_symbols(data, "cpu")
    sym_d, len_d = symbols.to(dev), lengths.to(dev)
    steps = float(symbols.shape[1])
    ms = cuda_ms(lambda: ar.encode_events(sym_d, len_d), 3)
    slots_k, s0_k = ar.encode_events(sym_d, len_d)
    bits = float(arithmetic_scan.expand_events(slots_k, s0_k, 8)[1][0])  # the stream's length, prepad included
    slots_k, s0_k = slots_k.cpu(), s0_k.cpu()
    (slots_p, s0_p), plain = plain_ms(lambda: ar._encode_events_torch(symbols, lengths))
    # symbols in, 16 slot bytes and slot0 out per step
    result = _result(max_abs_err((slots_k, slots_p), (s0_k, s0_p)), ms, plain,
                     24 * steps, _coder_ops(steps, bits, ar.NUM_CUM))
    print(f"phase timing arith_events at the stream's shape (1 x {int(steps)}): kernel {ms:.4f} ms, "
          f"plain {plain:.1f} ms on the same symbols on the host CPU, slots and slot0 compared exactly, "
          f"bound {result['bound_ms']:.4f} ms ({result['bound_by']}), max_abs_err {result['max_abs_err']}",
          flush=True)
    return {"arith_events": result}


def events_passes(data: bytes, dev) -> dict:
    """Phase 4: the device ms of each kernel that one call of kernel I launches, at the
    stream's and at the arithmetic container's shapes (:func:`device_kernel_ms`)."""
    from raisin_tpu_torch.ops import arithmetic_rows as ar

    out = {}
    for name in ("stream", "arithmetic container"):
        symbols, lengths = events_input(name, data, dev)
        out[name] = device_kernel_ms(lambda: ar.encode_events(symbols, lengths))
        del symbols, lengths
    print(f"phase timing arith_events, device ms by kernel (profiler): {json.dumps(out)}", flush=True)
    return out


def stream_symbols(data: bytes, dev):
    """The stream path's coder input for ``data``: (symbols (1, n + 1) int32 with EOF at n,
    lengths (1,) int32) on ``dev``, as arithmetic_scan.compress builds them."""
    import torch

    from raisin_tpu_torch.ops.arithmetic_rows import EOF

    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(torch.int32)
    symbols = torch.cat([x, torch.tensor([EOF], dtype=torch.int32)])[None].contiguous()
    return symbols.to(dev), torch.tensor([len(data)], dtype=torch.int32, device=dev)


# kernel I's timing inputs: STREAM_BYTES at B = 1 as the stream path hands them to it (the corpus,
# the lzss,arithmetic stream's tokens at window WINDOW, seeded random bytes, zero bytes), and the
# arithmetic container's shape (the corpus's MAIN_BYTES in BLOCK_SIZE blocks)
EVENTS_INPUTS = ("stream", "lzss,arithmetic stream", "random stream", "zeros stream", "arithmetic container")


def events_input(name: str, data: bytes, dev):
    """One of EVENTS_INPUTS: (symbols, lengths) on ``dev``."""
    import raisin_tpu_torch as rt
    from raisin_tpu_torch.ops import pipeline

    if name == "arithmetic container":
        payload, n, _ = coder_input("arithmetic", data, dev)
        return pipeline.arith_symbols(payload, n), n
    src = {
        "stream": lambda: data[:STREAM_BYTES],
        "lzss,arithmetic stream": lambda: rt.compress_bytes(data[:STREAM_BYTES], ["lzss"], backend="device", device=dev),
        "random stream": lambda: np.random.default_rng(17).integers(0, 256, STREAM_BYTES, dtype=np.uint8).tobytes(),
        "zeros stream": lambda: bytes(STREAM_BYTES),
    }[name]()
    return stream_symbols(src, dev)


def time_events(data: bytes, dev) -> dict:
    """Kernel I on each of EVENTS_INPUTS, without its plain version.

    Per input: the symbols' shape, ms per call (CUDA events over 3, after a
    warm-up), the device ms of each kernel one call launches (the
    profiler's names), and a digest of (slots, slot0) (equal digests from
    two trees mean equal outputs).
    """
    from raisin_tpu_torch.ops import arithmetic_rows as ar

    out = {}
    for name in EVENTS_INPUTS:
        symbols, lengths = events_input(name, data, dev)
        ar.encode_events(symbols, lengths)  # warm-up: a process's first launch also loads the kernel
        ms = cuda_ms(lambda: ar.encode_events(symbols, lengths), 3)
        passes = device_kernel_ms(lambda: ar.encode_events(symbols, lengths))
        slots, slot0 = ar.encode_events(symbols, lengths)
        h = hashlib.sha256(slots.cpu().numpy())
        h.update(slot0.cpu().numpy())
        out[name] = {"shape": list(symbols.shape), "ms": ms, "device_kernels_ms": passes,
                     "digest": h.hexdigest()[:32]}
        print(f"phase events {name} {list(symbols.shape)}: kernel {ms:.4f} ms, digest {out[name]['digest']}, "
              f"device ms by kernel (profiler) {json.dumps(passes)}", flush=True)
        del symbols, slots, slot0
    return out


def match_tiles() -> dict | None:
    """Kernel D's tiles by path since its counts were last set to 0, or None where
    the wrapper keeps no such counts (trees before the chain path)."""
    from raisin_tpu_torch.ops import lzss_match

    fm = lzss_match.find_matches
    return {"chain": fm.chain_tiles, "sweep": fm.sweep_tiles} if hasattr(fm, "chain_tiles") else None


# kernel D's timing inputs: the corpus at the container's shape, the stream's shape, and the two
# worst cases at the container's shape, MAIN_BYTES of zero bytes (every tile sweeps) and of
# seeded random bytes (~0.06 2-gram candidates a position)
MATCH_INPUTS = ("corpus", "stream", "zeros", "random")


def match_blocks(name: str, data: bytes) -> list[bytes]:
    """One of MATCH_INPUTS as blocks: BLOCK_SIZE blocks, or one block of STREAM_BYTES for the stream."""
    if name == "stream":
        return [data[:STREAM_BYTES]]
    src = {
        "corpus": lambda: data,
        "zeros": lambda: bytes(MAIN_BYTES),
        "random": lambda: np.random.default_rng(11).integers(0, 256, MAIN_BYTES, dtype=np.uint8).tobytes(),
    }[name]()
    return [src[i : i + BLOCK_SIZE] for i in range(0, len(src), BLOCK_SIZE)]


def time_match(data: bytes, dev, plain: bool) -> dict:
    """Kernel D at window WINDOW on each of MATCH_INPUTS, escaped as the container escapes them.

    Per input: the escaped shape, ms per launch (CUDA events over 3), the
    tiles by path of one launch, and a digest of (L, D) (equal digests from
    two trees mean equal outputs); with ``plain``, also the plain version's
    ms, max_abs_err against it and the bound.
    """
    import torch

    from raisin_tpu_torch.ops import escape, lzss_match

    out = {}
    for name in MATCH_INPUTS:
        m, n = padded(match_blocks(name, data))
        xe, en = escape.escape_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
        del m
        lzss_match.find_matches(xe, en, WINDOW)  # warm-up: a process's first launch also loads the kernel
        ms = cuda_ms(lambda: lzss_match.find_matches(xe, en, WINDOW), 3)
        before = match_tiles()
        L, D = lzss_match.find_matches(xe, en, WINDOW)
        after = match_tiles()
        tiles = None if before is None else {k: after[k] - v for k, v in before.items()}
        r = {"shape": list(xe.shape), "ms": ms, "tiles": tiles,
             "digest": sha(L.cpu().numpy().tobytes() + D.cpu().numpy().tobytes())}
        if plain:
            (L_p, D_p), plain_d = plain_ms(lambda: lzss_match._find_matches_torch(xe, en, WINDOW))
            esc = float(en.to(torch.int64).sum())
            # bytes in, (L, D) out; a binary-tree match finder (LZMA's bt4) visits ~log2(window)
            # nodes a position, where the sweep (and the JAX scan) try every distance
            r.update(_result(max_abs_err((L, L_p), (D, D_p)), ms, plain_d,
                             9 * esc, int(np.ceil(np.log2(WINDOW))) * esc))
            del L_p, D_p
        out[name] = r
        del L, D, xe, en
    return out


def phase_timing_lzss(data: bytes, tok_lens: list[int], dev) -> dict:
    """Phase 4, LZSS: kernels D, E, F at the main path's shapes beside their plain versions.

    Kernel D also runs on the stream's shape and on the worst cases
    (:func:`time_match`): the zero blocks must take its sweep path, the
    corpus and the random blocks its chain path.
    """
    import torch

    from raisin_tpu_torch.ops import escape, lzss_commit, lzss_decode, lzss_match

    match = time_match(data, dev, plain=True)
    for name, r in match.items():
        check(r["max_abs_err"] == 0, f"kernel D differs from its plain version on {name} (err {r['max_abs_err']})")
        print(f"phase timing lzss_match on {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), tiles by path "
              f"{r['tiles']}, max_abs_err {r['max_abs_err']}", flush=True)
    paths = {name: {k for k, v in r["tiles"].items() if v} for name, r in match.items()}
    check(paths == {"corpus": {"chain"}, "stream": {"chain"}, "zeros": {"sweep"}, "random": {"chain"}},
          f"kernel D's tiles took unexpected paths: {paths}")
    timing = ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")  # the corpus's, as for every kernel
    results = {"lzss_match": {k: match["corpus"][k] for k in timing}}
    results["lzss_match"]["inputs"] = {name: {k: r[k] for k in ("shape", *timing, "tiles")}
                                       for name, r in match.items()}

    m, n = padded([data[i : i + BLOCK_SIZE] for i in range(0, len(data), BLOCK_SIZE)])
    xe, en = escape.escape_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
    esc = float(en.to(torch.int64).sum())
    L_k, D_k = lzss_match.find_matches(xe, en, WINDOW)
    ranges = results["lzss_match"]["ranges"] = time_match_ranges(xe, en, L_k, D_k)
    for name, r in ranges.items():
        print(f"phase timing lzss_match over {name} on the corpus {list(xe.shape)}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.1f} ms, tiles by path {r['tiles']}, max_abs_err 0 (whole window "
              f"{match['corpus']['ms']:.4f} ms); the halves' MAX combine equals the whole window's output",
              flush=True)

    ms_e = cuda_ms(lambda: lzss_commit.commit_tokens(xe, L_k, D_k, en), 3)
    tok_k, tl_k = lzss_commit.commit_tokens(xe, L_k, D_k, en)
    (tok_p, tl_p), plain_e = plain_ms(lambda: lzss_commit._commit_tokens_torch(xe, L_k, D_k, en))
    toks = float(tl_k.to(torch.int64).sum())
    results["lzss_commit"] = _result(max_abs_err((tok_k, tok_p), (tl_k, tl_p)), ms_e, plain_e,
                                     9 * esc + toks, 4 * esc)
    check(tl_k.cpu().tolist() == list(tok_lens), "kernel E's token lengths differ from the main path's aux table")
    passes = {"container": device_kernel_ms(lambda: lzss_commit.commit_tokens(xe, L_k, D_k, en))}
    del L_k, D_k, tok_p
    args = commit_input("stream", data, dev)
    r = results["lzss_commit"]["stream"] = commit_result(args)
    check(r["max_abs_err"] == 0, f"kernel E differs from its plain version on the stream (err {r['max_abs_err']})")
    print(f"phase timing lzss_commit on the stream {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.1f} "
          f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']}", flush=True)
    passes["stream"] = device_kernel_ms(lambda: lzss_commit.commit_tokens(*args))
    del args
    results["lzss_commit"]["device_kernels_ms"] = passes
    print(f"phase timing lzss_commit, device ms by kernel (profiler): {json.dumps(passes)}", flush=True)

    tok = token_rows(tok_k, tl_k)
    results["lzss_decode"] = walk_result((tok, tl_k, 2 * BLOCK_SIZE))
    del results["lzss_decode"]["shape"]
    rows_k, ol_k, _ = lzss_decode.walk_tokens(tok, tl_k, 2 * BLOCK_SIZE)
    check(torch.equal(rows_k[:, : xe.shape[1]], xe) and torch.equal(ol_k, en), "kernel F did not restore the main path's blocks")
    del rows_k, ol_k, tok, tok_k, xe
    for name in ("zeros", "chained"):
        args, _ = walk_input(name, data, dev)
        r = results["lzss_decode"][name] = walk_result(args)
        check(r["max_abs_err"] == 0, f"kernel F differs from its plain version on {name} (err {r['max_abs_err']})")
        print(f"phase timing lzss_decode on {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.1f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']}", flush=True)
        del args
    return results


# kernel E's timing inputs: the corpus at the container's shape (MAIN_BYTES in BLOCK_SIZE blocks) and
# at the stream's (STREAM_BYTES at B = 1), zero bytes (a commit every 4096 positions) at both shapes
# and MAIN_BYTES of seeded random bytes, each escaped with L and D from kernel D at window WINDOW; and
# the field L = 2 after a literal at position 0 on the corpus's bytes at both shapes (walks from even
# positions never meet the parse)
COMMIT_INPUTS = ("corpus", "stream", "zeros", "zeros stream", "random", "L=2 container", "L=2 stream")


def commit_input(name: str, data: bytes, dev):
    """One of COMMIT_INPUTS: kernel E's arguments (x, L, D, lengths) on ``dev``."""
    import torch

    from raisin_tpu_torch.ops import escape, lzss_match

    if name == "zeros stream":
        m, n = padded([bytes(STREAM_BYTES)])
    else:
        m, n = padded(match_blocks({"L=2 container": "corpus", "L=2 stream": "stream"}.get(name, name), data))
    xe, en = escape.escape_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
    del m
    if name.startswith("L=2"):
        L = torch.full(xe.shape, 2, dtype=torch.int32, device=dev)
        L[:, 0] = 1
        return xe, L, torch.ones_like(L), en
    return (xe, *lzss_match.find_matches(xe, en, WINDOW), en)


def commit_result(args) -> dict:
    """Kernel E on ``args`` beside its plain version on the card: _result's keys and the shape."""
    import torch

    from raisin_tpu_torch.ops import lzss_commit

    ms = cuda_ms(lambda: lzss_commit.commit_tokens(*args), 3)
    tok, tl = lzss_commit.commit_tokens(*args)
    (tok_p, tl_p), plain = plain_ms(lambda: lzss_commit._commit_tokens_torch(*args))
    esc = float(args[3].to(torch.int64).sum())
    # as phase_timing_lzss's bound: bytes, L and D in, tokens out
    return {"shape": list(args[0].shape),
            **_result(max_abs_err((tok, tok_p), (tl, tl_p)), ms, plain, 9 * esc + float(tl.to(torch.int64).sum()),
                      4 * esc)}


def time_commit(data: bytes, dev) -> dict:
    """Kernel E on each of COMMIT_INPUTS, without its plain version.

    Per input: the shape, the token bytes, ms per call (CUDA events over 3,
    after a warm-up), the device ms of each kernel one call launches (the
    profiler's names), and a digest of (tok, tok_len) (equal digests from
    two trees mean equal outputs).
    """
    from raisin_tpu_torch.ops import lzss_commit

    out = {}
    for name in COMMIT_INPUTS:
        args = commit_input(name, data, dev)
        lzss_commit.commit_tokens(*args)  # warm-up
        ms = cuda_ms(lambda: lzss_commit.commit_tokens(*args), 3)
        passes = device_kernel_ms(lambda: lzss_commit.commit_tokens(*args))
        tok, tl = lzss_commit.commit_tokens(*args)
        h = hashlib.sha256(tok.cpu().numpy())
        h.update(tl.cpu().numpy())
        out[name] = {"shape": list(args[0].shape), "token_bytes": int(tl.sum()), "ms": ms,
                     "device_kernels_ms": passes, "digest": h.hexdigest()[:32]}
        print(f"phase commit {name} {list(args[0].shape)}, {out[name]['token_bytes']} token bytes: kernel {ms:.4f} "
              f"ms, digest {out[name]['digest']}, device ms by kernel (profiler) {json.dumps(passes)}", flush=True)
        del args, tok, tl
    return out


def token_rows(tok, tok_len):
    """Token rows as the container hands them to kernel F: max(tok_len) + 1 bytes wide."""
    import torch

    width = int(tok_len.max()) + 1
    return torch.nn.functional.pad(tok[:, : width - 1], (0, 1)).contiguous()


def chained(out_bytes: int, d: int, L: int) -> bytes:
    """``d`` literals, then tokens "<d,L>" up to ``out_bytes`` of output: with L = d each copies
    the one before it; with L < d its source also takes the end of the token before that."""
    return b"abcdefghijklmnopqrstuvwxyz"[:d] + f"<{d},{L}>".encode() * max(0, (out_bytes - d) // L)


# kernel F's timing inputs: the lzss,arithmetic container's token rows (the corpus through
# kernels D and E at window WINDOW, MAIN_BYTES in BLOCK_SIZE blocks), MAIN_BYTES of zero bytes
# and of seeded random bytes the same way, and two chains of tokens in as many blocks, each of
# up to BLOCK_SIZE output bytes: "abcdef" then "<6,6>" (each token copies the one before it)
# and "abcde" then "<5,4>" (each source spans two tokens' outputs)
WALK_INPUTS = ("lzss,arithmetic", "zeros", "random", "chained", "chain <5,4>")


def walk_input(name: str, data: bytes, dev):
    """One of WALK_INPUTS: (kernel F's arguments (tok, tok_len, cap_out) on ``dev``, the rows'
    bytes it must give back: the escaped blocks, or one chain's output)."""
    import torch

    from raisin_tpu_torch.ops import escape, lzss_commit, lzss_match

    blocks = MAIN_BYTES // BLOCK_SIZE
    if name.startswith("chain"):
        d, L = (6, 6) if name == "chained" else (5, 4)
        stream = chained(BLOCK_SIZE, d, L)
        tok = torch.frombuffer(bytearray(stream), dtype=torch.uint8).to(dev)
        n = torch.full((blocks,), len(stream), dtype=torch.int32, device=dev)
        out = (stream[:d] * (BLOCK_SIZE // d + 1))[: d + (BLOCK_SIZE - d) // L * L]  # each copies d bytes back
        return (tok.expand(blocks, -1).contiguous(), n, 2 * BLOCK_SIZE), out
    m, n = padded(match_blocks({"lzss,arithmetic": "corpus"}.get(name, name), data))
    xe, en = escape.escape_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
    del m
    tok, tl = lzss_commit.commit_tokens(xe, *lzss_match.find_matches(xe, en, WINDOW), en)
    return (token_rows(tok, tl), tl, 2 * BLOCK_SIZE), (xe, en)


def walk_result(args) -> dict:
    """Kernel F on ``args`` beside its plain version on the card: _result's keys and the shape."""
    import torch

    from raisin_tpu_torch.ops import lzss_decode

    ms = cuda_ms(lambda: lzss_decode.walk_tokens(*args), 3)
    got = lzss_decode.walk_tokens(*args)
    want, plain = plain_ms(lambda: lzss_decode._walk_tokens_torch(*args))
    toks, esc = (float(v.to(torch.int64).sum()) for v in (args[1], got[1]))
    # token bytes in, escaped bytes out; a byte-serial walk reads each token byte and writes each output byte
    return {"shape": list(args[0].shape), **_result(max_abs_err(*zip(got, want)), ms, plain, toks + esc, 2 * toks)}


def walk_stats(args) -> dict | None:
    """Kernel F's rounds and one-warp steps on ``args``, summed over the blocks, and their most in
    a block; None where the wrapper takes no stats (trees before the rounds)."""
    import inspect

    import torch

    from raisin_tpu_torch.ops import lzss_decode

    if "stats" not in inspect.signature(lzss_decode.walk_tokens).parameters:
        return None
    st = torch.zeros((args[0].shape[0], 2), dtype=torch.int32, device=args[0].device)
    lzss_decode.walk_tokens(*args, stats=st)
    rounds, steps = st.to(torch.int64).cpu().T
    return {"rounds": int(rounds.sum()), "max_rounds": int(rounds.max()), "steps": int(steps.sum()),
            "max_steps": int(steps.max())}


def time_walk(data: bytes, dev) -> dict:
    """Kernel F on each of WALK_INPUTS, without its plain version.

    Per input: the shape, the token bytes, ms per call (CUDA events over 3,
    after a warm-up), the device ms of each kernel one call launches (the
    profiler's names), the kernel's rounds and one-warp steps where it
    reports them, and a digest of (rows, out_len, err) (equal digests from
    two trees mean equal outputs); each input must come back.
    """
    import torch

    from raisin_tpu_torch.ops import lzss_decode

    out = {}
    for name in WALK_INPUTS:
        args, want = walk_input(name, data, dev)
        lzss_decode.walk_tokens(*args)  # warm-up
        ms = cuda_ms(lambda: lzss_decode.walk_tokens(*args), 3)
        passes = device_kernel_ms(lambda: lzss_decode.walk_tokens(*args))
        rows, ol, fl = lzss_decode.walk_tokens(*args)
        if isinstance(want, bytes):
            row = torch.frombuffer(bytearray(want), dtype=torch.uint8).to(dev)
            ok = bool((ol == len(want)).all()) and torch.equal(rows[:, : len(want)], row.expand(len(ol), -1))
        else:
            xe, en = want
            ok = torch.equal(ol, en) and torch.equal(rows[:, : xe.shape[1]], xe)
        check(ok and not fl.any() and not rows[:, int(ol.max()) :].any(), f"kernel F did not give back {name}")
        h = hashlib.sha256(rows.cpu().numpy())
        h.update(ol.cpu().numpy())
        h.update(fl.cpu().numpy())
        out[name] = {"shape": list(args[0].shape), "token_bytes": int(args[1].sum()), "ms": ms,
                     "device_kernels_ms": passes, "stats": walk_stats(args), "digest": h.hexdigest()[:32]}
        print(f"phase walk {name} {out[name]['shape']}, {out[name]['token_bytes']} token bytes: kernel {ms:.4f} ms, "
              f"rounds {json.dumps(out[name]['stats'])}, digest {out[name]['digest']}, device ms by kernel "
              f"(profiler) {json.dumps(passes)}", flush=True)
        del args, want, rows, ol, fl
    return out


def phase_timing_huffman(data: bytes, tok_lens: list[int], dev) -> dict:
    """Phase 4, Huffman: kernels G, H at the lzss,huffman main path's shapes beside their plain versions.

    The inputs are the main path's: kernel E's token streams of the corpus
    at window 4096 and the code tables the container builds for them.
    """
    import torch

    from raisin_tpu_torch.ops import huffman_rows

    tok, tl = huffman_input("lzss,huffman container", data, dev)
    check(tl.cpu().tolist() == list(tok_lens), "kernel E's token lengths differ from the lzss,huffman aux table")
    (_, _, codes_t, lens_t, capw), bits, counts = huffman_encode_args(tok, tl)
    want = ((bits + 7) // 8).cpu().numpy()
    kw = encode_kwargs(bits)  # the totals, as encode_blocks hands them over
    B = tok.shape[0]
    toks = float(tl.to(torch.int64).sum())
    payload = float(want.sum())
    results = {}

    ms_g = cuda_ms(lambda: huffman_rows.encode_rows(tok, tl, codes_t, lens_t, capw, **kw), 5)
    rows_k, bl_k, pad_k = huffman_rows.encode_rows(tok, tl, codes_t, lens_t, capw, **kw)
    (rows_p, bl_p, pad_p), plain_g = plain_ms(lambda: huffman_rows._encode_rows_torch(tok, tl, codes_t, lens_t, capw))
    # tokens and tables in, payload out; per symbol a code load, a scan add, a shift and an OR
    results["huffman_encode"] = _result(max_abs_err((rows_k, rows_p), (bl_k, bl_p), (pad_k, pad_p)), ms_g, plain_g,
                                        toks + 8 * huffman_rows.NSYM * B + payload + 8 * B, 4 * toks)
    check(bl_k.cpu().numpy().tolist() == want.tolist(), "kernel G's payload lengths differ from the code tables'")
    del rows_p

    tables_t = torch.from_numpy(child_tables(counts)).to(dev)
    cap_out = -(-int(tl.max()) // 4) * 4
    ms_h = cuda_ms(lambda: huffman_rows.decode_rows(rows_k, pad_k, bl_k, tables_t, cap_out), 3)
    out_k, cnt_k, ok_k = huffman_rows.decode_rows(rows_k, pad_k, bl_k, tables_t, cap_out)
    (out_p, cnt_p, ok_p), plain_h = plain_ms(
        lambda: huffman_rows._decode_rows_torch(rows_k, pad_k, bl_k, tables_t, cap_out))
    # payload and tables in, tokens out; a table-driven decode takes a symbol a step: a peek of the
    # next bits, a table load, a shift, a store (building a 4096-entry table a block adds ~0.1%)
    results["huffman_decode"] = _result(max_abs_err((out_k, out_p), (cnt_k, cnt_p), (ok_k, ok_p)), ms_h, plain_h,
                                        payload + 4 * huffman_rows.NTAB * B + toks + 8 * B, 4 * toks)
    check(bool(ok_k.all()) and torch.equal(cnt_k, tl), "kernel H did not end every walk at the root")
    check(torch.equal(out_k[:, :cap_out], torch.nn.functional.pad(tok, (0, max(0, cap_out - tok.shape[1])))[:, :cap_out]),
          "kernel H did not restore the main path's token streams")
    return results


def huffman_rows_of(x, n) -> tuple:
    """Blocks (x, n) on the card coded as the container codes them (counts, host trees,
    kernel G): kernel H's arguments (payload rows, pads, byte lengths, child tables, cap_out)."""
    import torch

    from raisin_tpu_torch.ops import huffman_rows

    args, bits, counts = huffman_encode_args(x, n)
    rows, bl, pads = huffman_rows.encode_rows(*args, **encode_kwargs(bits))
    tables = torch.from_numpy(child_tables(counts)).to(x.device)
    return rows, pads, bl, tables, -(-int(n.max()) // 4) * 4


def huffman_encode_args(x, n) -> tuple:
    """Blocks (x, n) on the card with the code tables the container makes for them (counts on
    the card, trees on the host): (kernel G's arguments (x, n, codes, code_lens, capw), each
    block's bit total (B,) int64 on the card, the symbol counts)."""
    import torch

    from raisin_tpu_torch.ops import huffman_blocks, huffman_rows

    counts = huffman_blocks.count_symbols(x, n)
    codes, code_lens, _, on_host = huffman_blocks.code_tables(counts)
    check(not on_host.any(), "a block for kernel G is not ASCII")
    nbits = (counts[:, : huffman_rows.NSYM] * code_lens).sum(1)
    capw = max(1, (int((nbits.max() + 7) // 8) + 3) // 4)
    codes_t = torch.from_numpy(codes.view(np.int32)).to(x.device)
    args = (x, n, codes_t, torch.from_numpy(code_lens).to(x.device), capw)
    return args, torch.from_numpy(nbits).to(x.device), counts


def encode_kwargs(bits) -> dict:
    """``bits=`` for a kernel G wrapper that takes the callers' bit totals (this tree's); nothing
    for an earlier tree's, which sums them itself."""
    import inspect

    from raisin_tpu_torch.ops import huffman_rows

    return {"bits": bits} if "bits" in inspect.signature(huffman_rows.encode_rows).parameters else {}


# kernel H's inputs: the lzss,huffman container's token rows and the huffman container's
# blocks of the corpus (MAIN_BYTES in BLOCK_SIZE blocks), the huffman stream (STREAM_BYTES at
# B = 1), and uniform random ASCII, whose 7-bit codes never resynchronise, at both shapes
HDECODE_INPUTS = ("lzss,huffman container", "huffman container", "huffman stream", "uniform ASCII stream",
                  "uniform ASCII container")


def skewed(n: int) -> bytes:
    """Seeded lower-case bytes, 15 of every 16 of them 'e': the tree gives 'e' a 1-bit code."""
    rng = np.random.default_rng(31)
    return np.where(rng.random(n) < 15 / 16, ord("e"), rng.integers(97, 123, n)).astype(np.uint8).tobytes()


def huffman_input(name: str, data: bytes, dev):
    """The blocks (x, n) on ``dev`` of one of HDECODE_INPUTS or HENCODE_INPUTS."""
    import torch

    from raisin_tpu_torch.ops import escape, lzss_commit, lzss_match

    def blocks(src: bytes, size: int):
        m, n = padded([src[i : i + size] for i in range(0, len(src), size)])
        return torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev)

    if name == "lzss,huffman container":
        xe, en = escape.escape_blocks(*blocks(data, BLOCK_SIZE))
        L, D = lzss_match.find_matches(xe, en, WINDOW)
        return lzss_commit.commit_tokens(xe, L, D, en)
    return {
        "huffman container": lambda: blocks(data, BLOCK_SIZE),
        "huffman stream": lambda: blocks(data[:STREAM_BYTES], STREAM_BYTES),
        "corpus stream": lambda: blocks(data, MAIN_BYTES),
        "uniform ASCII stream": lambda: blocks(uniform_ascii(STREAM_BYTES), STREAM_BYTES),
        "uniform ASCII container": lambda: blocks(uniform_ascii(MAIN_BYTES), BLOCK_SIZE),
        "skewed container": lambda: blocks(skewed(MAIN_BYTES), BLOCK_SIZE),
    }[name]()


def hdecode_input(name: str, data: bytes, dev):
    """One of HDECODE_INPUTS: ((x, n) the blocks on ``dev``, kernel H's arguments)."""
    x, n = huffman_input(name, data, dev)
    return (x, n), huffman_rows_of(x, n)


def check_restored(x, n, out, cnt, ok, what: str) -> None:
    """Kernel H gave back the blocks: every count, every walk ending on a boundary, every byte."""
    import torch

    w = min(x.shape[1], out.shape[1])
    inside = torch.arange(w, device=x.device)[None, :] < n[:, None]
    check(bool(ok.all()) and torch.equal(cnt, n.to(cnt.dtype)), f"kernel H did not end every walk at the root ({what})")
    check(torch.equal(out[:, :w][inside], x[:, :w][inside]), f"kernel H did not restore the blocks ({what})")


def time_hdecode(data: bytes, dev) -> dict:
    """Kernel H on each of HDECODE_INPUTS, without its plain version.

    Per input: the rows' shape, ms per call (CUDA events over 3, after a
    warm-up), the device ms of each kernel one call launches (the
    profiler's names), and a digest of (rows, counts, ok) (equal digests
    from two trees mean equal outputs); each must give back its blocks.
    """
    import torch

    from raisin_tpu_torch.ops import huffman_rows

    out = {}
    for name in HDECODE_INPUTS:
        (x, n), args = hdecode_input(name, data, dev)
        huffman_rows.decode_rows(*args)  # warm-up
        ms = cuda_ms(lambda: huffman_rows.decode_rows(*args), 3)
        passes = device_kernel_ms(lambda: huffman_rows.decode_rows(*args))
        rows, cnt, ok = huffman_rows.decode_rows(*args)
        check_restored(x, n, rows, cnt, ok, name)
        h = hashlib.sha256(rows.cpu().numpy())
        h.update(cnt.cpu().numpy())
        h.update(ok.cpu().numpy())
        payload = int(args[2].to(torch.int64).sum())
        out[name] = {"shape": list(args[0].shape), "payload_bytes": payload, "ms": ms, "device_kernels_ms": passes,
                     "digest": h.hexdigest()[:32]}
        print(f"phase hdecode {name} {list(args[0].shape)}, {payload} payload bytes: kernel {ms:.4f} ms, digest "
              f"{out[name]['digest']}, device ms by kernel (profiler) {json.dumps(passes)}", flush=True)
        del x, n, args, rows
    return out


def hdecode_result(args, toks: float, plain_rows: int | None = None) -> dict:
    """Kernel H on ``args`` beside its plain version on the card (on the first ``plain_rows`` rows
    only, where given): _result's keys, the kernel's ms on all rows."""
    import torch

    from raisin_tpu_torch.ops import huffman_rows

    rows, pads, bl, tables, cap_out = args
    ms = cuda_ms(lambda: huffman_rows.decode_rows(*args), 3)
    k = plain_rows or rows.shape[0]
    part = (rows[:k].contiguous(), pads[:k].contiguous(), bl[:k].contiguous(), tables[:k].contiguous(), cap_out)
    got = huffman_rows.decode_rows(*part)
    want, plain = plain_ms(lambda: huffman_rows._decode_rows_torch(*part))
    B = rows.shape[0]
    payload = float(bl.to(torch.int64).sum())
    # as phase_timing_huffman's bound: payload and tables in, tokens out; a table step a symbol
    return _result(max_abs_err(*zip(got, want)), ms, plain, payload + 4 * huffman_rows.NTAB * B + toks + 8 * B,
                   4 * toks)


def phase_timing_hdecode(data: bytes, dev) -> dict:
    """Phase 4, kernel H beyond the container's shape: the huffman stream's shape (B = 1) and
    uniform ASCII's container shape (its plain version on the first PLAIN_BLOCKS rows) beside
    the plain version, and each device kernel's ms at the container's and the stream's shapes."""
    import torch

    from raisin_tpu_torch.ops import huffman_rows

    out = {}
    for name, key, plain_rows in (("huffman stream", "stream", None), ("uniform ASCII container", "uniform_ascii",
                                                                       PLAIN_BLOCKS)):
        (x, n), args = hdecode_input(name, data, dev)
        r = hdecode_result(args, float(n.to(torch.int64).sum()), plain_rows)
        check(r["max_abs_err"] == 0, f"kernel H differs from its plain version on the {name} (err {r['max_abs_err']})")
        check_restored(x, n, *huffman_rows.decode_rows(*args), name)
        out[key] = r
        print(f"phase timing huffman_decode on the {name} {list(args[0].shape)}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.1f} ms{' on the first %d rows' % plain_rows if plain_rows else ''}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']}", flush=True)
        del x, n, args
    passes = {}
    for name in ("lzss,huffman container", "huffman stream"):
        _, args = hdecode_input(name, data, dev)
        passes[name] = device_kernel_ms(lambda: huffman_rows.decode_rows(*args))
        del args
    out["device_kernels_ms"] = passes
    print(f"phase timing huffman_decode, device ms by kernel (profiler): {json.dumps(passes)}", flush=True)
    return out


# kernel G's inputs: the lzss,huffman container's token rows and the huffman container's blocks of
# the corpus (MAIN_BYTES in BLOCK_SIZE blocks), the huffman stream (STREAM_BYTES at B = 1), the whole
# corpus as one block (what compress_bytes(..., "huffman") of a MAIN_BYTES file launches), and, in
# BLOCK_SIZE blocks, uniform random ASCII (7-bit codes) and skewed bytes (a 1-bit code)
HENCODE_INPUTS = ("lzss,huffman container", "huffman container", "huffman stream", "corpus stream",
                  "uniform ASCII container", "skewed container")


def _encode_bound(x, n, bl) -> tuple[float, str]:
    """Kernel G's bound, as phase 4's: symbols and tables in, payload out; per symbol a code load,
    a scan add, a shift and an OR."""
    import torch

    from raisin_tpu_torch.ops import huffman_rows

    B = x.shape[0]
    toks, payload = float(n.to(torch.int64).sum()), float(bl.to(torch.int64).sum())
    return bound(toks + 8 * huffman_rows.NSYM * B + payload + 8 * B, 4 * toks)


def time_hencode(data: bytes, dev, plain: bool) -> dict:
    """Kernel G on each of HENCODE_INPUTS, with the host's bit totals where the wrapper takes them.

    Per input: the blocks' shape, ms per call (CUDA events over 5, after a
    warm-up; the wrapper's zeroed rows and, in this tree, its check of the
    totals, which waits for the card, included), ms per call followed by the
    host's read of byte_lens (over 20; the container's encode reads G's
    result once a call in every tree, so this is what a call costs it), the
    device ms of each kernel that one call launches (the profiler's names),
    the bound, and a digest of (rows, byte_lens, pads) (equal digests from
    two trees mean equal outputs); with ``plain`` the plain version on the
    card beside it, outputs compared exactly.
    """
    import torch

    from raisin_tpu_torch.ops import huffman_rows

    out = {}
    for name in HENCODE_INPUTS:
        x, n = huffman_input(name, data, dev)
        args, bits, _ = huffman_encode_args(x, n)
        kw = encode_kwargs(bits)
        huffman_rows.encode_rows(*args, **kw)  # warm-up
        ms = cuda_ms(lambda: huffman_rows.encode_rows(*args, **kw), 5)
        ms_read = cuda_ms(lambda: huffman_rows.encode_rows(*args, **kw)[1].cpu(), 20)
        passes = device_kernel_ms(lambda: huffman_rows.encode_rows(*args, **kw))
        rows, bl, pads = huffman_rows.encode_rows(*args, **kw)
        check(bl.to(torch.int64).tolist() == ((bits + 7) // 8).tolist(), f"kernel G's payload lengths differ ({name})")
        h = hashlib.sha256(rows.cpu().numpy())
        h.update(bl.cpu().numpy())
        h.update(pads.cpu().numpy())
        bound_ms, bound_by = _encode_bound(x, n, bl)
        r = {"shape": list(x.shape), "payload_bytes": int(bl.to(torch.int64).sum()), "ms": ms, "ms_with_read": ms_read,
             "bound_ms": bound_ms, "bound_by": bound_by, "device_kernels_ms": passes, "digest": h.hexdigest()[:32]}
        if plain:
            (rows_p, bl_p, pads_p), r["plain_ms"] = plain_ms(lambda: huffman_rows._encode_rows_torch(*args))
            r["max_abs_err"] = max_abs_err((rows, rows_p), (bl, bl_p), (pads, pads_p))
            check(r["max_abs_err"] == 0, f"kernel G differs from its plain version on the {name}")
            del rows_p
        out[name] = r
        print(f"phase hencode {name} {r['shape']}, {r['payload_bytes']} payload bytes: kernel {ms:.4f} ms, "
              f"{ms_read:.4f} ms with the read of byte_lens, bound "
              f"{bound_ms:.4f} ms ({bound_by}), digest {r['digest']}, device ms by kernel (profiler) "
              f"{json.dumps(passes)}"
              + (f", plain {r['plain_ms']:.1f} ms, max_abs_err {r['max_abs_err']}" if plain else ""), flush=True)
        del x, n, args, rows
    return out


# kernel B's inputs: kernel A's rows of DECODE_INPUTS, as the containers hand them to it
PREPAD_INPUTS = DECODE_INPUTS


def time_prepad(data: bytes, dev, plain: bool) -> dict:
    """Kernel B on kernel A's rows of each of PREPAD_INPUTS.

    Per input: the rows' shape, ms per call (CUDA events over 10, after a
    warm-up), the device ms of each kernel one call launches (profiler), the
    raw bytes that hold stream bits (what B has to read), the bound, and a
    digest of (rows, byte_lens); with ``plain`` the plain version on the
    card beside it, outputs compared exactly.
    """
    import torch

    from raisin_tpu_torch.ops import arithmetic_rows as ar
    from raisin_tpu_torch.ops import pipeline

    out = {}
    for name in PREPAD_INPUTS:
        payload, n, steps = coder_input(name, data, dev)
        symbols = pipeline.arith_symbols(payload, n)
        del payload
        raw, bits, oflow = ar.encode_bits(symbols, n, ar.capw_bound(steps))
        check(not oflow.any(), f"kernel A flagged an overflow on {name}")
        del symbols
        ar.prepad_rows(raw, bits)  # warm-up
        ms = cuda_ms(lambda: ar.prepad_rows(raw, bits), 10)
        passes = device_kernel_ms(lambda: ar.prepad_rows(raw, bits))
        rows, bl = ar.prepad_rows(raw, bits)
        h = hashlib.sha256(rows.cpu().numpy())
        h.update(bl.cpu().numpy())
        b64 = bits.to(torch.int64)
        stream = float(((b64 + 7) // 8).sum())
        out_bytes = float(bl.to(torch.int64).sum())
        # as phase 4's: the stream's bytes in, the payloads out (the rows' zero tails not counted)
        bound_ms, bound_by = bound(stream + out_bytes + 8 * raw.shape[0], 6 * out_bytes / 4)
        r = {"shape": list(raw.shape), "live_raw_bytes": int((4 * ((b64 + 31) // 32)).sum()), "ms": ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "device_kernels_ms": passes, "digest": h.hexdigest()[:32]}
        if plain:
            (rows_p, bl_p), r["plain_ms"] = plain_ms(lambda: ar._prepad_torch(raw, bits))
            r["max_abs_err"] = max_abs_err((rows, rows_p), (bl, bl_p))
            check(r["max_abs_err"] == 0, f"kernel B differs from its plain version on {name}")
            del rows_p
        out[name] = r
        print(f"phase prepad {name} {r['shape']}, {r['live_raw_bytes']} live raw bytes: kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), digest {r['digest']}, device ms by kernel (profiler) "
              f"{json.dumps(passes)}"
              + (f", plain {r['plain_ms']:.1f} ms, max_abs_err {r['max_abs_err']}" if plain else ""), flush=True)
        del raw, bits, rows
    return out


# ---------------------------------------------------------------------------
# Kernel D over a distance sub-range, the mesh, the ranks and the entry points


def match_ranges(window: int) -> tuple[tuple[int, int], ...]:
    """Kernel D's distance sub-ranges (d_lo, d_hi] held against its plain version: both halves, one odd range."""
    return (0, window // 2), (window // 2, window), (3, window - 5)


def match_range(lz, xe, en, window: int, d_lo: int, d_hi: int, tag: str):
    """Kernel D over (d_lo, d_hi] against its plain version; -> (L, D, tiles by path of the launch)."""
    import torch

    before = match_tiles()
    L, D = lz.find_matches(xe, en, window, d_lo, d_hi)
    after = match_tiles()
    L_p, D_p = lz._find_matches_torch(xe, en, window, d_lo, d_hi)
    torch.cuda.synchronize()
    err = max_abs_err((L, L_p), (D, D_p))
    check(err == 0, f"kernel D over ({d_lo}, {d_hi}] differs from its plain version ({tag}, max abs err {err})")
    check(bool(((D > d_lo) | (L == 0)).all()) and bool((D <= d_hi).all()),
          f"kernel D over ({d_lo}, {d_hi}] gave a distance outside the range ({tag})")
    return L, D, {k: after[k] - v for k, v in before.items()}


def halves_combine(full, lo, hi, tag: str) -> None:
    """The two halves' MAX combine (both all-reduce rules, in one process) must give the whole window's launch."""
    import torch

    from raisin_tpu_torch.parallel.lzss_sharded import combine

    L, D = combine(*lo, *hi)
    check(torch.equal(L, full[0]) and torch.equal(D, full[1]),
          f"the halves' MAX combine differs from the whole window's launch ({tag})")


def phase_match_ranges(dev) -> None:
    """Phase 2, kernel D over distance sub-ranges on the edge blocks at windows 16 and WINDOW."""
    import torch

    from raisin_tpu_torch.ops import escape, lzss_match

    m, n = padded(edge_blocks())
    xe, en = escape.escape_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
    tiles = {}
    for window in (16, WINDOW):
        full = lzss_match.find_matches(xe, en, window)
        got = {}
        for d_lo, d_hi in match_ranges(window):
            L, D, tiles[f"({d_lo}, {d_hi}]"] = match_range(lzss_match, xe, en, window, d_lo, d_hi,
                                                             f"edge blocks, window {window}")
            got[d_lo, d_hi] = (L, D)
        halves_combine(full, got[0, window // 2], got[window // 2, window], f"edge blocks, window {window}")
    print(f"phase kernel D over distance sub-ranges vs plain: equal on {xe.shape[0]} edge blocks at windows 16 "
          f"and {WINDOW}, ranges {[list(r) for w in (16, WINDOW) for r in match_ranges(w)]}, the halves' MAX "
          f"combine equals the whole window's launch; tiles by path {tiles}", flush=True)


def time_match_ranges(xe, en, L_full, D_full) -> dict:
    """Kernel D at the container's shape over (0, WINDOW / 2] and (WINDOW / 2, WINDOW], each timed beside the
    whole window and held against its plain version; the halves' combine equals the whole window's output."""
    from raisin_tpu_torch.ops import lzss_match

    out, halves = {}, []
    for d_lo, d_hi in match_ranges(WINDOW)[:2]:
        lzss_match.find_matches(xe, en, WINDOW, d_lo, d_hi)
        ms = cuda_ms(lambda: lzss_match.find_matches(xe, en, WINDOW, d_lo, d_hi), 3)
        before = match_tiles()
        L, D = lzss_match.find_matches(xe, en, WINDOW, d_lo, d_hi)
        after = match_tiles()
        (L_p, D_p), plain = plain_ms(lambda: lzss_match._find_matches_torch(xe, en, WINDOW, d_lo, d_hi))
        err = max_abs_err((L, L_p), (D, D_p))
        check(err == 0, f"kernel D over ({d_lo}, {d_hi}] differs from its plain version on the corpus (err {err})")
        out[f"({d_lo}, {d_hi}]"] = {"ms": ms, "plain_ms": plain, "max_abs_err": err,
                                    "tiles": {k: after[k] - v for k, v in before.items()}}
        halves.append((L, D))
        del L_p, D_p
    halves_combine((L_full, D_full), *halves, "the corpus at the container's shape")
    return out


TWO_RANK_BYTES = 4 << 20  # the two-rank container's input: the corpus's first 4 MiB
RANK_TIMEOUT = 600  # seconds a rank process may take
STEP_B, STEP_S = 4, BLOCK_SIZE  # the two-rank step's blocks of the corpus


def phase_mesh(data: bytes, lz_container: bytes, lz_rates: dict, wrappers: dict, reset, card: str, dev) -> None:
    """The mesh phase: the default container over ``data_mesh()`` (every card: one here), ``devices="auto"``
    through compress_file and the command line, and ``-devices=2`` refused by name."""
    import os
    import tempfile

    import torch

    from raisin_tpu_torch.engine.core import compress_file
    from raisin_tpu_torch.parallel import blocks, data_mesh

    mesh = data_mesh()
    check(mesh.shape == {"data": torch.cuda.device_count()}, f"data_mesh() is {mesh}")

    def run():
        return blocks.compress_container(data, LZ, BLOCK_SIZE, mesh=mesh, window=WINDOW)

    check(blocks.decompress_container(run(), mesh=mesh) == data, "the mesh warm-up round trip differs")
    reset()
    t_enc, t_dec = [], []
    for rep in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = run()
        t_enc.append(time.perf_counter() - t0)
        check(c == lz_container, f"the container over {mesh} differs from phase 3's default container")
        t0 = time.perf_counter()
        back = blocks.decompress_container(c, mesh=mesh)
        t_dec.append(time.perf_counter() - t0)
        check(back == data, f"the container over {mesh} did not round-trip")
        if rep == 0:
            launches = {name: fn.launches for name, fn in wrappers.items()}
            check(all(launches[k] > 0 for k in wrappers), f"the mesh path did not launch every kernel: {launches}")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "corpus")
        with open(src, "wb") as f:
            f.write(data)
        compress_file(list(LZ), src, src + ".file.rsn", quiet=True, container=True, block_size=BLOCK_SIZE,
                      devices="auto", window=WINDOW)
        sizes = [f"-blocksize={BLOCK_SIZE}", f"-window={WINDOW}"]
        rc, _ = run_cli(["raisin", "-compress", "-container", "-devices=auto", *sizes, f"-out={src}.cli.rsn", src])
        check(rc == 0, f"raisin -container -devices=auto exited {rc}")
        for tag in ("file", "cli"):
            with open(f"{src}.{tag}.rsn", "rb") as f:
                check(f.read() == lz_container, f"devices=auto through {tag} wrote other bytes than phase 3")
        rc, out = run_cli(["raisin", "-compress", "-container", "-devices=2", *sizes, f"-out={src}.two.rsn", src])
        want = f"devices=2: more than the {torch.cuda.device_count()} visible card"
        check(rc == 1 and want in out and not os.path.exists(f"{src}.two.rsn"),
              f"raisin -devices=2 on {torch.cuda.device_count()} card(s): exit {rc}, {out!r}")
    mb = len(data) / 1e6
    enc, dec = sorted(mb / t for t in t_enc), sorted(mb / t for t in t_dec)
    print(f"phase mesh: compress_container(..., mesh=data_mesh()) over {mesh.shape} equal to phase 3's default "
          f"container and round trip exact {TIMED_RUNS} times; encode MB/s median {np.median(enc):.3f} (min "
          f"{enc[0]:.3f}, max {enc[-1]:.3f}), decode MB/s median {np.median(dec):.3f} (min {dec[0]:.3f}, max "
          f"{dec[-1]:.3f}), beside phase 3's {lz_rates['encode']:.3f} and {lz_rates['decode']:.3f}; launches of the "
          f"first run {launches}; devices=auto through compress_file and raisin -container wrote the same bytes; "
          f"raisin -devices=2 exited 1: {out.strip()!r}; card {card}", flush=True)


def step_rank(rank: int, world: int, init: str, path: str, per_card: bool) -> None:
    """One rank of the sharded step at model_axis=2: with ``per_card`` on card ``rank`` under NCCL,
    else on cuda:0 under gloo; runs the step on its 'data' shard of the blocks at ``path`` and
    writes its outputs and its kernels' launches beside them."""
    import torch

    from raisin_tpu_torch.ops import arithmetic_rows, lzss_commit, lzss_match
    from raisin_tpu_torch.parallel import multihost
    from raisin_tpu_torch.parallel.lzss_sharded import sharded_pipeline_step

    # several ranks on one card take gloo: NCCL refuses two ranks on one GPU
    dev = multihost.initialize(init, world, rank, backend=None if per_card else "gloo",
                               device=f"cuda:{rank}" if per_card else "cuda:0")
    try:
        mesh = multihost.global_data_mesh(model_axis=2)
        check(mesh.shape == {"data": world // 2, "model": 2}, f"the {world}-rank mesh is {mesh}")
        z = np.load(path)
        rows = len(z["lengths"]) // mesh.shape["data"]
        mine = slice(rank // 2 * rows, (rank // 2 + 1) * rows)
        x, n = torch.from_numpy(z["x"][mine]).to(dev), torch.from_numpy(z["lengths"][mine]).to(dev)
        step = sharded_pipeline_step(mesh, x.shape[1], WINDOW)
        wrappers = (lzss_match.find_matches, lzss_commit.commit_tokens, arithmetic_rows.encode_events)
        for fn in wrappers:
            fn.launches = 0
        lzss_match.find_matches.chain_tiles = lzss_match.find_matches.sweep_tiles = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, tok_len, bits, bit_len = step(x, n)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        np.savez(f"{path}.rank{rank}.npz", tok=tok.cpu().numpy(), tok_len=tok_len.cpu().numpy(),
                 bits=bits.cpu().numpy(), bit_len=bit_len.cpu().numpy())
        print(json.dumps({"rank": rank, "device": str(dev), "backend": torch.distributed.get_backend(),
                          "seconds": seconds, "launches": [fn.launches for fn in wrappers],
                          "tiles": match_tiles()}), flush=True)
    finally:
        torch.distributed.destroy_process_group()


def sharded_step_ranks(xe, en, world: int, per_card: bool, tmp: str) -> tuple[list[dict], float]:
    """Run ``world`` ranks of :func:`step_rank` on the escaped blocks (xe, en); each rank's outputs must
    equal the one-process step's rows of its shard and lzss_tokens + encode_blocks'. -> (reports, seconds)."""
    import os

    import torch
    import torch.nn.functional as F

    from raisin_tpu_torch.entry import rendezvous, run_ranks
    from raisin_tpu_torch.ops import arithmetic_scan, pipeline
    from raisin_tpu_torch.parallel import data_mesh
    from raisin_tpu_torch.parallel.lzss_sharded import sharded_pipeline_step

    path = os.path.join(tmp, f"step{world}.npz")
    np.savez(path, x=xe.cpu().numpy(), lengths=en.cpu().numpy())
    t0 = time.perf_counter()
    with rendezvous() as url:
        logs = run_ranks(lambda r: [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--step-rank", str(r),
                                    str(world), url, path] + (["--per-card"] if per_card else []), world,
                         timeout=RANK_TIMEOUT)
    seconds = time.perf_counter() - t0
    reports = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    S = xe.shape[1]
    one = sharded_pipeline_step(data_mesh(1), S, WINDOW)(xe, en)
    tok, tok_len = pipeline.lzss_tokens(xe, en, WINDOW)
    j = torch.arange(S + 8, dtype=torch.int32, device=xe.device)
    syms = torch.where(j[None, :] < tok_len[:, None], F.pad(tok, (0, 8)).to(torch.int32), arithmetic_scan.EOF)
    ref = (tok, tok_len, *arithmetic_scan.encode_blocks(syms.to(torch.int32), tok_len))
    rows = xe.shape[0] // (world // 2)
    for want, what in ((one, "the step at model_axis=1"), (ref, "lzss_tokens + encode_blocks")):
        want = [t.cpu().numpy() for t in want]
        for r in range(world):
            g = np.load(f"{path}.rank{r}.npz")
            mine = slice(r // 2 * rows, (r // 2 + 1) * rows)
            check(all(np.array_equal(g[k], w[mine]) for k, w in zip(("tok", "tok_len", "bits", "bit_len"), want)),
                  f"rank {r} of {world}'s step at model_axis=2 differs from {what}")
    for rep in reports:
        check(all(k > 0 for k in rep["launches"]), f"a rank of the step did not launch D, E and I: {rep}")
    return reports, seconds


def phase_two_ranks(data: bytes, card: str, dev) -> dict:
    """Two processes on the one card: the container over their block ranges and the sharded step at
    model_axis=2, each against the one-process result; then a world-of-1 NCCL group's all_reduce."""
    import os
    import tempfile

    import torch

    from raisin_tpu_torch.entry import rendezvous, run_ranks
    from raisin_tpu_torch.ops import escape, lzss_match
    from raisin_tpu_torch.parallel import blocks, multihost
    from raisin_tpu_torch.parallel.multihost_worker import load_segments

    part = data[:TWO_RANK_BYTES]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.bin")
        with open(src, "wb") as f:
            f.write(part)
        t0 = time.perf_counter()
        with rendezvous() as url:
            run_ranks(lambda r: [sys.executable, "-m", "raisin_tpu_torch.parallel.multihost_worker", src, tmp,
                                 "--rank", str(r), "--world", "2", "--coordinator", url, "--device", "cuda:0",
                                 "--backend", "gloo", "--block-size", str(BLOCK_SIZE), "--window", str(WINDOW)], 2,
                      timeout=RANK_TIMEOUT)
        out["container_s"] = time.perf_counter() - t0
        records, payloads, aux = load_segments(tmp, 2)
        check(records[0]["sum"] == records[1]["sum"] == [10.0, 12.0, 14.0, 16.0],
              f"the all_reduce(SUM) over two ranks gave {records[0]['sum']}, {records[1]['sum']}")
        ranges = [r["range"] for r in records]
        nblocks = records[0]["nblocks"]
        check(ranges[0][0] == 0 and ranges[0][1] == ranges[1][0] and ranges[1][1] == nblocks,
              f"the ranks' block ranges {ranges} do not cover {nblocks} blocks in order")
        joined = blocks.assemble_container(payloads, [aux], LZ, BLOCK_SIZE, WINDOW, len(part))
        single = blocks.compress_container(part, LZ, BLOCK_SIZE, window=WINDOW, device=dev)
        check(joined == single, "the two ranks' rank-order container differs from the one-process container")

        m, n = padded([part[i * STEP_S : (i + 1) * STEP_S] for i in range(STEP_B)])
        xe, en = escape.escape_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
        reports, out["step_s"] = sharded_step_ranks(xe, en, 2, False, tmp)

        # a world-of-1 NCCL group on the card: its all_reduce(MAX) of the step's L and D
        multihost.initialize("file://" + os.path.join(tmp, "nccl-store"), 1, 0, device=dev)
        try:
            check(torch.distributed.get_backend() == "nccl", "the one-card group is not NCCL")
            L = lzss_match.find_matches(xe, en, WINDOW)[0]
            red = L.clone()
            torch.distributed.all_reduce(red, torch.distributed.ReduceOp.MAX)
            torch.cuda.synchronize()
            check(torch.equal(red, L), "NCCL's all_reduce(MAX) over one rank changed L")
        finally:
            torch.distributed.destroy_process_group()
    out.update(ranks=[{k: rep[k] for k in ("seconds", "launches", "tiles")} for rep in reports],
               container_bytes=len(part), step_shape=list(xe.shape))
    print(f"phase two ranks (gloo, both on cuda:0): the rank-order container of {len(part)} B in {nblocks} blocks "
          f"(ranges {ranges}) equals the one-process container, all_reduce(SUM) gave {records[0]['sum']}, "
          f"{out['container_s']:.1f} s with the processes' start; the step at model_axis=2 on {STEP_B} blocks of "
          f"{STEP_S} B (escaped {list(xe.shape)}) equals the step at model_axis=1 and lzss_tokens + encode_blocks, "
          f"{out['step_s']:.1f} s with the start; per rank (step seconds, launches of D, E, I, D's tiles by path) "
          f"{out['ranks']}; a world-of-1 NCCL group's all_reduce(MAX) ran on the card; card {card}", flush=True)
    return out


def phase_cards(data: bytes, card: str) -> dict:
    """Every card of the machine (``--cards``, two or more): the default container over data_mesh(k) for
    k = 1, 2 and every card, in turns, each equal to the one-card bytes, with its MB/s; the worker module
    on every card under torchrun (env://, NCCL, cuda:LOCAL_RANK), whose rank-order container must equal
    them; the sharded step at model_axis=2 on every card under NCCL against the one-process step; and
    ``dryrun_multichip`` on every card, a card a rank under NCCL."""
    import os
    import tempfile

    import torch

    from raisin_tpu_torch import entry
    from raisin_tpu_torch.ops import escape
    from raisin_tpu_torch.parallel import blocks, data_mesh
    from raisin_tpu_torch.parallel.multihost_worker import load_segments

    cards = torch.cuda.device_count()
    check(cards >= 2 and cards % 2 == 0, f"--cards needs an even number of cards, not {cards}")
    mb = len(data) / 1e6
    sizes = sorted({1, 2, cards})
    rates, ref = {k: {"encode": [], "decode": []} for k in sizes}, None
    for k in sizes * 2:  # in turns: 1, 2, every card, then again
        mesh = data_mesh(k)
        for rep in range(TIMED_RUNS + 1):  # the first round trip warms the cards up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = blocks.compress_container(data, LZ, BLOCK_SIZE, mesh=mesh, window=WINDOW)
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = blocks.decompress_container(c, mesh=mesh)
            t_dec = time.perf_counter() - t0
            ref = ref or c
            check(c == ref and back == data, f"the container over {mesh.shape} differs or did not round-trip")
            if rep:
                rates[k]["encode"].append(mb / t_enc)
                rates[k]["decode"].append(mb / t_dec)
    out = {"mesh": {k: {d: {"median": float(np.median(v)), "min": min(v), "max": max(v)} for d, v in r.items()}
                    for k, r in rates.items()}}
    for k in (1, cards):  # one traced round trip: host ms per range (summed over the threads), device ms by kernel
        mesh = data_mesh(k)
        out[f"trace {k}"] = trace_breakdown(
            lambda: check(blocks.decompress_container(blocks.compress_container(
                data, LZ, BLOCK_SIZE, mesh=mesh, window=WINDOW), mesh=mesh) == data, "traced round trip differs"),
            "rsnb.", ("rsnb.compress", "rsnb.decompress"))
        print(f"phase cards, trace over {k} card(s): {json.dumps(out[f'trace {k}'])}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.bin")
        with open(src, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(cards),
                              "--standalone", "-m", "raisin_tpu_torch.parallel.multihost_worker",
                              src, tmp, "--block-size", str(BLOCK_SIZE), "--window", str(WINDOW)],
                             capture_output=True, text=True, timeout=RANK_TIMEOUT,
                             env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
        out["torchrun_s"] = time.perf_counter() - t0
        check(run.returncode == 0, f"torchrun of {cards} workers exited {run.returncode}:\n{run.stderr[-3000:]}")
        records, payloads, aux = load_segments(tmp, cards)
        out["workers"] = [{"range": r["range"], "device": r["device"]} for r in records]
        check(sorted(r["device"] for r in records) == [f"cuda:{i}" for i in range(cards)],
              f"the workers' devices: {out['workers']}")
        total = [sum(10 * r + i for r in range(cards)) for i in range(4)]
        check(all(r["sum"] == total for r in records), f"all_reduce(SUM) over {cards} ranks: {records[0]['sum']}")
        joined = blocks.assemble_container(payloads, [aux], LZ, BLOCK_SIZE, WINDOW, len(data))
        check(joined == ref, f"the {cards} NCCL ranks' rank-order container differs from one card's")

        m, n = padded([data[i * STEP_S : (i + 1) * STEP_S] for i in range(STEP_B * cards)])
        xe, en = escape.escape_blocks(torch.from_numpy(m).to("cuda:0"), torch.from_numpy(n).to("cuda:0"))
        reports, out["step_s"] = sharded_step_ranks(xe, en, cards, True, tmp)
        out["step_ranks"] = reports
    t0 = time.perf_counter()
    entry.dryrun_multichip(cards)  # a card a rank, NCCL
    out["dryrun_s"] = time.perf_counter() - t0
    print(f"phase cards ({cards} x {card}): the container over data_mesh(k) equals one card's, MB/s "
          f"{json.dumps(out['mesh'])}; {cards} workers under torchrun (NCCL) wrote it in rank order "
          f"({out['torchrun_s']:.1f} s with the start); the step at model_axis=2 on {STEP_B * cards} blocks over "
          f"{cards} NCCL ranks equals the one-process step ({out['step_s']:.1f} s with the start): "
          f"{json.dumps(reports)}; dryrun_multichip({cards}) on a card a rank (NCCL) in {out['dryrun_s']:.1f} s "
          f"with the start", flush=True)
    return out


def phase_entry(card: str, dev) -> None:
    """entry()'s forward on the card against its plain version, then dryrun_multichip(2) on the card."""
    import torch

    from raisin_tpu_torch import entry
    from raisin_tpu_torch.ops import arithmetic_rows, lzss_commit, lzss_match

    wrappers = (lzss_match.find_matches, lzss_commit.commit_tokens, arithmetic_rows.encode_events)
    forward, (x, n) = entry.entry(dev)
    before = [fn.launches for fn in wrappers]
    bits, bit_len = forward(x, n)
    torch.cuda.synchronize()
    launched = [fn.launches - b for fn, b in zip(wrappers, before)]
    check(launched == [1, 1, 1], f"entry()'s forward launched D, E, I {launched} times")
    plain_forward, (xc, nc) = entry.entry("cpu")
    bits_p, bit_len_p = plain_forward(xc, nc)
    err = max_abs_err((bits.cpu(), bits_p), (bit_len.cpu(), bit_len_p))
    check(err == 0, f"entry()'s forward on the card differs from its plain version (err {err})")
    t0 = time.perf_counter()
    entry.dryrun_multichip(2, backend="gloo", device=f"cuda:{dev.index or 0}")
    print(f"phase entry: entry()'s forward on {tuple(x.shape)} launched D, E, I once each and equals its plain "
          f"version (max_abs_err 0, bit lengths {bit_len.tolist()}); dryrun_multichip(2) on the card (gloo) in "
          f"{time.perf_counter() - t0:.1f} s with the processes' start; card {card}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--step-rank"]:  # one rank of sharded_step_ranks, started by it
        step_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6:] == ["--per-card"])
        return 0

    import bench
    from raisin_tpu_torch.ops import _build, huffman_blocks, huffman_rows, lzss_commit, lzss_decode, lzss_match
    from raisin_tpu_torch.ops import arithmetic_rows as ar
    from raisin_tpu_torch.ops.device import require_cuda
    from raisin_tpu_torch.parallel import blocks

    arith = {"arith_encode": ar.encode_bits, "arith_prepad": ar.prepad_rows, "arith_decode": ar.decode_rows}
    events = {"arith_events": ar.encode_events}
    lz = {"lzss_match": lzss_match.find_matches, "lzss_commit": lzss_commit.commit_tokens,
          "lzss_decode": lzss_decode.walk_tokens}
    huff = {"huffman_encode": huffman_rows.encode_rows, "huffman_decode": huffman_rows.decode_rows}
    wide = {"huffman_encode_wide": huffman_rows.encode_rows_wide, "huffman_decode_wide": huffman_rows.decode_rows_wide}
    every = {**arith, **lz, **huff, **events, **wide}

    def reset():
        for fn in every.values():
            fn.launches = 0
        if match_tiles() is not None:
            lzss_match.find_matches.chain_tiles = lzss_match.find_matches.sweep_tiles = 0

    # phase 1: the card, and the kernels built from this checkout
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"phase build: {so.relative_to(_build.BUILD_DIR.parent.parent)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    if sys.argv[1:] == ["--match"]:  # kernel D alone on its four inputs, no plain version
        match = time_match(bench.make_corpus(MAIN_BYTES), dev, plain=False)
        print(json.dumps({"card": smi, "window": WINDOW, "lzss_match": match}))
        return 0
    if sys.argv[1:] == ["--encode"]:  # kernel A alone on its four inputs, no plain version
        encode = time_encode(bench.make_corpus(MAIN_BYTES), dev)
        print(json.dumps({"card": smi, "arith_encode": encode}))
        return 0
    if sys.argv[1:] == ["--decode"]:  # kernel C alone on its four inputs, no plain version
        decode = time_decode(bench.make_corpus(MAIN_BYTES), dev, plain=False)
        print(json.dumps({"card": smi, "arith_decode": decode}))
        return 0
    if sys.argv[1:] == ["--events"]:  # kernel I alone on its five inputs, no plain version
        events = time_events(bench.make_corpus(MAIN_BYTES), dev)
        print(json.dumps({"card": smi, "arith_events": events}))
        return 0
    if sys.argv[1:] == ["--hdecode"]:  # kernel H alone on its five inputs, no plain version
        hdecode = time_hdecode(bench.make_corpus(MAIN_BYTES), dev)
        print(json.dumps({"card": smi, "huffman_decode": hdecode}))
        return 0
    if sys.argv[1:] == ["--hencode"]:  # kernel G alone on its six inputs, no plain version
        hencode = time_hencode(bench.make_corpus(MAIN_BYTES), dev, plain=False)
        print(json.dumps({"card": smi, "huffman_encode": hencode}))
        return 0
    if sys.argv[1:] == ["--prepad"]:  # kernel B alone on its four inputs, no plain version
        prepad = time_prepad(bench.make_corpus(MAIN_BYTES), dev, plain=False)
        print(json.dumps({"card": smi, "arith_prepad": prepad}))
        return 0
    if sys.argv[1:] == ["--commit"]:  # kernel E alone on its seven inputs, no plain version
        commit = time_commit(bench.make_corpus(MAIN_BYTES), dev)
        print(json.dumps({"card": smi, "window": WINDOW, "lzss_commit": commit}))
        return 0
    if sys.argv[1:] == ["--walk"]:  # kernel F alone on its five inputs, no plain version
        walk = time_walk(bench.make_corpus(MAIN_BYTES), dev)
        print(json.dumps({"card": smi, "window": WINDOW, "lzss_decode": walk}))
        return 0
    if sys.argv[1:] == ["--runes"]:  # the runes phase alone: wide G and H, the rune streams
        launches_runes, wide_results = phase_runes(every, reset, card, dev)
        print(json.dumps({"card": smi, "launches": launches_runes, **wide_results}))
        return 0
    if sys.argv[1:] == ["--ci"]:  # the ci phase alone: the port's CI benchmark page on the card
        phase_ci(every, reset, card, dev)
        return 0
    if sys.argv[1:] == ["--cards"]:  # every card of the machine: the mesh, NCCL ranks, the step, the dry run
        phase_cards(bench.make_corpus(MAIN_BYTES), smi)
        return 0
    if sys.argv[1:] == ["--cli"]:  # the cli phase alone, after phase 3's default container
        data = bench.make_corpus(MAIN_BYTES)
        c = blocks.compress_container(data, LZ, block_size=BLOCK_SIZE, window=WINDOW, device=dev)
        phase_wide_window(data, dev)
        phase_cli(data, c, every, reset, card, dev)
        return 0
    if sys.argv[1:] == ["--paths"]:  # phase 3 alone: the main paths and the streams, no traces
        data = bench.make_corpus(MAIN_BYTES)
        for algorithms, wrappers in ((("arithmetic",), arith), (LZ, {**arith, **lz}), (LZ_HUFF, {**lz, **huff}),
                                     (("huffman",), huff), (("lzss",), lz)):
            phase_main(data, algorithms, wrappers, reset, card, dev)
        phase_stream(data[:STREAM_BYTES], every, reset, card, dev, trace=False)
        return 0

    # phase 2: each kernel against its plain version on edge cases
    phase_kernels_vs_plain(ar, dev)
    phase_lzss_vs_plain(dev)
    phase_match_ranges(dev)
    phase_huffman_vs_plain(dev)

    # phase 3: the main paths through the entry points a user calls
    data = bench.make_corpus(MAIN_BYTES)
    launches_arith, c, _, _ = phase_main(data, ("arithmetic",), arith, reset, card, dev)
    _, _, _, payloads, _, _ = blocks.parse_container(c)
    check_oracle_blocks(data, payloads)
    traces = {"arithmetic": trace_container(data, dev, ("arithmetic",))}
    launches, lz_container, tiles, lz_rates = phase_main(data, LZ, {**arith, **lz}, reset, card, dev)
    _, _, _, lz_payloads, aux, _ = blocks.parse_container(lz_container)
    check_oracle_blocks_lzss(data, lz_payloads, aux[0])
    traces["lzss,arithmetic"] = trace_container(data, dev, LZ)
    huffman_blocks.reset_host_split()
    launches_huff, c, _, _ = phase_main(data, LZ_HUFF, {**lz, **huff}, reset, card, dev)
    split = dict(huffman_blocks.host_split)
    check(split == {"encode": 0, "decode": 0}, f"lzss,huffman blocks took the host split: {split}")
    _, _, _, lh_payloads, lh_aux, _ = blocks.parse_container(c)
    check_oracle_blocks_huff(data, lh_payloads, lh_aux[0])
    print(f"phase oracle blocks: arithmetic {sorted(ORACLE_BLOCKS)}, lzss,arithmetic {sorted(ORACLE_BLOCKS_LZSS)} "
          f"and lzss,huffman {sorted(ORACLE_BLOCKS_HUFF)} equal to the host oracle's payloads; "
          f"lzss,huffman blocks on the host split: {split}", flush=True)
    traces["lzss,huffman"] = trace_container(data, dev, LZ_HUFF)
    for name, trace in traces.items():
        if not trace["device_ms"]:
            print(f"phase trace {name}: the profiler recorded no device activity; device times not measured",
                  flush=True)
        print(f"phase trace {name} (ms, one compress + decompress under torch.profiler): "
              + json.dumps(trace), flush=True)
    phase_main(data, ("huffman",), huff, reset, card, dev)
    phase_main(data, ("lzss",), lz, reset, card, dev)
    phase_wide_window(data, dev)
    launches_stream = phase_stream(data[:STREAM_BYTES], every, reset, card, dev)
    launches_runes, wide_results = phase_runes(every, reset, card, dev)
    phase_cli(data, lz_container, every, reset, card, dev)
    phase_ci(every, reset, card, dev)
    phase_mesh(data, lz_container, lz_rates, {**arith, **lz}, reset, card, dev)
    phase_two_ranks(data, card, dev)
    phase_entry(card, dev)

    # phase 4: kernels at the main paths' shapes, beside their plain versions
    passes = events_passes(data, dev)
    results = phase_timing_arith(ar, data, payloads, dev)
    results.update(phase_timing_lzss(data, aux[0], dev))
    results.update(phase_timing_huffman(data, lh_aux[0], dev))
    results["huffman_decode"].update(phase_timing_hdecode(data, dev))
    hencode = time_hencode(data, dev, plain=True)
    results["huffman_encode"]["stream"] = {k: hencode["huffman stream"][k] for k in
                                           ("ms", "ms_with_read", "device_kernels_ms", "plain_ms", "max_abs_err",
                                            "bound_ms", "bound_by")}
    results["huffman_encode"]["inputs"] = hencode
    results["arith_prepad"]["inputs"] = time_prepad(data, dev, plain=True)
    results.update(phase_timing_events(ar, data[:STREAM_BYTES], dev))
    results["arith_events"]["device_kernels_ms"] = passes
    results.update(wide_results)
    for name, r in results.items():
        check(r["max_abs_err"] == 0, f"{name} differs from its plain version at the main path's shapes (err {r['max_abs_err']})")
        print(f"phase timing {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.1f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']}", flush=True)

    check("jax" not in sys.modules, "jax was imported")
    check("raisin_tpu" not in sys.modules, "the JAX package was imported")

    # launches: A-F from the default lzss,arithmetic main path's first run, G and H from lzss,huffman's,
    # I from the lzss,arithmetic stream's
    launches.update({name: launches_huff[name] for name in huff})
    launches["arith_events"] = launches_stream[",".join(LZ)]["arith_events"]
    launches.update({name: launches_runes[name] for name in WIDE_KERNELS})  # the runes phase's main path
    table = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": KERNELS[name][0],
                "replaces": KERNELS[name][1],
                "launches": launches[name],
                **results[name],
                **({"tiles": tiles} if name == "lzss_match" else {}),  # the main path's, by path
                "library_ms": None,  # no single PyTorch call computes any of these functions
            }
            for name in KERNELS
        ]
    }
    print(f"launches on the arithmetic main path's first run: {launches_arith}; "
          f"on the lzss,huffman main path's first run: {launches_huff}; "
          f"on the streams' first runs: {launches_stream}", flush=True)
    print(smi)  # as nvidia-smi gives it: name, power limit
    print(json.dumps(table))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
