#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raisin_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --match    # kernel D alone: build, then time_match without the plain version
    python3 chip_smoke.py --decode   # kernel C alone: build, then time_decode without the plain version
    python3 chip_smoke.py --paths    # phase 3 alone: the main paths and the streams, without traces

Phases, each printing one line; any failure exits nonzero before the
result line:

1. require a CUDA card, print its name and power limit (nvidia-smi), build
   the kernels from raisin_tpu_torch/csrc into raisin_tpu_torch/_build
   (one nvcc per source, all started together);
2. each kernel against its plain PyTorch version on the card, exactly, on
   128 edge-case blocks of <= 2 KiB: A encode, B prepad, C decode (also,
   against the plain version on the host, at row pitches of every residue
   mod 4, on garbage rows and on a block that freezes the model), I event
   records, and, at
   windows 16 and 4096, D match search, E commit and F token walk; D, E
   and F also on 24 KiB run-heavy blocks at window 16384 (five-digit
   tokens) and on blocks whose escaped bytes outgrow shared memory, at
   windows 4096 and 16384 (D's device-memory sweep); G
   Huffman encode and H Huffman decode on the ASCII edge blocks, a block
   whose longest code has 21 bits, a single-symbol block and kernel E's
   token streams at windows 16 and 4096, while the non-ASCII edge blocks
   take the host split, are counted and equal the port's copy of the
   oracle;
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
   way, without the trace. Then the stream path: the engine's
   ``compress_bytes(data, algorithms, backend="device")`` on the first
   STREAM_BYTES of the corpus for ``lzss,arithmetic``, ``arithmetic``,
   ``huffman`` and ``lzss`` (one block each, so each kernel runs on one
   SM), whose arithmetic outputs must equal the host oracle's
   (ORACLE_STREAM); kernel A must not launch there; MB/s over TIMED_RUNS
   compress calls, one round trip of each through ``decompress_bytes``
   (raw streams decode on the host, as in the JAX package), one through
   ``compress_file``/``decompress_file`` in raw and container mode, and one
   traced ``lzss,arithmetic`` compress;
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
   PEAK_INT_OPS_PER_S). Kernel C runs on four inputs (``DECODE_INPUTS``):
   the corpus's rows in the arithmetic and the lzss,arithmetic containers
   (held against the plain version), and MAIN_BYTES of random bytes and of
   zero bytes through kernels A + B; on each it must give back the input. Kernel I, whose main path is the
   stream, is timed at the stream's shape, and at the
   arithmetic container's shape beside kernel A, where its records,
   expanded and packed, must equal kernels A + B on every block. Kernel D
   runs on four inputs (``MATCH_INPUTS``): the corpus at the container's
   shape, the stream's shape, and MAIN_BYTES of zero bytes and of random
   bytes in 64 KiB blocks, each held exactly against its plain version; its
   tile counters must show the chain path on the corpus, the stream and
   the random bytes, and the sweep path on the zeros.

``--match`` runs phase 1 and then only kernel D on its four inputs, with a
digest of its output per input and no plain version; ``--decode`` does the
same for kernel C on its four inputs; ``--paths`` runs phase 1 and then
phase 3 without its traces. Copied into another checkout of the
repository (an earlier commit, say), the script measures that tree's code
the same way, so two trees compare on one card; equal digests mean equal
outputs.

The second-to-last line is the kernel table as JSON, the last line the
result object. Nothing of JAX is imported.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import time

import numpy as np

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

    from raisin_tpu_torch.ops import huffman_blocks as hb
    from raisin_tpu_torch.ops import huffman_rows as hr

    dev = x.device
    counts = hb.count_symbols(x, n)
    codes, code_lens, _, on_host = hb.code_tables(counts)
    check(not on_host.any(), f"a {tag} block is not ASCII")
    want = ((counts[:, : hr.NSYM] * code_lens).sum(1) + 7) // 8
    capw = max(1, (int(want.max()) + 3) // 4)
    codes_t = torch.from_numpy(codes.view(np.int32)).to(dev)
    lens_t = torch.from_numpy(code_lens).to(dev)
    rows_k, bl_k, pad_k = hr.encode_rows(x, n, codes_t, lens_t, capw)
    rows_p, bl_p, pad_p = hr._encode_rows_torch(x, n, codes_t, lens_t, capw)
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

    from raisin_tpu_torch.formats import huffman as hf
    from raisin_tpu_torch.ops import escape, huffman_blocks, lzss_commit, lzss_match

    edge = [b for b in edge_blocks() if b]
    ascii_blocks = [b for b in edge if max(b) < 0x80]
    fib = fibonacci_block()
    longest = max(len(c) for c in hf.print_codes(hf.build_tree({s: fib.count(s) for s in set(fib)}))[1])
    check(longest >= 20, f"the Fibonacci block's longest code has {longest} bits")
    blocks = ascii_blocks + [fib, b"s" * 1000]
    m, n = padded(blocks)
    x, n = torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev)
    huffman_stages(x, n, "edge blocks")
    print(f"phase kernels G (huffman encode), H (huffman decode) vs plain: equal on {len(ascii_blocks)} ASCII "
          f"edge blocks, a block with a {longest}-bit code and a single-symbol block, H restores them, "
          f"max_abs_err 0", flush=True)

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
    kernel D's tiles by path in the first run, or None without kernel D).
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
    return launches, c, tiles


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
            f"exact in {t_dec:.2f} s (its launches {({k: fn.launches for k, fn in wrappers.items() if fn.launches})}, "
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


def _result(err: int, ms: float, plain: float, nbytes: float, ops: float) -> dict:
    bound_ms, bound_by = bound(nbytes, ops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by}


def _coder_ops(steps: float, bits: float, num_cum: int) -> float:
    """Least integer operations of an adaptive arithmetic coder: per step a
    search and an update of a cumulative-frequency (Fenwick) tree of
    ``num_cum`` entries, ceil(log2) operations each, and ~6 of coder
    arithmetic (range, two multiply-divides, the new low); one a stream bit."""
    return (2 * int(np.ceil(np.log2(num_cum))) + 6) * steps + bits


def phase_timing_arith(ar, data: bytes, payloads: list[bytes], dev) -> dict:
    """Phase 4, arithmetic: kernels A, B, C at the main path's shapes beside their plain versions
    (A's and C's on the first PLAIN_BLOCKS blocks); C also on the other DECODE_INPUTS."""
    import torch

    symbols, lengths = batch(*padded([data[i : i + BLOCK_SIZE] for i in range(0, len(data), BLOCK_SIZE)]), dev)
    capw = ar.capw_bound(symbols.shape[1])
    B = symbols.shape[0]
    coded = float((lengths.to(torch.int64) + 1).sum())  # coder steps, EOF included
    results = {}

    ms_a = cuda_ms(lambda: ar.encode_bits(symbols, lengths, capw), 3)
    raw_k, bits_k, of_k = ar.encode_bits(symbols, lengths, capw)
    check(int(of_k.max()) == 0, "kernel A flagged an overflow at the main path's shapes")
    # the plain version on the first PLAIN_BLOCKS blocks at full step length, as CPU tensors
    p = slice(0, PLAIN_BLOCKS)
    sym_p, len_p = symbols[p].cpu(), lengths[p].cpu()
    (raw_p, bits_p, of_p), plain_a = plain_ms(lambda: ar._encode_bits_torch(sym_p, len_p, capw))
    stream = float(((bits_k.to(torch.int64) + 7) // 8).sum())
    # symbols in, bits out
    err = max_abs_err((raw_k[p].cpu(), raw_p), (bits_k[p].cpu(), bits_p), (of_k[p].cpu(), of_p))
    results["arith_encode"] = _result(err, ms_a, plain_a, 4 * coded + stream + 12 * B,
                                      _coder_ops(coded, 8 * stream, ar.NUM_CUM))
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


# kernel C's timing inputs, each as the container hands it to C: the corpus's rows in the arithmetic
# container and its token rows in the lzss,arithmetic one (window WINDOW), and MAIN_BYTES of seeded
# random bytes and of zero bytes in BLOCK_SIZE blocks through the arithmetic container's coder
DECODE_INPUTS = ("arithmetic", "lzss,arithmetic", "random", "zeros")
DECODE_MAIN = ("arithmetic", "lzss,arithmetic")  # the main paths' shapes, held against the plain version
# blocks of each batch that the plain versions of kernels A and C run on, at full step length, as CPU tensors
PLAIN_BLOCKS = 64


def decode_input(name: str, data: bytes, dev):
    """One of DECODE_INPUTS, coded by kernels A + B (and D + E before them for lzss,arithmetic).

    Returns (payload rows at the container's pitch, the longest payload + 1
    bytes; byte lengths; coded lengths; steps; the (B, steps) uint8 symbols
    that kernel C must give back, 0 from each block's EOF on).
    """
    import torch
    import torch.nn.functional as F

    from raisin_tpu_torch.ops import escape, pipeline
    from raisin_tpu_torch.parallel import blocks

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
    rows, blens, oflow = pipeline.arith_encode_rows(payload, n)
    check(not oflow.any(), f"kernel A flagged an overflow on {name}")
    prows = blocks._payload_rows(blocks._rows_payloads(rows, blens), blens, int(blens.max()) + 1)
    want = torch.where(torch.arange(steps, device=dev)[None, :] < n[:, None], payload, 0)
    return prows, blens, n, steps, want


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
    import torch

    from raisin_tpu_torch.ops import arithmetic_scan

    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(torch.int32)
    symbols = torch.cat([x, torch.tensor([ar.EOF], dtype=torch.int32)])[None].contiguous()
    lengths = torch.tensor([len(data)], dtype=torch.int32)
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

    ms_e = cuda_ms(lambda: lzss_commit.commit_tokens(xe, L_k, D_k, en), 3)
    tok_k, tl_k = lzss_commit.commit_tokens(xe, L_k, D_k, en)
    (tok_p, tl_p), plain_e = plain_ms(lambda: lzss_commit._commit_tokens_torch(xe, L_k, D_k, en))
    toks = float(tl_k.to(torch.int64).sum())
    results["lzss_commit"] = _result(max_abs_err((tok_k, tok_p), (tl_k, tl_p)), ms_e, plain_e,
                                     9 * esc + toks, 4 * esc)
    check(tl_k.cpu().tolist() == list(tok_lens), "kernel E's token lengths differ from the main path's aux table")
    del L_k, D_k, tok_p

    steps = int(tl_k.max()) + 1
    tok = torch.nn.functional.pad(tok_k[:, : steps - 1], (0, 1)).contiguous()
    cap_out = 2 * BLOCK_SIZE
    ms_f = cuda_ms(lambda: lzss_decode.walk_tokens(tok, tl_k, cap_out), 3)
    rows_k, ol_k, fl_k = lzss_decode.walk_tokens(tok, tl_k, cap_out)
    (rows_p, ol_p, fl_p), plain_f = plain_ms(lambda: lzss_decode._walk_tokens_torch(tok, tl_k, cap_out))
    results["lzss_decode"] = _result(max_abs_err((rows_k, rows_p), (ol_k, ol_p), (fl_k, fl_p)), ms_f, plain_f,
                                     toks + esc, 2 * toks)
    check(torch.equal(rows_k[:, : xe.shape[1]], xe) and torch.equal(ol_k, en), "kernel F did not restore the main path's blocks")
    return results


def phase_timing_huffman(data: bytes, tok_lens: list[int], dev) -> dict:
    """Phase 4, Huffman: kernels G, H at the lzss,huffman main path's shapes beside their plain versions.

    The inputs are the main path's: kernel E's token streams of the corpus
    at window 4096 and the code tables the container builds for them.
    """
    import torch

    from raisin_tpu_torch.ops import escape, huffman_blocks, huffman_rows, lzss_commit, lzss_match

    m, n = padded([data[i : i + BLOCK_SIZE] for i in range(0, len(data), BLOCK_SIZE)])
    xe, en = escape.escape_blocks(torch.from_numpy(m).to(dev), torch.from_numpy(n).to(dev))
    L, D = lzss_match.find_matches(xe, en, WINDOW)
    tok, tl = lzss_commit.commit_tokens(xe, L, D, en)
    del L, D
    check(tl.cpu().tolist() == list(tok_lens), "kernel E's token lengths differ from the lzss,huffman aux table")
    counts = huffman_blocks.count_symbols(tok, tl)
    codes, code_lens, _, on_host = huffman_blocks.code_tables(counts)
    check(not on_host.any(), "a main-path token stream is not ASCII")
    want = ((counts[:, : huffman_rows.NSYM] * code_lens).sum(1) + 7) // 8
    capw = max(1, (int(want.max()) + 3) // 4)
    codes_t = torch.from_numpy(codes.view(np.int32)).to(dev)
    lens_t = torch.from_numpy(code_lens).to(dev)
    B = tok.shape[0]
    toks = float(tl.to(torch.int64).sum())
    payload = float(want.sum())
    results = {}

    ms_g = cuda_ms(lambda: huffman_rows.encode_rows(tok, tl, codes_t, lens_t, capw), 5)
    rows_k, bl_k, pad_k = huffman_rows.encode_rows(tok, tl, codes_t, lens_t, capw)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

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
    every = {**arith, **lz, **huff, **events}

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
    if sys.argv[1:] == ["--decode"]:  # kernel C alone on its four inputs, no plain version
        decode = time_decode(bench.make_corpus(MAIN_BYTES), dev, plain=False)
        print(json.dumps({"card": smi, "arith_decode": decode}))
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
    phase_huffman_vs_plain(dev)

    # phase 3: the main paths through the entry points a user calls
    data = bench.make_corpus(MAIN_BYTES)
    launches_arith, c, _ = phase_main(data, ("arithmetic",), arith, reset, card, dev)
    _, _, _, payloads, _, _ = blocks.parse_container(c)
    check_oracle_blocks(data, payloads)
    traces = {"arithmetic": trace_container(data, dev, ("arithmetic",))}
    launches, c, tiles = phase_main(data, LZ, {**arith, **lz}, reset, card, dev)
    _, _, _, lz_payloads, aux, _ = blocks.parse_container(c)
    check_oracle_blocks_lzss(data, lz_payloads, aux[0])
    traces["lzss,arithmetic"] = trace_container(data, dev, LZ)
    huffman_blocks.reset_host_split()
    launches_huff, c, _ = phase_main(data, LZ_HUFF, {**lz, **huff}, reset, card, dev)
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
    launches_stream = phase_stream(data[:STREAM_BYTES], every, reset, card, dev)

    # phase 4: kernels at the main paths' shapes, beside their plain versions
    results = phase_timing_arith(ar, data, payloads, dev)
    results.update(phase_timing_lzss(data, aux[0], dev))
    results.update(phase_timing_huffman(data, lh_aux[0], dev))
    results.update(phase_timing_events(ar, data[:STREAM_BYTES], dev))
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
