#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raisin_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one line; any failure exits nonzero before the
result line:

1. require a CUDA card, print its name and power limit (nvidia-smi), build
   the kernels from raisin_tpu_torch/csrc into raisin_tpu_torch/_build;
2. each kernel (A encode, B prepad, C decode) against its plain PyTorch
   version on the card, exactly, on 128 edge-case blocks of <= 2 KiB;
3. the main path: ``compress_container(data, ("arithmetic",), 65536)`` and
   ``decompress_container`` of a 64 MiB corpus (bench.make_corpus) with the
   launch counts reset just before and read just after; the round trip must
   be exact, every kernel must have launched and four sampled payloads must
   equal the host oracle's (ORACLE_BLOCKS); timed over TIMED_RUNS round
   trips; then one more round trip under torch.profiler for the time
   breakdown (host ms per stage range, device ms per kernel and copy, and
   the device's busy share of each call);
4. each kernel at the main path's shapes, timed with CUDA events, beside
   its plain version at the same shapes, outputs compared exactly (this
   also holds every block of the main path against the plain version,
   which the CPU tests hold against the host oracle).

The second-to-last line is the kernel table as JSON, the last line the
result object. Nothing of JAX is imported.
"""

from __future__ import annotations

import hashlib
import json
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


def trace_breakdown(data: bytes, dev) -> dict:
    """Where one compress + decompress through the entry points spends its time.

    Runs both under torch.profiler and reads the trace: host milliseconds
    of each ``rsnb.*`` range that raisin_tpu_torch.parallel.blocks opens,
    device milliseconds by kernel or copy, and the share of each call's
    wall time in which the card ran anything. ``device`` is empty when the
    trace holds no device activity.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raisin_tpu_torch.parallel import blocks

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c = blocks.compress_container(data, ("arithmetic",), block_size=BLOCK_SIZE, device=dev)
        back = blocks.decompress_container(c, device=dev)
        torch.cuda.synchronize()
    check(back == data, "traced round trip differs")
    events = prof.events()
    host: dict[str, float] = {}
    calls = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("rsnb."):
            host[e.name] = host.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            if e.name in ("rsnb.compress", "rsnb.decompress"):
                calls[e.name] = (e.time_range.start, e.time_range.end)
    spans = [(_device_group(e.name), e.time_range.start, e.time_range.end)
             for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device: dict[str, float] = {}
    for name, s, e in spans:
        device[name] = device.get(name, 0.0) + (e - s) / 1e3
    busy = {}
    if spans:
        for call, (lo, hi) in calls.items():
            inside = [(max(s, lo), min(e, hi)) for _, s, e in spans if e > lo and s < hi]
            busy[call] = _union_ms(inside) / ((hi - lo) / 1e3)
    return {"host_ms": host, "device_ms": device, "device_busy_share": busy}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    import bench
    from raisin_tpu_torch.ops import _build
    from raisin_tpu_torch.ops import arithmetic_rows as ar
    from raisin_tpu_torch.ops.device import require_cuda
    from raisin_tpu_torch.parallel import blocks

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

    # phase 2: each kernel against its plain version on edge cases
    phase_kernels_vs_plain(ar, dev)

    # phase 3: the main path through the entry points a user calls
    data = bench.make_corpus(MAIN_BYTES)
    c = blocks.compress_container(data, ("arithmetic",), block_size=BLOCK_SIZE, device="cuda")
    check(blocks.decompress_container(c, device="cuda") == data, "warm-up round trip differs")
    ar.reset_launch_counts()
    torch.cuda.synchronize()
    t_enc, t_dec = [], []
    for rep in range(TIMED_RUNS):
        t0 = time.perf_counter()
        c = blocks.compress_container(data, ("arithmetic",), block_size=BLOCK_SIZE, device="cuda")
        torch.cuda.synchronize()
        t_enc.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = blocks.decompress_container(c, device="cuda")
        torch.cuda.synchronize()
        t_dec.append(time.perf_counter() - t0)
        check(back == data, f"main path round trip {rep} differs")
        if rep == 0:
            launches = {
                "arith_encode": ar.encode_bits.launches,
                "arith_prepad": ar.prepad_rows.launches,
                "arith_decode": ar.decode_rows.launches,
            }
    for name, n in launches.items():
        check(n > 0, f"main path never launched {name}")
    _, _, _, payloads, _, _ = blocks.parse_container(c)
    check_oracle_blocks(data, payloads)
    mb = len(data) / 1e6
    enc_mbs = sorted(mb / t for t in t_enc)
    dec_mbs = sorted(mb / t for t in t_dec)
    print(
        f"phase main path: {len(data)} B in {BLOCK_SIZE} B blocks round trip exact {TIMED_RUNS} times, "
        f"blocks {sorted(ORACLE_BLOCKS)} equal to the oracle; over {TIMED_RUNS} runs "
        f"encode MB/s median {np.median(enc_mbs):.3f} (min {enc_mbs[0]:.3f}, max {enc_mbs[-1]:.3f}), "
        f"decode MB/s median {np.median(dec_mbs):.3f} (min {dec_mbs[0]:.3f}, max {dec_mbs[-1]:.3f}), "
        f"ratio {len(c) / len(data) * 100:.4f}%, launches of the first run {launches}; card {card}",
        flush=True,
    )
    trace = trace_breakdown(data, dev)
    if not trace["device_ms"]:
        print("phase trace: the profiler recorded no device activity; device times not measured", flush=True)
    print("phase trace (ms, one compress + decompress under torch.profiler): "
          + json.dumps(trace), flush=True)

    # phase 4: kernels at the main path's shapes, beside their plain versions
    symbols, lengths = batch(*padded([data[i : i + BLOCK_SIZE] for i in range(0, len(data), BLOCK_SIZE)]), dev)
    capw = ar.capw_bound(symbols.shape[1])
    out_lens = lengths
    steps = symbols.shape[1]
    results = {}

    ms_a = cuda_ms(lambda: ar.encode_bits(symbols, lengths, capw), 3)
    raw_k, bits_k, of_k = ar.encode_bits(symbols, lengths, capw)
    check(int(of_k.max()) == 0, "kernel A flagged an overflow at the main path's shapes")
    t0 = time.perf_counter()
    raw_p, bits_p, of_p = ar._encode_bits_torch(symbols, lengths, capw)
    torch.cuda.synchronize()
    plain_a = (time.perf_counter() - t0) * 1e3
    results["arith_encode"] = (max_abs_err((raw_k, raw_p), (bits_k, bits_p), (of_k, of_p)), ms_a, plain_a)
    del raw_k

    ms_b = cuda_ms(lambda: ar.prepad_rows(raw_p, bits_p), 10)
    rows_k, bl_k = ar.prepad_rows(raw_p, bits_p)
    t0 = time.perf_counter()
    rows_p, bl_p = ar._prepad_torch(raw_p, bits_p)
    torch.cuda.synchronize()
    plain_b = (time.perf_counter() - t0) * 1e3
    results["arith_prepad"] = (max_abs_err((rows_k, rows_p), (bl_k, bl_p)), ms_b, plain_b)
    del raw_p, rows_k

    # the main path's payloads are the plain version's rows, block for block
    bl_np = bl_p.cpu().numpy()
    rows_np = rows_p[:, : int(bl_np.max())].cpu().numpy()
    for i, p in enumerate(payloads):
        check(rows_np[i, : bl_np[i]].tobytes() == p, f"main-path block {i} differs from the plain version")

    blens = torch.tensor([len(p) for p in payloads], dtype=torch.int32, device=dev)
    prows = blocks._payload_rows(torch.from_numpy(np.frombuffer(b"".join(payloads), np.uint8).copy()).to(dev),
                                 blens, int(blens.max()) + 1)
    ms_c = cuda_ms(lambda: ar.decode_rows(prows, blens, out_lens, steps), 3)
    syms_k, eof_k = ar.decode_rows(prows, blens, out_lens, steps)
    t0 = time.perf_counter()
    syms_p, eof_p = ar._decode_rows_torch(prows, blens, out_lens, steps)
    torch.cuda.synchronize()
    plain_c = (time.perf_counter() - t0) * 1e3
    results["arith_decode"] = (max_abs_err((syms_k, syms_p), (eof_k, eof_p)), ms_c, plain_c)

    for name, (err, ms, plain_ms) in results.items():
        check(err == 0, f"{name} differs from its plain version at the main path's shapes (err {err})")
        print(f"phase timing {name}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, max_abs_err {err}", flush=True)

    check("jax" not in sys.modules, "jax was imported")
    check("raisin_tpu" not in sys.modules, "the JAX package was imported")

    table = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": KERNELS[name][0],
                "replaces": KERNELS[name][1],
                "launches": launches[name],
                "max_abs_err": results[name][0],
                "ms": results[name][1],
                "plain_ms": results[name][2],
            }
            for name in KERNELS
        ]
    }
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
