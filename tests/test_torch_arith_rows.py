"""The port's arithmetic rows against the JAX package and the host oracle.

``raisin_tpu_torch.ops.arithmetic_rows`` on CPU tensors runs the plain
PyTorch versions of the three CUDA kernels (encode, prepad, decode); here
they are held against ``raisin_tpu.ops.arithmetic_pallas`` run in Pallas
interpret mode, as tests/test_ops_pallas.py runs it, and against
``raisin_tpu.formats.arithmetic_ref``. Outputs are bytes, so every
comparison is exact (tolerance 0). Inputs come from seeded numpy.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raisin_tpu.bitkit.packing import pack_prepad_sentinel
from raisin_tpu.formats import arithmetic_ref
from raisin_tpu.ops import arithmetic_pallas as ap
from raisin_tpu_torch.ops import _build
from raisin_tpu_torch.ops import arithmetic_rows as ar
from raisin_tpu_torch.ops import pipeline
from raisin_tpu_torch.ops.device import require_cuda, resolve_device
from tests.test_ops_pallas import _payload_matrix

torch.set_num_threads(1)


def _blocks(S: int, count: int, seed: int = 11) -> list[bytes]:
    """_payload_matrix(S), then seeded blocks of mixed content below S."""
    rng = np.random.default_rng(seed)
    out = _payload_matrix(S)
    while len(out) < count:
        n = int(rng.integers(0, S))
        kind = len(out) % 3
        if kind == 0:
            out.append(bytes(rng.integers(0, 256, size=n, dtype=np.uint8)))
        elif kind == 1:
            out.append(bytes(rng.integers(97, 100, size=n, dtype=np.uint8)))
        else:
            out.append(bytes(rng.choice(np.frombuffer(b"the cat sat on a mat, ", np.uint8), size=n)))
    return out


def _symbols(blocks: list[bytes], S: int):
    symbols = np.full((len(blocks), S), ap.EOF, dtype=np.int32)
    lengths = np.zeros(len(blocks), dtype=np.int32)
    for i, p in enumerate(blocks):
        symbols[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        lengths[i] = len(p)
    return symbols, lengths


def _payload_rows(payloads: list[bytes], capb: int):
    prows = np.zeros((len(payloads), capb), dtype=np.uint8)
    for i, p in enumerate(payloads):
        prows[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    return prows, np.array([len(p) for p in payloads], dtype=np.int32)


def test_encode_rows_plain_matches_pallas_interpret():
    S, B = 512, 128
    blocks = _blocks(S, B)
    symbols, lengths = _symbols(blocks, S)
    rows_j, bl_j, of_j = ap.encode_rows(symbols, lengths, capw=1024, interpret=True)
    rows_j, bl_j, of_j = np.asarray(rows_j), np.asarray(bl_j), np.asarray(of_j)
    rows_t, bl_t, of_t = ar.encode_rows(torch.from_numpy(symbols), torch.from_numpy(lengths))
    rows_t, bl_t = rows_t.numpy(), bl_t.numpy()
    assert not of_t.any()
    assert np.array_equal(bl_t, bl_j)
    for i, p in enumerate(blocks):
        got = rows_t[i, : bl_t[i]].tobytes()
        if not of_j[i]:
            assert got == rows_j[i].tobytes()[: bl_j[i]], f"block {i} differs from Pallas"
        assert got == arithmetic_ref.compress(p), f"block {i} differs from the oracle"


def test_decode_rows_plain_matches_pallas_interpret():
    blocks = [p for p in _blocks(512, 128) if len(p) <= 472]
    blocks.append(b"decode me " * 40)
    enc = [arithmetic_ref.compress(p) for p in blocks]
    capb = (max(len(e) for e in enc) + 511) // 512 * 512
    B = 128
    blocks += [b""] * (B - len(blocks))
    enc += [arithmetic_ref.compress(b"")] * (B - len(enc))
    prows, blens = _payload_rows(enc, capb)
    olens = np.array([len(p) for p in blocks], dtype=np.int32)
    steps = 512
    syms_j, eof_j = ap.decode_rows(
        jnp.asarray(prows), jnp.asarray(blens), jnp.asarray(olens), num_steps=steps, interpret=True
    )
    syms_j, eof_j = np.asarray(syms_j), np.asarray(eof_j)
    syms_t, eof_t = ar.decode_rows(
        torch.from_numpy(prows), torch.from_numpy(blens), torch.from_numpy(olens), steps
    )
    syms_t, eof_t = syms_t.numpy(), eof_t.numpy()
    assert np.array_equal(eof_t, eof_j)
    assert eof_t.all()
    for i, p in enumerate(blocks):
        assert syms_t[i, : len(p)].tobytes() == syms_j[i, : len(p)].tobytes() == p, f"block {i}"


KINDS = ["random", "text", "runs", "zeros", "escape", "two_symbols"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_round_trip_oracle_exact(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    n = 1000
    data = {
        "random": lambda: bytes(rng.integers(0, 256, size=n, dtype=np.uint8)),
        "text": lambda: bytes(rng.choice(np.frombuffer(b"etaoin shrdlu ", np.uint8), size=n)),
        "runs": lambda: b"".join(bytes([int(c)]) * int(r) for c, r in zip(
            rng.integers(0, 256, 40), rng.integers(1, 50, 40)))[:n],
        "zeros": lambda: b"\x00" * n,
        "escape": lambda: (b"<<\\\xff,>" * n)[:n],
        "two_symbols": lambda: bytes(rng.integers(0, 2, size=n, dtype=np.uint8)),
    }[kind]()
    blocks = [data, data[: n // 3], b""]
    S = n + 1
    symbols, lengths = _symbols(blocks, S)
    rows, bl, of = ar.encode_rows(torch.from_numpy(symbols), torch.from_numpy(lengths))
    assert not of.any()
    payloads = [rows[i, : bl[i]].numpy().tobytes() for i in range(len(blocks))]
    assert payloads == [arithmetic_ref.compress(b) for b in blocks]
    prows, blens = _payload_rows(payloads, max(map(len, payloads)) + 1)
    syms, eof = ar.decode_rows(
        torch.from_numpy(prows), torch.from_numpy(blens), torch.from_numpy(lengths), S
    )
    assert eof.tolist() == [1, 1, 1]
    for i, b in enumerate(blocks):
        assert syms[i, : len(b)].numpy().tobytes() == b
        assert not syms[i, len(b) :].any()  # steps from EOF on stay 0


@pytest.mark.parametrize("nbits, pad", [(0, 8), (3, 5), (8, 8), (16, 8), (31, 1), (37, 3)])
def test_prepad_sentinel_and_byte_lens(nbits, pad):
    rng = np.random.default_rng(nbits)
    bits = rng.integers(0, 2, size=nbits, dtype=np.uint8)
    capw = 4
    padded = np.zeros(32 * capw, dtype=np.uint8)
    padded[:nbits] = bits
    raw = np.packbits(padded).view(">u4").astype(np.int64)
    raw = torch.from_numpy(np.where(raw >= 2**31, raw - 2**32, raw)).to(torch.int32)[None]
    rows, byte_lens = ar.prepad_rows(raw, torch.tensor([nbits], dtype=torch.int32))
    want = pack_prepad_sentinel(bits)
    assert int(byte_lens[0]) == len(want) == (nbits + pad) // 8
    assert rows[0, : len(want)].numpy().tobytes() == want
    assert not rows[0, len(want) :].any()


def test_row_bound_and_overflow_flag():
    rng = np.random.default_rng(5)
    blocks = [bytes(rng.integers(0, 256, size=600, dtype=np.uint8)), b"", b"\x07" * 600]
    symbols, lengths = _symbols(blocks, 601)
    raw, bits, oflow = ar.encode_bits(torch.from_numpy(symbols), torch.from_numpy(lengths), 64)
    # 600 random bytes take ~8 bits each: past 64 words; the others fit
    assert oflow.tolist() == [1, 0, 0]
    assert int(bits[0]) <= ar.BITS_PER_STEP * 601
    # the first 64 words are the stream's first 2048 bits all the same
    full, full_bits, full_of = ar.encode_bits(
        torch.from_numpy(symbols), torch.from_numpy(lengths), ar.capw_bound(601)
    )
    assert not full_of.any()
    assert torch.equal(full[:, :64], raw) and torch.equal(full_bits, bits)


def test_cpu_wrappers_launch_no_kernel():
    ar.reset_launch_counts()
    symbols, lengths = _symbols([b"abc", b""], 8)
    rows, bl, _ = ar.encode_rows(torch.from_numpy(symbols), torch.from_numpy(lengths))
    ar.decode_rows(rows, bl, torch.from_numpy(lengths), 8)
    ar.encode_events(torch.from_numpy(symbols), torch.from_numpy(lengths))
    assert len(ar.KERNEL_WRAPPERS) == 4  # kernels A, B, C and I
    assert [f.launches for f in ar.KERNEL_WRAPPERS] == [0, 0, 0, 0]


@pytest.mark.parametrize("bad", [-1, 257])
def test_encode_rows_rejects_symbols_out_of_range(bad):
    symbols, lengths = _symbols([b"ab"], 4)
    symbols[0, 1] = bad
    with pytest.raises(ValueError, match="symbols"):
        ar.encode_rows(torch.from_numpy(symbols), torch.from_numpy(lengths))


def test_pipeline_puts_eof_at_and_past_length():
    payload = torch.tensor([[1, 2, 3, 0], [9, 0, 0, 0]], dtype=torch.uint8)
    lengths = torch.tensor([3, 1], dtype=torch.int32)
    sym = pipeline.arith_symbols(payload, lengths)
    assert sym.dtype == torch.int32
    assert sym.tolist() == [[1, 2, 3, 256], [9, 256, 256, 256]]


def test_library_name_follows_flags_and_compiler(monkeypatch):
    name = _build.library_name("nvcc 12.8")
    assert name == _build.library_name("nvcc 12.8")
    assert name != _build.library_name("nvcc 12.9")
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-G"])
    assert name != _build.library_name("nvcc 12.8")


def test_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert require_cuda().type == "cuda"
    else:
        # None means the card: without one it raises instead of taking the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            require_cuda()
