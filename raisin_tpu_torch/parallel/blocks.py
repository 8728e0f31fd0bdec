"""RSNB block container on PyTorch: the port of raisin_tpu/parallel/blocks.py.

The port covers two pipelines: the default ``("lzss", "arithmetic")`` and the
pure ``("arithmetic",)``, encode and decode. Each block is an exact
single-stream `.rsn` payload of its pipeline, and an lzss,arithmetic
container carries the aux table of per-block token-stream lengths, so
every container this module writes at an LZSS window up to 8191 is
byte-identical to the JAX package's, and each package reads the other's.
(Above 8191 the JAX package encodes on the host and writes no aux table;
the port writes one at any window up to 65535, with the same payloads.)

The JAX package's TPU limits do not carry over: there is no 128-lane block
padding, no VMEM batch cap, no 64 KiB payload or escaped-block gate and no
native-C fallback; the batch size comes from the card's free memory (all
1024 blocks of a 64 MiB input at 64 KiB blocks fit one launch on an 80 GB
card).

The host handles the input and the payloads as whole buffers, never as one
Python object per block: the card reads the input and the container's
body straight from the Python bytes, cuts and pads the blocks itself, and
the container or the decoded output comes back in one copy.

Each stage runs inside a ``torch.profiler.record_function`` range
(``rsnb.compress`` / ``rsnb.decompress`` around a whole call,
``rsnb.enc.*`` / ``rsnb.dec.*`` per stage), so a profiler trace of the
entry points gives the time breakdown; outside a profiler a range costs a
few microseconds.

Layout (little-endian), as in the JAX package:
  magic "RSNB" | version u8 | algo_len u8 | algo CSV | block_size u32 |
  window u32 (v2+) | orig_size u64 | num_blocks u32 | num_aux u8 |
  num_blocks x u32 payload sizes |
  num_aux x (num_blocks x u32) auxiliary per-block lengths |
  concatenated payloads
"""

from __future__ import annotations

import struct
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from raisin_tpu_torch.ops import arithmetic_rows, escape, lzss_decode, lzss_match, pipeline
from raisin_tpu_torch.ops.device import resolve_device

MAGIC = b"RSNB"
VERSION = 2  # v2 adds the LZSS window u32 (v1 files parse as window=4096)
DEFAULT_BLOCK_SIZE = 1 << 16

# Device bytes per block and coder step of one batch: encode holds the
# uint8 input and its padded copies, the int32 cast and symbols, the raw
# words and the rows (<= 2 bytes a step each); decode holds the body, the
# payload rows, the decoded bytes, a mask over each and the selection. A
# batch takes at most a quarter of the card's free memory.
CUDA_ENC_BYTES_PER_STEP = 3 + 4 + 4 + 2 + 2
CUDA_DEC_BYTES_PER_STEP = 6
# The same per input byte for lzss,arithmetic, where escaping can double a
# block: encode holds the input and its padded copy (2), the escaped bytes
# (2) and the escape's offsets (24, escape-heavy input only), L and D (16),
# the tokens (2), their coder symbols (8) and raw words and rows (8);
# decode holds the body and payload rows (2), the tokens (2), the walked
# rows (2) and the escape decode's index arrays and masks (32).
CUDA_LZ_ENC_BYTES_PER_STEP = 2 + 2 + 24 + 16 + 2 + 8 + 8
CUDA_LZ_DEC_BYTES_PER_STEP = 2 + 2 + 2 + 32
CUDA_MEMORY_SHARE = 4
# The plain CPU versions keep a bit matrix and a run array per block
# (about 16 + 64 bytes a step for encode, 8 * 8 * 3 for decode); their
# batches stay under 1 GiB.
CPU_BATCH_BYTES = 1 << 30
CPU_BYTES_PER_STEP = 200

_ROADMAP_NEXT = {
    ("lzss",): "ROADMAP Queue 1 item 10 (LZSS-only container)",
    ("huffman",): "ROADMAP Queue 1 item 11 (Huffman containers)",
    ("lzss", "huffman"): "ROADMAP Queue 1 item 11 (Huffman containers)",
}


def _not_ported(algorithms: tuple[str, ...]) -> NotImplementedError:
    item = _ROADMAP_NEXT.get(algorithms, "ROADMAP Queue 1 item 14 (the rest: host pipelines)")
    return NotImplementedError(
        f"raisin_tpu_torch runs the ('lzss', 'arithmetic') and ('arithmetic',) containers so far; "
        f"{algorithms!r} comes with {item}"
    )


def _batch_blocks(device: torch.device, cuda_bytes_per_step: int, steps: int) -> int:
    """Blocks per launch, from free device memory (CUDA) or a fixed budget."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(1, free // CUDA_MEMORY_SHARE // (cuda_bytes_per_step * steps + 64))
    return max(1, CPU_BATCH_BYTES // (CPU_BYTES_PER_STEP * steps + 64))


def _block_lengths(n: int, block_size: int) -> tuple[int, np.ndarray]:
    """-> (W, lengths): the longest block and each block's length (int32).

    The empty input is one empty block, as in the JAX package (``or [b""]``).
    """
    B = max(1, -(-n // block_size))
    W = min(block_size, n)
    lengths = np.full(B, W, dtype=np.int32)
    lengths[-1] = n - (B - 1) * W
    return W, lengths


def _h2d(buf, device: torch.device) -> torch.Tensor:
    """A bytes-like object -> uint8 tensor on ``device``, read and never written."""
    if len(buf) == 0:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # frombuffer warns that bytes are read-only
        return torch.frombuffer(buf, dtype=torch.uint8).to(device)


def _d2h(t: torch.Tensor) -> bytes:
    """uint8 tensor -> bytes; from the card through pinned host memory."""
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    return t.numpy().tobytes()


def _rows_payloads(rows: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The first ``lens[b]`` bytes of every row, concatenated in row order."""
    need = max(0, min(int(lens.max()), rows.shape[1]))
    cols = torch.arange(need, device=rows.device)
    return rows[:, :need][cols[None, :] < lens[:, None]]


def _payload_rows(flat: torch.Tensor, lens: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`_rows_payloads`: (B, width) rows, zero past each length."""
    rows = torch.zeros((lens.shape[0], width), dtype=torch.uint8, device=flat.device)
    cols = torch.arange(width, device=flat.device)
    rows[cols[None, :] < lens[:, None]] = flat
    return rows


def _encode_rows(
    data: bytes, block_size: int, device: torch.device, window: int | None = None
) -> tuple[np.ndarray, torch.Tensor, np.ndarray | None]:
    """Encode every block -> (payload sizes, concatenated payloads on ``device``, token lengths).

    ``window=None`` is the ``("arithmetic",)`` pipeline (token lengths
    None); a window is ``("lzss", "arithmetic")`` (the counterpart of the
    JAX package's ``_encode_lzss_arith_rows`` and ``_enc_batch_assemble``),
    whose token-stream lengths become the container's aux table.
    """
    W, lengths = _block_lengths(len(data), block_size)
    B = len(lengths)
    per_step = CUDA_ENC_BYTES_PER_STEP if window is None else CUDA_LZ_ENC_BYTES_PER_STEP
    maxb = _batch_blocks(device, per_step, W + 1)
    view = memoryview(data)
    sizes, bodies, toks = [], [], []
    for lo in range(0, B, maxb):
        hi = min(lo + maxb, B)
        with record_function("rsnb.enc.h2d"):
            x = _h2d(view[lo * W : hi * W], device)
            # zeros past the ragged end
            x = F.pad(x, (0, (hi - lo) * W - x.numel())).view(hi - lo, W)
            n = torch.from_numpy(lengths[lo:hi]).to(device)
        if window is None:
            with record_function("rsnb.enc.coder"):
                # one column more for EOF after a full block
                rows, byte_lens, oflow = pipeline.arith_encode_rows(F.pad(x, (0, 1)), n)
        else:
            with record_function("rsnb.enc.escape"):
                x, n = escape.escape_blocks(x, n)
            rows, byte_lens, tok_len, oflow = pipeline.lzss_arith_encode_rows(x, n, window)
        with record_function("rsnb.enc.select"):
            body = _rows_payloads(rows, byte_lens)
            got = byte_lens.cpu().numpy()
            if window is not None:
                toks.append(tok_len.cpu().numpy())
            flagged = _flagged_blocks(oflow.cpu().numpy(), lo, device)
        if flagged.size:
            # CPU only: the oracle re-encodes a flagged block, as the JAX
            # package does (blocks.py:372-381, 577-581)
            from raisin_tpu.formats import arithmetic_ref, lzss_ref

            payloads = _split(_d2h(body), got)
            for i in flagged:
                start = (lo + i) * W
                block = data[start : start + lengths[lo + i]]
                payloads[i] = arithmetic_ref.compress(
                    block if window is None else lzss_ref.compress(block, window)
                )
            got = np.array([len(p) for p in payloads], dtype=np.int64)
            body = _h2d(b"".join(payloads), device)
        sizes.append(got)
        bodies.append(body)
    return np.concatenate(sizes), torch.cat(bodies), np.concatenate(toks) if toks else None


def _flagged_blocks(oflow: np.ndarray, first_block: int, device: torch.device) -> np.ndarray:
    """Indices of the blocks whose stream overflowed its row.

    Rows are sized by :func:`arithmetic_rows.capw_bound`, which every stream
    fits, so a flag from the card means kernel A is wrong: that raises
    rather than moving the block's work to the host.
    """
    flagged = np.nonzero(oflow)[0]
    if flagged.size and device.type == "cuda":
        raise RuntimeError(
            f"kernel A flagged block {first_block + flagged[0]} over the row bound, which every stream fits"
        )
    return flagged


def _decode_rows(
    body: memoryview, sizes: np.ndarray, out_lens: np.ndarray, device: torch.device,
    tok_lens: np.ndarray | None = None,
) -> bytes:
    """Decode concatenated payloads of known decoded lengths.

    ``tok_lens=None`` is the ``("arithmetic",)`` pipeline. With the aux
    table's token lengths it is ``("lzss", "arithmetic")`` (the JAX
    package's ``_decode_lzss_arith_rows``, ``_dec_stage`` and ``_dec_tail``):
    kernel C decodes each block's token stream, kernel F walks it into the
    escaped plaintext, rows of ``2 * max(out_lens)`` bytes (escaping at most
    doubles a block), and the escape decode runs on the whole batch.
    """
    B = len(sizes)
    coded = out_lens if tok_lens is None else tok_lens  # what the coder decodes
    steps = int(coded.max()) + 1  # payload + EOF
    capb = int(sizes.max()) + 1  # room for the decoder tail byte
    if tok_lens is None:
        maxb = _batch_blocks(device, CUDA_DEC_BYTES_PER_STEP, max(steps, capb))
    else:
        cap_out = 2 * int(out_lens.max())
        maxb = _batch_blocks(device, CUDA_LZ_DEC_BYTES_PER_STEP, max(steps, capb, cap_out))
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    out = []
    for lo in range(0, B, maxb):
        hi = min(lo + maxb, B)
        with record_function("rsnb.dec.h2d"):
            flat = _h2d(body[offsets[lo] : offsets[hi]], device)
            blens = torch.from_numpy(sizes[lo:hi].astype(np.int32)).to(device)
            clens = torch.from_numpy(coded[lo:hi].astype(np.int32)).to(device)
            prows = _payload_rows(flat, blens, capb)
        with record_function("rsnb.dec.coder"):
            syms, eof = arithmetic_rows.decode_rows(prows, blens, clens, steps)
        with record_function("rsnb.dec.eof_check"):
            missing = np.nonzero(eof.cpu().numpy() == 0)[0]
        if missing.size:
            raise ValueError(f"container: block {lo + missing[0]} missing EOF symbol")
        if tok_lens is None:
            with record_function("rsnb.dec.d2h"):
                out.append(_d2h(_rows_payloads(syms, clens)))
            continue
        with record_function("rsnb.dec.walk"):
            rows, esc_lens = lzss_decode.decode_tokens(syms, clens, cap_out, lo)
        with record_function("rsnb.dec.unescape"):
            plain, dec_lens = escape.unescape_rows(rows, esc_lens)
            dec_lens = dec_lens.cpu().numpy()
            wrong = np.nonzero(dec_lens != out_lens[lo:hi])[0]
        if wrong.size:
            i = wrong[0]
            raise ValueError(
                f"container: block {lo + i} decoded {dec_lens[i]} bytes, expected {out_lens[lo + i]}"
            )
        with record_function("rsnb.dec.d2h"):
            out.append(_d2h(plain))
    return b"".join(out)


# ---------------------------------------------------------------------------
# Container


def compress_container(
    data: bytes,
    algorithms: list[str] | tuple[str, ...] = ("lzss", "arithmetic"),
    block_size: int = DEFAULT_BLOCK_SIZE,
    window: int = 4096,
    device: torch.device | str | None = None,
) -> bytes:
    """Block-parallel encode into the RSNB container.

    Same arguments as raisin_tpu.parallel.blocks.compress_container, plus
    ``device`` (:func:`resolve_device`). ``("lzss", "arithmetic")`` (the
    default) and ``("arithmetic",)`` are ported; other pipelines raise
    NotImplementedError naming the ROADMAP item that brings them. The LZSS
    window must lie in 1..65535 (ValueError otherwise); the arithmetic
    pipeline records ``window`` in the header as the JAX package does.
    """
    algorithms = tuple(algorithms)
    if algorithms not in (("lzss", "arithmetic"), ("arithmetic",)):
        raise _not_ported(algorithms)
    if block_size <= 0:
        raise ValueError("block_size must be positive")
    lzss = algorithms == ("lzss", "arithmetic")
    if lzss:
        lzss_match.check_window(window)
    dev = resolve_device(device)
    with record_function("rsnb.compress"):
        sizes, body, toks = _encode_rows(data, block_size, dev, window if lzss else None)
        with record_function("rsnb.enc.d2h"):
            aux = [toks] if lzss else []
            head = _header(sizes, aux, algorithms, block_size, window, len(data))
            # framed on the device: the container comes back in one copy
            return _d2h(torch.cat([_h2d(head, dev), body]))


def _header(sizes, aux, algorithms, block_size: int, window: int, orig_size: int) -> bytes:
    """Everything of the container before the payloads."""
    algo_str = ",".join(algorithms).encode("ascii")
    head = MAGIC + struct.pack(
        "<BB", VERSION, len(algo_str)
    ) + algo_str + struct.pack("<IIQIB", block_size, window, orig_size, len(sizes), len(aux))
    return b"".join([head, *(np.asarray(t, dtype="<u4").tobytes() for t in (sizes, *aux))])


def assemble_container(
    payloads: list[bytes],
    aux: list[list[int]],
    algorithms: tuple[str, ...],
    block_size: int,
    window: int,
    orig_size: int,
) -> bytes:
    """Frame already-encoded per-block payloads as an RSNB container."""
    head = _header([len(p) for p in payloads], aux, algorithms, block_size, window, orig_size)
    return b"".join([head, *payloads])


def _parse_header(data: bytes):
    """-> (algorithms, block_size, orig_size, sizes, aux, window, body offset)."""
    if data[:4] != MAGIC:
        raise ValueError("not an RSNB container")
    version, algo_len = struct.unpack_from("<BB", data, 4)
    if version not in (1, VERSION):
        raise ValueError(f"unsupported RSNB version {version}")
    pos = 6
    algorithms = tuple(data[pos : pos + algo_len].decode("ascii").split(","))
    pos += algo_len
    if version == 1:
        block_size, orig_size, num_blocks, num_aux = struct.unpack_from("<IQIB", data, pos)
        window = 4096
        pos += 17
    else:
        block_size, window, orig_size, num_blocks, num_aux = struct.unpack_from(
            "<IIQIB", data, pos
        )
        pos += 21
    sizes = struct.unpack_from(f"<{num_blocks}I", data, pos)
    pos += 4 * num_blocks
    aux = []
    for _ in range(num_aux):
        aux.append(list(struct.unpack_from(f"<{num_blocks}I", data, pos)))
        pos += 4 * num_blocks
    return algorithms, block_size, orig_size, sizes, aux, window, pos


def _split(body: bytes, sizes, pos: int = 0) -> list[bytes]:
    payloads = []
    for s in sizes:
        payloads.append(body[pos : pos + s])
        pos += s
    return payloads


def parse_container(data: bytes):
    """-> (algorithms, block_size, orig_size, payloads, aux, window)."""
    algorithms, block_size, orig_size, sizes, aux, window, pos = _parse_header(data)
    return algorithms, block_size, orig_size, _split(data, sizes, pos), aux, window


def decompress_container(data: bytes, device: torch.device | str | None = None) -> bytes:
    """Block-parallel decode of an RSNB container (``("lzss", "arithmetic")`` or ``("arithmetic",)``)."""
    with record_function("rsnb.decompress"):
        return _decompress_container(data, resolve_device(device))


def _decompress_container(data: bytes, device: torch.device) -> bytes:
    algorithms, block_size, orig_size, sizes, aux, window, pos = _parse_header(data)
    if orig_size == 0:
        return b""
    if algorithms not in (("lzss", "arithmetic"), ("arithmetic",)):
        raise _not_ported(algorithms)
    tok_lens = None
    if algorithms == ("lzss", "arithmetic"):
        if not aux:
            # neither package writes one at windows up to 8191
            raise NotImplementedError(
                "an ('lzss', 'arithmetic') container without its aux table of token lengths "
                "comes with ROADMAP Queue 1 item 17 (aux-less lzss,arithmetic containers)"
            )
        tok_lens = np.array(aux[0], dtype=np.int64)
    sizes = np.array(sizes, dtype=np.int64)
    out_lens = np.minimum(block_size, orig_size - block_size * np.arange(len(sizes), dtype=np.int64))
    body = memoryview(data)[pos : pos + int(sizes.sum())]
    if len(body) != sizes.sum():
        raise ValueError("container: payloads run past the end of the data")
    out = _decode_rows(body, sizes, out_lens, device, tok_lens)
    if len(out) != orig_size:
        raise ValueError(f"container: decoded {len(out)} bytes, expected {orig_size}")
    return out
