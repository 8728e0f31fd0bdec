"""RSNB block container on PyTorch: the port of raisin_tpu/parallel/blocks.py.

Five pipelines run on the card, encode and decode: the default
``("lzss", "arithmetic")``, ``("arithmetic",)``, ``("lzss",)``,
``("huffman",)`` and ``("lzss", "huffman")``. Each block is an exact
single-stream `.rsn` payload of its pipeline, and the ``lzss,arithmetic``
and ``lzss,huffman`` containers carry the aux table of per-block
token-stream lengths, except ``lzss,arithmetic`` above window 8191, which
carries none, as in the JAX package (it encodes such blocks on the host;
the port stays on the card at any window up to 65535, with the same
payloads). Any other pipeline encodes and decodes block by block through
the engine's ``compress_bytes`` and ``decompress_bytes``, as in the JAX
package. So every container this module writes is byte-identical to the
JAX package's, and each package reads the other's. An ``lzss,arithmetic``
container without an aux table decodes block by block through
``decompress_bytes`` too (the native C runtime under the auto order):
without the token lengths kernel C has no step count.

The JAX package's TPU limits do not carry over: there is no 128-lane block
padding, no VMEM batch cap, no 64 KiB payload or escaped-block gate and no
native-C fallback; the batch size comes from the card's free memory (all
1024 blocks of a 64 MiB input at 64 KiB blocks fit one launch on an 80 GB
card). The LZSS decodes (``lzss``, ``lzss,huffman``) walk their tokens on
the card with kernel F, where the JAX package walks them on the host.

The host handles the input and the payloads as whole buffers, never as one
Python object per block: the card reads the input and the container's
body straight from the Python bytes, cuts and pads the blocks itself, and
the container or the decoded output comes back in one copy. The Huffman
pipelines add per-block host work on small tables only: the tree, the
code table and the header (``ops/huffman_blocks.py``).

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

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from raisin_tpu_torch.ops import arithmetic_rows, escape, huffman_blocks, lzss_decode, lzss_match, pipeline
from raisin_tpu_torch.ops.device import d2h as _d2h
from raisin_tpu_torch.ops.device import h2d as _h2d
from raisin_tpu_torch.ops.device import resolve_device

MAGIC = b"RSNB"
VERSION = 2  # v2 adds the LZSS window u32 (v1 files parse as window=4096)
DEFAULT_BLOCK_SIZE = 1 << 16

ARITH, LZ_ARITH, LZ, HUFF, LZ_HUFF = (
    ("arithmetic",), ("lzss", "arithmetic"), ("lzss",), ("huffman",), ("lzss", "huffman"),
)
PIPELINES = (LZ_ARITH, ARITH, LZ, HUFF, LZ_HUFF)
WITH_AUX = (LZ_ARITH, LZ_HUFF)  # the containers that carry the token lengths
LZ_ARITH_AUX_MAX_WINDOW = 8191  # above it the JAX package writes lzss,arithmetic without them

# Device bytes per block byte of one batch, (encode, decode), by pipeline.
# arithmetic: the uint8 input and its padded copies, the int32 cast and
# symbols, the raw words and the rows (<= 2 bytes a step each); decode the
# body, the payload rows, the decoded bytes, a mask over each and the
# selection. lzss (escaping can double a block): encode holds the input
# and its padded copy (2), the escaped bytes (2) and the escape's offsets
# (24, escape-heavy input only), L and D (16), the tokens (2), their coder
# symbols (8) and raw words and rows (8); decode the body and payload rows
# (2), the tokens (2), the walked rows (2) and the escape decode's index
# arrays and masks (32). huffman: encode the input, the int32 bin keys
# and their masked copy (8), the rows and the framed rows with their mask
# (3); decode the body, the int64 gather index (8), the payload rows, the
# decoded rows and the selection. A batch takes at most a quarter of the
# card's free memory.
CUDA_BYTES_PER_STEP = {
    ARITH: (3 + 4 + 4 + 2 + 2, 6),
    LZ_ARITH: (2 + 2 + 24 + 16 + 2 + 8 + 8, 2 + 2 + 2 + 32),
    LZ: (2 + 2 + 24 + 16 + 2 + 2, 2 + 2 + 2 + 32),
    HUFF: (1 + 8 + 3 + 2, 1 + 8 + 1 + 1 + 2),
    LZ_HUFF: (2 + 2 + 24 + 16 + 2 + 8 + 3 + 2, 1 + 8 + 1 + 2 + 2 + 32),
}
CUDA_MEMORY_SHARE = 4
# The plain CPU versions keep bit matrices and run arrays per block; their
# batches stay under 1 GiB.
CPU_BATCH_BYTES = 1 << 30
CPU_BYTES_PER_STEP = 200


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


def _encode_batch(x, n, algorithms, window: int, first_block: int):
    """Encode one batch of blocks -> (concatenated payloads on the device, sizes, token lengths or None)."""
    if algorithms[0] == "lzss":
        with record_function("rsnb.enc.escape"):
            x, n = escape.escape_blocks(x, n)
    if algorithms == HUFF:
        return (*huffman_blocks.encode_blocks(x, n, first_block), None)
    if algorithms == LZ_HUFF:
        tok, tok_len = pipeline.lzss_tokens(x, n, window)
        return (*huffman_blocks.encode_blocks(tok, tok_len, first_block), tok_len.cpu().numpy().astype(np.int64))
    if algorithms == LZ:
        tok, tok_len = pipeline.lzss_tokens(x, n, window)
        with record_function("rsnb.enc.select"):
            return _rows_payloads(tok, tok_len), tok_len.cpu().numpy(), None
    tok_len = None
    if algorithms == ARITH:
        with record_function("rsnb.enc.coder"):
            # one column more for EOF after a full block
            rows, byte_lens, oflow = pipeline.arith_encode_rows(F.pad(x, (0, 1)), n)
    else:
        rows, byte_lens, tok_len, oflow = pipeline.lzss_arith_encode_rows(x, n, window)
    with record_function("rsnb.enc.select"):
        body = _rows_payloads(rows, byte_lens)
        _check_no_overflow(oflow.cpu().numpy(), first_block)
        return body, byte_lens.cpu().numpy(), None if tok_len is None else tok_len.cpu().numpy()


def _check_no_overflow(oflow: np.ndarray, first_block: int) -> None:
    """Raise if a block's arithmetic stream overflowed its row.

    Rows are sized by :func:`arithmetic_rows.capw_bound`, which every stream
    fits, and the plain versions share the bound, so a flag on any device
    means the coder is wrong: that raises rather than moving the block's
    work to the host.
    """
    flagged = np.nonzero(oflow)[0]
    if flagged.size:
        raise RuntimeError(
            f"the arithmetic coder flagged block {first_block + flagged[0]} over the row bound, "
            f"which every stream fits"
        )


def _encode_rows(
    data: bytes, block_size: int, device: torch.device, algorithms: tuple[str, ...], window: int
) -> tuple[np.ndarray, torch.Tensor, np.ndarray | None]:
    """Encode every block -> (payload sizes, concatenated payloads on ``device``, token lengths).

    The token lengths (None for pipelines without an aux table) become the
    container's aux table.
    """
    W, lengths = _block_lengths(len(data), block_size)
    B = len(lengths)
    maxb = _batch_blocks(device, CUDA_BYTES_PER_STEP[algorithms][0], W + 1)
    view = memoryview(data)
    sizes, bodies, toks = [], [], []
    for lo in range(0, B, maxb):
        hi = min(lo + maxb, B)
        with record_function("rsnb.enc.h2d"):
            x = _h2d(view[lo * W : hi * W], device)
            # zeros past the ragged end
            x = F.pad(x, (0, (hi - lo) * W - x.numel())).view(hi - lo, W)
            n = torch.from_numpy(lengths[lo:hi]).to(device)
        body, got, tok = _encode_batch(x, n, algorithms, window, lo)
        sizes.append(got)
        bodies.append(body)
        if tok is not None:
            toks.append(tok)
    return np.concatenate(sizes), torch.cat(bodies), np.concatenate(toks) if toks else None


def _lzss_tail(tok: torch.Tensor, tok_len: torch.Tensor, out_lens: np.ndarray, first_block: int) -> bytes:
    """Kernel F walks B token streams, then the escape decode; -> the blocks' bytes.

    The walk's rows hold ``2 * max(out_lens)`` bytes (escaping at most
    doubles a block); each block's decoded length must equal ``out_lens``.
    """
    with record_function("rsnb.dec.walk"):
        rows, esc_lens = lzss_decode.decode_tokens(tok, tok_len, 2 * int(out_lens.max()), first_block)
    with record_function("rsnb.dec.unescape"):
        plain, dec_lens = escape.unescape_rows(rows, esc_lens)
        dec_lens = dec_lens.cpu().numpy()
        wrong = np.nonzero(dec_lens != out_lens)[0]
    if wrong.size:
        i = wrong[0]
        raise ValueError(f"container: block {first_block + i} decoded {dec_lens[i]} bytes, expected {out_lens[i]}")
    with record_function("rsnb.dec.d2h"):
        return _d2h(plain)


def _decode_arith(flat, sizes, coded, device, lo: int):
    """Kernel C over one batch -> (decoded symbol rows, their lengths on the device)."""
    steps = int(coded.max()) + 1  # payload + EOF
    blens = torch.from_numpy(sizes.astype(np.int32)).to(device)
    clens = torch.from_numpy(coded.astype(np.int32)).to(device)
    prows = _payload_rows(flat, blens, int(sizes.max()) + 1)  # room for the decoder tail byte
    with record_function("rsnb.dec.coder"):
        syms, eof = arithmetic_rows.decode_rows(prows, blens, clens, steps)
    with record_function("rsnb.dec.eof_check"):
        missing = np.nonzero(eof.cpu().numpy() == 0)[0]
    if missing.size:
        raise ValueError(f"container: block {lo + missing[0]} missing EOF symbol")
    return syms, clens


def _decode_huffman(flat, data, starts, sizes, cap_out: int, lzss: bool, tok_lens, device, lo: int):
    """Kernel H over one batch -> (rows, counts on the device, blocks from the host oracle).

    For lzss,huffman the host blocks' token streams join the card's rows
    (their dict is then empty) and, with an aux table, every block's token
    count must equal its entry.
    """
    rows, counts, host = huffman_blocks.decode_blocks(flat, data, starts, sizes, cap_out, lo)
    if lzss:
        for b, tokens in host.items():
            counts[b] = len(tokens)
            if 0 < len(tokens) <= rows.shape[1]:
                rows[b, : len(tokens)] = torch.frombuffer(bytearray(tokens), dtype=torch.uint8).to(device)
        host = {}
        wrong = np.nonzero(counts != tok_lens)[0] if tok_lens is not None else []
        if len(wrong):
            i = wrong[0]
            raise ValueError(
                f"container: block {lo + i} decoded {counts[i]} token bytes, its aux table says {tok_lens[i]}"
            )
    over = np.nonzero(counts > rows.shape[1])[0]
    if over.size:
        i = over[0]
        raise ValueError(f"container: block {lo + i} decoded {counts[i]} bytes, more than its row holds")
    return rows, torch.from_numpy(counts.astype(np.int32)).to(device), host


def _decode_rows(
    data: bytes, pos: int, algorithms: tuple[str, ...], sizes: np.ndarray, out_lens: np.ndarray,
    device: torch.device, tok_lens: np.ndarray | None,
) -> bytes:
    """Decode the concatenated payloads at ``data[pos:]`` of known decoded lengths.

    ``tok_lens`` is the aux table of the containers that carry one. The
    LZSS pipelines end in kernel F and the escape decode on the whole
    batch, the JAX package's ``_dec_stage`` and ``_dec_tail``.
    """
    B = len(sizes)
    lzss = algorithms[0] == "lzss"
    steps = max(int(sizes.max()) + 1, int(out_lens.max()) * (2 if lzss else 1))
    if tok_lens is not None:
        steps = max(steps, int(tok_lens.max()) + 1)
    maxb = _batch_blocks(device, CUDA_BYTES_PER_STEP[algorithms][1], steps)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    out = []
    for lo in range(0, B, maxb):
        hi = min(lo + maxb, B)
        with record_function("rsnb.dec.h2d"):
            flat = _h2d(memoryview(data)[pos + offsets[lo] : pos + offsets[hi]], device)
        part = slice(lo, hi)
        if algorithms in (ARITH, LZ_ARITH):
            coded = out_lens[part] if tok_lens is None else tok_lens[part]
            tok, tok_len = _decode_arith(flat, sizes[part], coded, device, lo)
            if algorithms == ARITH:
                with record_function("rsnb.dec.d2h"):
                    out.append(_d2h(_rows_payloads(tok, tok_len)))
                continue
        elif algorithms == LZ:
            tok_len = torch.from_numpy(sizes[part].astype(np.int32)).to(device)
            tok = _payload_rows(flat, tok_len, int(sizes[part].max()))
        else:
            # a block's decoded bytes: its length, or its aux entry; escaped
            # tokens without an aux table stay under twice the block
            if tok_lens is not None:
                cap = int(tok_lens[part].max())
            else:
                cap = int(out_lens[part].max()) * (2 if lzss else 1)
            tok, tok_len, host = _decode_huffman(
                flat, data, pos + offsets[lo:hi], sizes[part], cap, lzss,
                None if tok_lens is None else tok_lens[part], device, lo,
            )
            if algorithms == HUFF:
                out.append(_huffman_output(tok, tok_len, host))
                continue
        out.append(_lzss_tail(tok, tok_len, out_lens[part], lo))
    return b"".join(out)


def _huffman_output(rows: torch.Tensor, counts: torch.Tensor, host: dict[int, bytes]) -> bytes:
    """The decoded bytes of a ("huffman",) batch, the host oracle's blocks in their places."""
    with record_function("rsnb.dec.d2h"):
        flat = _d2h(_rows_payloads(rows, counts))
    if not host:
        return flat
    pieces = _split(flat, counts.cpu().tolist())
    for b, decoded in host.items():
        pieces[b] = decoded
    return b"".join(pieces)


# ---------------------------------------------------------------------------
# Container


def compress_container(
    data: bytes,
    algorithms: list[str] | tuple[str, ...] = LZ_ARITH,
    block_size: int = DEFAULT_BLOCK_SIZE,
    window: int = 4096,
    device: torch.device | str | None = None,
) -> bytes:
    """Block-parallel encode into the RSNB container.

    Same arguments as raisin_tpu.parallel.blocks.compress_container, plus
    ``device`` (:func:`resolve_device`). The pipelines of :data:`PIPELINES`
    run on the card (``("lzss", "arithmetic")`` is the default), with the
    LZSS window in 1..65535 (ValueError otherwise); the other pipelines
    record ``window`` in the header as the JAX package does. The Huffman
    pipelines raise the oracle's ValueError on empty input. Any other
    pipeline encodes block by block through the engine's ``compress_bytes``
    (:func:`_encode_per_block`).
    """
    algorithms = tuple(algorithms)
    if block_size <= 0:
        raise ValueError("block_size must be positive")
    dev = resolve_device(device)
    if algorithms not in PIPELINES:
        with record_function("rsnb.compress"):
            return _encode_per_block(data, algorithms, block_size, window, dev)
    if algorithms[0] == "lzss":
        lzss_match.check_window(window)
    with record_function("rsnb.compress"):
        sizes, body, toks = _encode_rows(data, block_size, dev, algorithms, window)
        with record_function("rsnb.enc.d2h"):
            aux = [toks] if _writes_aux(algorithms, window) else []
            head = _header(sizes, aux, algorithms, block_size, window, len(data))
            # framed on the device: the container comes back in one copy
            return _d2h(torch.cat([_h2d(head, dev), body]))


def _encode_per_block(data: bytes, algorithms: tuple[str, ...], block_size: int, window: int,
                      device: torch.device) -> bytes:
    """A pipeline without a device path, block by block through ``compress_bytes`` under the
    preferred backend, as the JAX package encodes it (raisin_tpu/parallel/blocks.py:973-980)."""
    from raisin_tpu_torch.engine.core import compress_bytes

    with record_function("rsnb.enc.host"):
        blocks = [data[i : i + block_size] for i in range(0, len(data), block_size)] or [b""]
        payloads = [compress_bytes(b, algorithms, window=window, device=device) for b in blocks]
    return assemble_container(payloads, [], algorithms, block_size, window, len(data))


def _writes_aux(algorithms: tuple[str, ...], window: int) -> bool:
    """Whether the container carries the aux table of token lengths, as the JAX package decides."""
    return algorithms in WITH_AUX and not (algorithms == LZ_ARITH and window > LZ_ARITH_AUX_MAX_WINDOW)


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
    """Block-parallel decode of an RSNB container; the pipelines of :data:`PIPELINES` on the card."""
    with record_function("rsnb.decompress"):
        return _decompress_container(data, resolve_device(device))


def _decode_per_block(data: bytes, pos: int, sizes, algorithms: tuple[str, ...], device: torch.device) -> bytes:
    """Block by block through ``decompress_bytes`` under the preferred backend, as the JAX package
    decodes a pipeline without a device path and an lzss,arithmetic container without token
    lengths (raisin_tpu/parallel/blocks.py:1084): kernel C needs the step count."""
    from raisin_tpu_torch.engine.core import decompress_bytes

    with record_function("rsnb.dec.host"):
        return b"".join(decompress_bytes(p, algorithms, device=device) for p in _split(data, sizes, pos))


def _decompress_container(data: bytes, device: torch.device) -> bytes:
    algorithms, block_size, orig_size, sizes, aux, window, pos = _parse_header(data)
    if orig_size == 0:
        return b""
    tok_lens = None
    if algorithms in WITH_AUX and aux:
        tok_lens = np.array(aux[0], dtype=np.int64)
    sizes = np.array(sizes, dtype=np.int64)
    if pos + int(sizes.sum()) > len(data):
        raise ValueError("container: payloads run past the end of the data")
    if algorithms not in PIPELINES or (algorithms == LZ_ARITH and tok_lens is None):
        out = _decode_per_block(data, pos, sizes, algorithms, device)
    else:
        out_lens = np.minimum(block_size, orig_size - block_size * np.arange(len(sizes), dtype=np.int64))
        out = _decode_rows(data, pos, algorithms, sizes, out_lens, device, tok_lens)
    if len(out) != orig_size:
        raise ValueError(f"container: decoded {len(out)} bytes, expected {orig_size}")
    return out
