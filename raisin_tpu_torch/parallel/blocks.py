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
JAX package's, and each package reads the other's, with three exceptions,
all in the Huffman pipelines (ROADMAP, "In the reference" and
"Divergences"): ``lzss,huffman`` past window 16383, where the JAX
package's device search packs distances in 14 bits and writes wrong
tokens, carries the oracle's tokens here; the port builds Go's tree, which
the JAX package's heap does not where its sift-up passes the root; and a
block whose Huffman input is not valid UTF-8, whose Go stream would lose
bytes, is coded over its bytes (``formats/huffman.compress_block``), so
that every container decodes to its input. Past window 65535, the card's
search, the LZSS pipelines take each block's tokens from the native C
runtime, as the JAX package does past its own. An ``lzss,arithmetic``
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
the container or the decoded output comes back by one route in both
directions: one host buffer (``ops/device.host_buffer``, pinned for a
card), into which the header, written on the host, and every block range's
payloads or decoded bytes are put at their offsets (``ops/device.put``),
then one copy into the returned ``bytes``. Each pipeline's stages, a token
stage and a coder stage, are picked in one place (:func:`_stages`). The Huffman
pipelines add per-block host work on small tables only: the tree, the
code table and the header (``ops/huffman_blocks.py``).

Each stage runs inside a ``torch.profiler.record_function`` range
(``rsnb.compress`` / ``rsnb.decompress`` around a whole call,
``rsnb.range`` around each ``'data'`` entry's block range in the thread
that codes it, ``rsnb.enc.*`` / ``rsnb.dec.*`` per stage), and every wait
for the card and host copy inside one of ``ops/device.py``'s ``sync.*``
and ``copy.*`` ranges, so a profiler trace of the entry points gives the
time breakdown; outside a profiler a range costs about ten microseconds.

Layout (little-endian), as in the JAX package:
  magic "RSNB" | version u8 | algo_len u8 | algo CSV | block_size u32 |
  window u32 (v2+) | orig_size u64 | num_blocks u32 | num_aux u8 |
  num_blocks x u32 payload sizes |
  num_aux x (num_blocks x u32) auxiliary per-block lengths |
  concatenated payloads
"""

from __future__ import annotations

import concurrent.futures
import struct
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from raisin_tpu_torch.ops import arithmetic_rows, escape, huffman_blocks, lzss_decode, lzss_match, pipeline
from raisin_tpu_torch.ops.device import h2d, host_buffer, put, resolve_device, sync, to_bytes
from raisin_tpu_torch.parallel.mesh import Mesh, block_range

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
    with sync("width"):
        need = max(0, min(int(lens.max()), rows.shape[1]))
    cols = torch.arange(need, device=rows.device)
    with sync("mask"):
        return rows[:, :need][cols[None, :] < lens[:, None]]


def _payload_rows(flat: torch.Tensor, lens: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`_rows_payloads`: (B, width) rows, zero past each length."""
    rows = torch.zeros((lens.shape[0], width), dtype=torch.uint8, device=flat.device)
    cols = torch.arange(width, device=flat.device)
    with sync("mask"):
        rows[cols[None, :] < lens[:, None]] = flat
    return rows


class Stages(NamedTuple):
    """A card pipeline as two stages (:func:`_stages`), each named by what runs.

    Encode: the token stage (``tokens``) gives the coder its input: the
    block bytes (None), the escape and kernels D and E (:data:`CARD`), or
    the native C runtime's tokens past the card's search (:data:`NATIVE`);
    then the coder stage selects the tokens as they are (None), codes them
    in kernels A and B (``"arithmetic"``) or kernel G (``"huffman"``).
    Decode runs them back: kernel C, kernel H or the payload rows, then,
    for ``tokens`` not None, kernel F and the unescape, else a select.
    """

    tokens: str | None
    coder: str | None
    aux: bool  # the container writes (encode) or carries (decode) the aux table of token lengths
    step_bytes: tuple[int, int]  # CUDA_BYTES_PER_STEP's entry


CARD, NATIVE = "card", "native"


def _stages(algorithms: tuple[str, ...], window: int, aux: bool | None = None) -> Stages | None:
    """The card's stages of a pipeline; None where it codes block by block through the engine.

    ``aux`` is None on encode and, on decode, whether the container has an
    aux table. A pipeline outside :data:`PIPELINES` goes block by block.
    Encode: past the card's search (``lzss_match.MAX_WINDOW``) ``lzss`` and
    ``lzss,arithmetic`` go block by block, as the JAX package codes them
    past its own, and ``lzss,huffman`` takes the native runtime's tokens;
    the aux table is written as the JAX package writes it, for
    ``lzss,huffman`` and for ``lzss,arithmetic`` up to
    :data:`LZ_ARITH_AUX_MAX_WINDOW`. Decode: an ``lzss,arithmetic``
    container without an aux table goes block by block, since kernel C needs
    each block's token count.
    """
    if algorithms not in PIPELINES:
        return None
    lzss = algorithms[0] == "lzss"
    coder = None if algorithms[-1] == "lzss" else algorithms[-1]
    if aux is None:
        tokens = None
        if lzss and window <= lzss_match.MAX_WINDOW:
            tokens = CARD
        elif lzss and coder == "huffman":
            tokens = NATIVE
        elif lzss:
            return None
        aux = algorithms in WITH_AUX and not (algorithms == LZ_ARITH and window > LZ_ARITH_AUX_MAX_WINDOW)
    else:
        aux = aux and algorithms in WITH_AUX
        if lzss and coder == "arithmetic" and not aux:
            return None
        tokens = CARD if lzss else None
    return Stages(tokens, coder, aux, CUDA_BYTES_PER_STEP[algorithms])


def _native_tokens(x, n, window: int):
    """Each block's LZSS tokens at a window past the card's search, through ``compress_bytes`` under the
    preferred backend (native C under auto); -> (tok, tok_len) as ``pipeline.lzss_tokens`` gives them."""
    from raisin_tpu_torch.engine.core import compress_bytes

    with record_function("rsnb.enc.host"):
        with sync("d2h"):
            blocks, lens = x.cpu().numpy(), n.cpu().numpy()
        tokens = [compress_bytes(b[:k].tobytes(), LZ, window=window, device=x.device) for b, k in zip(blocks, lens)]
        with sync("h2d"):
            tok_len = torch.tensor([len(t) for t in tokens], dtype=torch.int32, device=x.device)
        return _payload_rows(h2d(b"".join(tokens), x.device), tok_len, max(1, max(len(t) for t in tokens))), tok_len


def _encode_batch(x, n, stages: Stages, window: int, first_block: int):
    """Encode one batch of blocks, the token stage then the coder stage -> (concatenated payloads on the
    device, sizes, token lengths where the container writes them, else None)."""
    if stages.tokens == NATIVE:
        x, n = _native_tokens(x, n, window)
    elif stages.tokens == CARD:
        with record_function("rsnb.enc.escape"):
            x, n = escape.escape_blocks(x, n)
        if stages.coder != "arithmetic":  # lzss,arithmetic's coder call runs D and E itself
            x, n = pipeline.lzss_tokens(x, n, window)
    if stages.coder == "huffman":
        flat, sizes = huffman_blocks.encode_blocks(x, n)
        return flat, sizes, _lengths(n) if stages.aux else None
    if stages.coder is None:
        with record_function("rsnb.enc.select"):
            return _rows_payloads(x, n), _lengths(n), None
    if stages.tokens:
        rows, byte_lens, n, oflow = pipeline.lzss_arith_encode_rows(x, n, window)
    else:
        with record_function("rsnb.enc.coder"):
            # one column more for EOF after a full block
            rows, byte_lens, oflow = pipeline.arith_encode_rows(F.pad(x, (0, 1)), n)
    with record_function("rsnb.enc.select"):
        body = _rows_payloads(rows, byte_lens)
        with sync("lengths"):
            oflow, byte_lens = oflow.cpu().numpy(), byte_lens.cpu().numpy()
            tok_len = n.cpu().numpy() if stages.aux else None
        _check_no_overflow(oflow, first_block)
        return body, byte_lens, tok_len


def _lengths(t: torch.Tensor) -> np.ndarray:
    """A device tensor of lengths, read to the host."""
    with sync("lengths"):
        return t.cpu().numpy()


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
    data: bytes, block_size: int, device: torch.device, stages: Stages, window: int, first_block: int = 0,
) -> tuple[np.ndarray, list[torch.Tensor], np.ndarray | None]:
    """Encode every block -> (payload sizes, each batch's concatenated payloads on ``device``, token lengths).

    The token lengths (None for containers without an aux table) become the
    container's aux table. ``first_block`` is the container index of the
    first block, for error messages.
    """
    W, lengths = _block_lengths(len(data), block_size)
    B = len(lengths)
    maxb = _batch_blocks(device, stages.step_bytes[0], W + 1)
    view = memoryview(data)
    sizes, bodies, toks = [], [], []
    for lo in range(0, B, maxb):
        hi = min(lo + maxb, B)
        with record_function("rsnb.enc.h2d"):
            x = h2d(view[lo * W : hi * W], device)
            # zeros past the ragged end
            x = F.pad(x, (0, (hi - lo) * W - x.numel())).view(hi - lo, W)
            with sync("h2d"):
                n = torch.from_numpy(lengths[lo:hi]).to(device)
        body, got, tok = _encode_batch(x, n, stages, window, first_block + lo)
        sizes.append(got)
        bodies.append(body)
        if tok is not None:
            toks.append(tok)
    return np.concatenate(sizes), bodies, np.concatenate(toks) if toks else None


def _lzss_tail(tok: torch.Tensor, tok_len: torch.Tensor, out_lens: np.ndarray, first_block: int) -> torch.Tensor:
    """Kernel F walks B token streams, then the escape decode; -> the blocks' bytes, concatenated on the device.

    The walk's rows hold ``2 * max(out_lens)`` bytes (escaping at most
    doubles a block); each block's decoded length must equal ``out_lens``.
    """
    with record_function("rsnb.dec.walk"):
        rows, esc_lens = lzss_decode.decode_tokens(tok, tok_len, 2 * int(out_lens.max()), first_block)
    with record_function("rsnb.dec.unescape"):
        plain, dec_lens = escape.unescape_rows(rows, esc_lens)
        dec_lens = _lengths(dec_lens)
        wrong = np.nonzero(dec_lens != out_lens)[0]
    if wrong.size:
        i = wrong[0]
        raise ValueError(f"container: block {first_block + i} decoded {dec_lens[i]} bytes, expected {out_lens[i]}")
    return plain


def _decode_arith(flat, sizes, coded, device, lo: int):
    """Kernel C over one batch -> (decoded symbol rows, their lengths on the device)."""
    steps = int(coded.max()) + 1  # payload + EOF
    with sync("h2d"):
        blens = torch.from_numpy(sizes.astype(np.int32)).to(device)
        clens = torch.from_numpy(coded.astype(np.int32)).to(device)
    prows = _payload_rows(flat, blens, int(sizes.max()) + 1)  # room for the decoder tail byte
    with record_function("rsnb.dec.coder"):
        syms, eof = arithmetic_rows.decode_rows(prows, blens, clens, steps)
    with record_function("rsnb.dec.eof_check"), sync("eof"):
        missing = np.nonzero(eof.cpu().numpy() == 0)[0]
    if missing.size:
        raise ValueError(f"container: block {lo + missing[0]} missing EOF symbol")
    return syms, clens


def _decode_huffman(flat, data, starts, sizes, cap_out: int, tok_lens, tokens: bool, device, lo: int):
    """Kernel H over one batch -> (rows, counts on the device), the host oracle's blocks in their rows.

    With an aux table (``tok_lens``), every block's count must equal its
    entry. Where the rows hold bytes, not ``tokens``, they widen to the
    oracle's longest block: the JAX package's Go stream of a block that is
    not valid UTF-8 decodes to more bytes than the block, and they count in
    the container's total, as the JAX package counts them.
    """
    rows, counts, host = huffman_blocks.decode_blocks(flat, data, starts, sizes, cap_out, lo)
    longest = max((len(decoded) for decoded in host.values()), default=0)
    if not tokens and longest > rows.shape[1]:
        rows = F.pad(rows, (0, longest - rows.shape[1]))
    for b, decoded in host.items():
        counts[b] = len(decoded)
        if 0 < len(decoded) <= rows.shape[1]:
            with sync("h2d"):
                rows[b, : len(decoded)] = torch.frombuffer(bytearray(decoded), dtype=torch.uint8).to(device)
    wrong = np.nonzero(counts != tok_lens)[0] if tok_lens is not None else []
    if len(wrong):
        i = wrong[0]
        raise ValueError(f"container: block {lo + i} decoded {counts[i]} token bytes, its aux table says {tok_lens[i]}")
    over = np.nonzero(counts > rows.shape[1])[0]
    if over.size:
        i = over[0]
        raise ValueError(f"container: block {lo + i} decoded {counts[i]} bytes, more than its row holds")
    with sync("h2d"):
        return rows, torch.from_numpy(counts.astype(np.int32)).to(device)


def _decode_rows(
    data: bytes, pos: int, stages: Stages, sizes: np.ndarray, out_lens: np.ndarray,
    device: torch.device, tok_lens: np.ndarray | None, out: torch.Tensor, first_block: int = 0,
) -> int:
    """Decode the concatenated payloads at ``data[pos:]`` of known decoded lengths into ``out``,
    the host buffer of these blocks' bytes; -> the bytes they decoded to.

    ``tok_lens`` is the aux table of the containers that carry one. The
    coder stage gives each block's tokens, or bytes, as a row; the LZSS
    pipelines end in kernel F and the escape decode on the whole batch, the
    JAX package's ``_dec_stage`` and ``_dec_tail``, the others in a select.
    ``first_block`` is the container index of the first block, for error
    messages.
    """
    B = len(sizes)
    grow = 2 if stages.tokens else 1  # escaping at most doubles a block
    steps = max(int(sizes.max()) + 1, int(out_lens.max()) * grow)
    if tok_lens is not None:
        steps = max(steps, int(tok_lens.max()) + 1)
    maxb = _batch_blocks(device, stages.step_bytes[1], steps)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    done = 0
    for lo in range(0, B, maxb):
        hi = min(lo + maxb, B)
        with record_function("rsnb.dec.h2d"):
            flat = h2d(memoryview(data)[pos + offsets[lo] : pos + offsets[hi]], device)
        part = slice(lo, hi)
        index = first_block + lo
        tok_part = None if tok_lens is None else tok_lens[part]
        if stages.coder == "arithmetic":
            coded = out_lens[part] if tok_part is None else tok_part
            tok, tok_len = _decode_arith(flat, sizes[part], coded, device, index)
        elif stages.coder == "huffman":
            # a block's decoded bytes: its aux entry, or its length, twice for escaped tokens
            cap = int(out_lens[part].max()) * grow if tok_part is None else int(tok_part.max())
            tok, tok_len = _decode_huffman(flat, data, pos + offsets[lo:hi], sizes[part], cap, tok_part,
                                           bool(stages.tokens), device, index)
        else:
            with sync("h2d"):
                tok_len = torch.from_numpy(sizes[part].astype(np.int32)).to(device)
            tok = _payload_rows(flat, tok_len, int(sizes[part].max()))
        if stages.tokens:
            piece = _lzss_tail(tok, tok_len, out_lens[part], index)
        else:
            piece = _rows_payloads(tok, tok_len)
        with record_function("rsnb.dec.d2h"):
            done += put(out, done, piece)
    return done


# ---------------------------------------------------------------------------
# Container


def compress_container(
    data: bytes,
    algorithms: list[str] | tuple[str, ...] = LZ_ARITH,
    block_size: int = DEFAULT_BLOCK_SIZE,
    mesh: Mesh | None = None,
    window: int = 4096,
    device: torch.device | str | None = None,
) -> bytes:
    """Block-parallel encode into the RSNB container.

    The arguments of raisin_tpu.parallel.blocks.compress_container, plus
    ``device`` (:func:`resolve_device`). The pipelines of :data:`PIPELINES`
    run on the card (``("lzss", "arithmetic")`` is the default) at LZSS
    windows up to the card's search, 65535 (ValueError below 1); the other
    pipelines record ``window`` in the header as the JAX package does. The
    Huffman pipelines raise the oracle's ValueError on empty input. Any
    other pipeline encodes block by block through the engine's
    ``compress_bytes`` (:func:`_encode_per_block`), and so do ``lzss`` and
    ``lzss,arithmetic`` past window 65535, as the JAX package codes them past
    its own device search (raisin_tpu/parallel/blocks.py:952): native C
    under the auto order, the oracle's tokens. ``lzss,huffman`` there takes
    each block's tokens the same way (:func:`_native_tokens`) and codes them
    with the card's Huffman layer, with the aux table of token lengths that
    the JAX package's ``lzss,huffman`` containers carry at every window.

    With a ``mesh`` (``parallel.mesh``), each ``'data'`` entry encodes its
    contiguous range of blocks on its own device, one host thread each,
    and the payloads join in block order: the bytes equal the call
    without it. ``device`` then only names the mesh's device type.
    """
    algorithms = tuple(algorithms)
    if block_size <= 0:
        raise ValueError("block_size must be positive")
    devices = _devices(mesh, device)
    num_blocks = max(1, -(-len(data) // block_size))
    stages = _stages(algorithms, window)
    if stages is not None and stages.tokens == CARD:
        lzss_match.check_window(window)

    def encode(lo, hi, dev):
        blocks = memoryview(data)[lo * block_size : hi * block_size]
        if stages is None:
            return _encode_per_block(blocks, algorithms, block_size, window, dev)
        return _encode_rows(blocks, block_size, dev, stages, window, lo)

    with record_function("rsnb.compress"):
        parts = _over_ranges(num_blocks, devices, encode)
        sizes = np.concatenate([part[0] for part in parts])
        with record_function("rsnb.enc.frame"):
            aux = [np.concatenate([part[2] for part in parts])] if stages is not None and stages.aux else []
            head = _header(sizes, aux, algorithms, block_size, window, len(data))
        # the header and every range's payloads into one host buffer (pinned for the cards' copies)
        out = host_buffer(len(head) + int(sizes.sum()), devices)
        with record_function("rsnb.enc.d2h"):
            at = put(out, 0, head)
            for part in parts:
                for piece in part[1]:
                    at += put(out, at, piece)
        with record_function("copy.bytes"):
            return to_bytes(out)


def _devices(mesh: Mesh | None, device) -> list[torch.device]:
    """The device of each ``'data'`` entry, or the one device of an unsharded call.

    A ``device`` beside a mesh must name the mesh's device type.
    """
    if mesh is None:
        return [resolve_device(device)]
    found = mesh.data_devices()
    if device is not None and any(d.type != torch.device(device).type for d in found):
        raise ValueError(f"mesh devices {sorted({str(d) for d in found})} are not of device {str(device)!r}'s type")
    return found


def _on_device(fn, lo: int, hi: int, dev: torch.device):
    """``fn(lo, hi, dev)`` in a range ``rsnb.range``, with ``dev`` as the thread's current CUDA device."""
    with record_function("rsnb.range"):
        if dev.type != "cuda":
            return fn(lo, hi, dev)
        with torch.cuda.device(dev):
            return fn(lo, hi, dev)


def _over_ranges(num_blocks: int, devices: list[torch.device], fn) -> list:
    """``fn(lo, hi, device)`` over each entry's contiguous block range, in block order.

    Ranges come from :func:`parallel.mesh.block_range`; an empty range runs
    nothing. On distinct devices the ranges run in one host thread each
    (PyTorch's operators and the kernel launches release the interpreter
    lock); entries that share one device (the CPU entries of a test mesh)
    run in turn, since threads would only contend for it and for the
    interpreter lock that the plain versions' step loops hold. The first
    exception raised in any range is raised here.
    """
    jobs = [(*block_range(num_blocks, i, len(devices)), d) for i, d in enumerate(devices)]
    jobs = [job for job in jobs if job[1] > job[0]]
    if len(jobs) == 1 or len(set(devices)) == 1:
        return [_on_device(fn, *job) for job in jobs]
    with concurrent.futures.ThreadPoolExecutor(len(jobs), thread_name_prefix="rsnb") as pool:
        futures = [pool.submit(_on_device, fn, *job) for job in jobs]
        return [f.result() for f in futures]


def _encode_per_block(data, algorithms: tuple[str, ...], block_size: int, window: int,
                      device: torch.device) -> tuple[np.ndarray, list[bytes], None]:
    """A pipeline without a device path, block by block through ``compress_bytes`` under the
    preferred backend, as the JAX package encodes it (raisin_tpu/parallel/blocks.py:973-980);
    -> (payload sizes, payloads, None)."""
    from raisin_tpu_torch.engine.core import compress_bytes

    with record_function("rsnb.enc.host"):
        blocks = [bytes(data[i : i + block_size]) for i in range(0, len(data), block_size)] or [b""]
        payloads = [compress_bytes(b, algorithms, window=window, device=device) for b in blocks]
        return np.array([len(p) for p in payloads], dtype=np.int64), payloads, None


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


def decompress_container(data: bytes, mesh: Mesh | None = None,
                         device: torch.device | str | None = None) -> bytes:
    """Block-parallel decode of an RSNB container; the pipelines of :data:`PIPELINES` on the card.

    With a ``mesh``, each ``'data'`` entry decodes its contiguous range of
    blocks on its own device and the output joins in block order, as
    :func:`compress_container` encodes.
    """
    devices = _devices(mesh, device)
    with record_function("rsnb.decompress"):
        return _decompress_container(data, devices)


def _decode_per_block(data: bytes, pos: int, sizes, algorithms: tuple[str, ...], device: torch.device,
                      out: torch.Tensor) -> int:
    """Block by block through ``decompress_bytes`` under the preferred backend into ``out``, as the JAX
    package decodes a pipeline without a device path and an lzss,arithmetic container without token
    lengths (raisin_tpu/parallel/blocks.py:1084): kernel C needs the step count. -> the bytes decoded."""
    from raisin_tpu_torch.engine.core import decompress_bytes

    done = 0
    with record_function("rsnb.dec.host"):
        for p in _split(data, sizes, pos):
            done += put(out, done, decompress_bytes(p, algorithms, device=device))
    return done


def _decompress_container(data: bytes, devices: list[torch.device]) -> bytes:
    algorithms, block_size, orig_size, sizes, aux, window, pos = _parse_header(data)
    if orig_size == 0:
        return b""
    stages = _stages(algorithms, window, aux=bool(aux))
    tok_lens = np.array(aux[0], dtype=np.int64) if stages is not None and stages.aux else None
    sizes = np.array(sizes, dtype=np.int64)
    if pos + int(sizes.sum()) > len(data):
        raise ValueError("container: payloads run past the end of the data")
    offsets = pos + np.concatenate([[0], np.cumsum(sizes)])
    out_lens = np.minimum(block_size, orig_size - block_size * np.arange(len(sizes), dtype=np.int64))
    # every range decodes into its slice of one host buffer (pinned for the cards' copies): no
    # bytes a range, no join
    starts = np.concatenate([[0], np.cumsum(np.maximum(out_lens, 0))])
    out = host_buffer(orig_size, devices)

    def decode(lo, hi, dev):
        into = out[starts[lo] : starts[hi]]
        if stages is None:
            return _decode_per_block(data, int(offsets[lo]), sizes[lo:hi], algorithms, dev, into)
        return _decode_rows(data, int(offsets[lo]), stages, sizes[lo:hi], out_lens[lo:hi], dev,
                            None if tok_lens is None else tok_lens[lo:hi], into, lo)

    done = sum(_over_ranges(len(sizes), devices, decode))
    if done != orig_size:
        raise ValueError(f"container: decoded {done} bytes, expected {orig_size}")
    with record_function("copy.bytes"):
        return to_bytes(out)
