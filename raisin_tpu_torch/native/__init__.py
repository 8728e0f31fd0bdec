"""Native (C) host runtime: the port's copy of raisin_tpu/native.

Fast sequential paths that share the exact formats: ``src/rsn_native.c`` (a
copy of the JAX package's, with its token buffer widened) is compiled with
g++ on the first call, not at import, into ``raisin_tpu_torch/_build/native``
under a hash of the source, the flags and what ``-march=native`` selects on
this host (so a library copied with the checkout to another CPU is not
loaded there), and loaded with ctypes. The engine registers it
as the ``native`` backend of ``lzss``, ``arithmetic``, ``mcc`` and ``dmc``;
every byte it writes equals the port's oracle copies in ``formats/``. The
container's Huffman layer writes and reads its card blocks' headers, with
each block's tree (Go's), a batch of blocks in one call without the
interpreter lock (:func:`huffman_encode_tables`, :func:`huffman_read_headers`).

A failed build raises :class:`NativeBuildError`: nothing falls back to the
Python copies here, the registry's order picks the backend. Threads and
processes may build at once: each compiles into its own temporary file in
the cache directory and renames it into place, and a lock keeps the threads
of one process to one build.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "rsn_native.c")
_CACHE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build", "native")

_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def _gxx(*args: str) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(["g++", *args], capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"native build failed: {e}") from e


def _build() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_gxx(*_FLAGS[:2], "-Q", "--help=target").stdout.encode())  # the target -march=native picks
    tag = h.hexdigest()[:16]
    os.makedirs(_CACHE, exist_ok=True)
    so_path = os.path.join(_CACHE, f"rsn_native-{tag}.so")
    if os.path.exists(so_path):
        return so_path
    fd, tmp = tempfile.mkstemp(prefix=f"rsn_native-{tag}.", suffix=".tmp", dir=_CACHE)
    os.close(fd)
    try:
        proc = _gxx(*_FLAGS, "-x", "c", _SRC, "-o", tmp)
        if proc.returncode != 0:
            raise NativeBuildError(f"native build failed:\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rsn_free.argtypes = [u8p]
        lib.rsn_free.restype = None
        for name, extra in (
            ("rsn_lzss_compress", [ctypes.c_int]),
            ("rsn_lzss_decompress", []),
            ("rsn_arith_compress", []),
            ("rsn_arith_decompress", []),
            ("rsn_mcc_compress", []),
            ("rsn_mcc_decompress", []),
            ("rsn_dmc_compress", []),
            ("rsn_dmc_decompress", []),
        ):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long] + extra + [
                ctypes.POINTER(u8p),
                ctypes.POINTER(ctypes.c_long),
            ]
            fn.restype = ctypes.c_long
        lib.rsn_huffman_encode_tables.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long] + [ctypes.c_void_p] * 6
        lib.rsn_huffman_encode_tables.restype = ctypes.c_long
        lib.rsn_huffman_headers.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                            ctypes.c_void_p]
        lib.rsn_huffman_headers.restype = ctypes.c_long
        lib.rsn_huffman_read_headers.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
                                                 ctypes.c_long, ctypes.c_int64] + [ctypes.c_void_p] * 9
        lib.rsn_huffman_read_headers.restype = ctypes.c_long
        _lib = lib
        return lib


def _call(fn_name: str, data: bytes, *extra) -> bytes:
    lib = _load()
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_long()
    rc = getattr(lib, fn_name)(
        data, ctypes.c_long(len(data)), *extra, ctypes.byref(out_p), ctypes.byref(out_len)
    )
    if rc != 0:
        # mirror the host oracles' messages (RSN_ERR_ALLOC=-1, RSN_ERR_FORMAT=-2,
        # RSN_ERR_DMC=-3)
        if rc == -2:
            raise ValueError(f"{fn_name}: malformed stream (ended without EOF symbol?)")
        if rc == -3:
            from raisin_tpu_torch.formats.dmc import DmcError

            raise DmcError("dmc: stack emptied or no transition (reference panics)")
        raise MemoryError(f"{fn_name}: native allocation failure")
    try:
        return ctypes.string_at(out_p, out_len.value)
    finally:
        lib.rsn_free(out_p)


def lzss_compress(data: bytes, window_size: int = 4096) -> bytes:
    return _call("rsn_lzss_compress", data, ctypes.c_int(window_size))


def lzss_decompress(data: bytes) -> bytes:
    return _call("rsn_lzss_decompress", data)


def arith_compress(data: bytes) -> bytes:
    return _call("rsn_arith_compress", data)


def arith_decompress(data: bytes) -> bytes:
    return _call("rsn_arith_decompress", data)


def mcc_compress(data: bytes) -> bytes:
    return _call("rsn_mcc_compress", data)


def mcc_decompress(data: bytes) -> bytes:
    return _call("rsn_mcc_decompress", data)


def dmc_compress(data: bytes) -> bytes:
    return _call("rsn_dmc_compress", data)


def dmc_decompress(data: bytes) -> bytes:
    """Reference-parity stub (dmc.go:274): always b"Hello!"."""
    return _call("rsn_dmc_decompress", data)


def _shapes(ok: bool) -> None:
    if not ok:
        raise ValueError("native: arrays of mismatched shapes")


class EncodeTables(NamedTuple):
    """The card's tables and headers of a batch of blocks to encode (:func:`huffman_encode_tables`)."""

    on_host: np.ndarray  # (B,) bool: the block takes the host oracle; its rows below are zero
    ids: np.ndarray  # (B, 256) uint8: the id the kernels take for each byte
    codes: np.ndarray  # (B, 128) uint32 by id: each code in its code_lens low bits, the first bit the most significant
    code_lens: np.ndarray  # (B, 128) int32 by id
    nbits: np.ndarray  # (B,) int64: the block's payload bits
    heads: np.ndarray  # (B, P) uint8: the block's header and separator, right-aligned; P the longest
    head_lens: np.ndarray  # (B,) int64: the header's bytes with the separator
    longest: int  # the deepest code of the card's blocks, -1 for none


def huffman_encode_tables(counts: np.ndarray, raw: np.ndarray) -> EncodeTables:
    """Which of B blocks the card codes, with their Go trees' code tables, bit counts and headers.

    Args:
      counts: (B, 256) int64 byte counts.
      raw: (B,) bool, the blocks coded over their bytes.

    A block takes the host oracle where it is not raw and has a byte >= 0x80,
    or is raw and leaves too few ASCII values free for its bytes >= 0x80
    (``ops/huffman_blocks.ascii_ids``). A card block's header is
    ``formats/huffman.build_header`` of its counts and the separator. One call
    builds the tables and measures the headers, a second writes them.
    """
    lib = _load()
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    B = counts.shape[0]
    _shapes(counts.shape == (B, 256) and raw.shape == (B,))
    on_host = np.empty(B, dtype=np.uint8)
    ids = np.empty((B, 256), dtype=np.uint8)
    codes = np.empty((B, 128), dtype=np.uint32)
    lens = np.empty((B, 128), dtype=np.int32)
    nbits = np.empty(B, dtype=np.int64)
    head_lens = np.empty(B, dtype=np.int64)
    longest = lib.rsn_huffman_encode_tables(counts.ctypes.data, raw.ctypes.data, B, on_host.ctypes.data,
                                            ids.ctypes.data, codes.ctypes.data, lens.ctypes.data, nbits.ctypes.data,
                                            head_lens.ctypes.data)
    width = int(head_lens.max(initial=0))
    heads = np.zeros((B, width), dtype=np.uint8)
    if lib.rsn_huffman_headers(counts.ctypes.data, on_host.ctypes.data, B, width, heads.ctypes.data) != 0:
        raise RuntimeError("rsn_huffman_headers: a header longer than rsn_huffman_encode_tables measured it")
    return EncodeTables(on_host.view(bool), ids, codes, lens, nbits, heads, head_lens, int(longest))


# the largest count of a header that rsn_huffman_read_headers takes (HF_MAX_COUNT)
HUFFMAN_MAX_COUNT = 1 << 40


class ReadHeaders(NamedTuple):
    """The blocks' headers as :func:`huffman_read_headers` read them; rows of blocks not taken are zero."""

    taken: np.ndarray  # (B,) bool: the card decodes the block
    freqs: np.ndarray  # (B, 256) int64
    ids: np.ndarray  # (B, 256) uint8: the id kernel H gives each symbol (the identity where not taken)
    raw: np.ndarray  # (B,) bool: the block is coded over its bytes
    back: np.ndarray  # (B, 128) uint8: a raw block's byte of each id
    pads: np.ndarray  # (B,) int32: the pad byte
    pstart: np.ndarray  # (B,) int64: the payload's first byte after the pad byte, less ``base``
    blens: np.ndarray  # (B,) int64: the payload's bytes after the pad byte
    tables: np.ndarray  # (B, 64) int32: kernel H's child table


def huffman_read_headers(data, starts: np.ndarray, sizes: np.ndarray, base: int) -> ReadHeaders:
    """Read B blocks' headers, block b at ``data[starts[b] : starts[b] + sizes[b]]``, as
    ``formats/huffman.read_header`` reads them, and build the trees of those the card decodes.

    The card takes a block whose separator and pad byte lie inside it and
    whose header names two symbols or more, each counted once or more, each
    ASCII or, in a block coded over its bytes, a byte with an ASCII id, and
    none counted more than :data:`HUFFMAN_MAX_COUNT` (a count no block of the
    container's writer reaches). Every other block is left to the caller.
    ``data`` (bytes-like) is read in place.
    """
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    B = starts.shape[0]
    _shapes(sizes.shape == (B,))
    out = ReadHeaders(
        np.empty(B, dtype=np.uint8), np.empty((B, 256), dtype=np.int64), np.empty((B, 256), dtype=np.uint8),
        np.empty(B, dtype=np.uint8), np.empty((B, 128), dtype=np.uint8), np.empty(B, dtype=np.int32),
        np.empty(B, dtype=np.int64), np.empty(B, dtype=np.int64), np.empty((B, 64), dtype=np.int32),
    )
    lib.rsn_huffman_read_headers(buf.ctypes.data, buf.size, starts.ctypes.data, sizes.ctypes.data, B, base,
                                 *(a.ctypes.data for a in out))
    return out._replace(taken=out.taken.view(bool), raw=out.raw.view(bool))
