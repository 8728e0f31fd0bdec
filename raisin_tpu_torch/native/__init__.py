"""Native (C) host runtime: the port's copy of raisin_tpu/native.

Fast sequential paths that share the exact formats: ``src/rsn_native.c`` (a
copy of the JAX package's, with its token buffer widened) is compiled with
g++ on the first call, not at import, into ``raisin_tpu_torch/_build/native``
under a hash of the source, the flags and what ``-march=native`` selects on
this host (so a library copied with the checkout to another CPU is not
loaded there), and loaded with ctypes. The engine registers it
as the ``native`` backend of ``lzss``, ``arithmetic``, ``mcc`` and ``dmc``;
every byte it writes equals the port's oracle copies in ``formats/``. The
container's Huffman layer takes its trees from :func:`huffman_trees`, Go's
trees of a batch of blocks in one call without the interpreter lock.

A failed build raises :class:`NativeBuildError`: nothing falls back to the
Python copies here, the registry's order picks the backend. Threads and
processes may build at once: each compiles into its own temporary file in
the cache directory and renames it into place, and a lock keeps the threads
of one process to one build.
"""

from __future__ import annotations

import ctypes
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
        lib.rsn_huffman_trees.argtypes = [ctypes.c_void_p, ctypes.c_long] + [ctypes.c_void_p] * 5
        lib.rsn_huffman_trees.restype = ctypes.c_long
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


def huffman_trees(counts: np.ndarray, ids: np.ndarray):
    """Go's Huffman tree of each of B tables of byte counts, as ``formats/huffman.build_tree`` builds it.

    Args:
      counts: (B, 256) int64 byte counts; a block of zeros gets no tree.
      ids: (B, 256) uint8, the id kernel H takes for each symbol.

    Returns (codes (B, 256) uint32, lens (B, 256) int32, tables (B, 64)
    int32, longest (B,) int32): each symbol's code (its ``lens`` low bits,
    the first bit the most significant; 0 past 32 bits) and length, 0 for an
    absent symbol and for a one-leaf tree's; kernel H's child table
    (``ops/huffman_blocks.packed_table``'s layout), zero where an id is 128
    or more or the tree has one leaf; and the deepest code, -1 for no tree.
    """
    lib = _load()
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    ids = np.ascontiguousarray(ids, dtype=np.uint8)
    B = counts.shape[0]
    codes = np.empty((B, 256), dtype=np.uint32)
    lens = np.empty((B, 256), dtype=np.int32)
    tables = np.empty((B, 64), dtype=np.int32)
    longest = np.empty(B, dtype=np.int32)
    lib.rsn_huffman_trees(counts.ctypes.data, B, ids.ctypes.data, codes.ctypes.data, lens.ctypes.data,
                          tables.ctypes.data, longest.ctypes.data)
    return codes, lens, tables, longest

