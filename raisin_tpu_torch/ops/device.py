"""Device choice and host copies for the port (the counterpart of raisin_tpu/ops/jax_setup.py).

The rule for ``device=None`` is written down once, here: it means the CUDA
card, and raises when PyTorch sees none. The CPU runs only when a caller
asks for it (``device="cpu"``, as the tests do); nothing falls back to it.
Every entry point of the port takes an explicit ``device`` and passes it
through :func:`resolve_device`.

:func:`h2d` and :func:`d2h` move whole buffers between Python bytes and a
device, for the container and the single-stream codecs alike. Every result
that comes back from a device takes one route: :func:`host_buffer` allocates
its host buffer (pinned when a card writes into it), :func:`put` writes each
piece, a tensor on any device or bytes, at its offset, and :func:`to_bytes`
makes the returned ``bytes``. :func:`d2h` is that route for one tensor; the
RSNB container (``parallel/blocks.py``) puts its header and every block
range's payloads, or decoded bytes, into one buffer.

Every call in which the host waits for the card runs inside :func:`sync`,
a ``torch.profiler.record_function`` range ``sync.<what>`` named after
what the host reads: ``sync.h2d`` and ``sync.d2h`` (the blocking copies),
``sync.lengths`` (lengths and flags read back), ``sync.width`` (a maximum
that sizes a buffer), ``sync.any`` (whether a batch needs a slower path),
``sync.mask`` (boolean-mask indexing, which reads the selection's size),
``sync.symbols`` (a symbol range check), ``sync.eof`` and
``sync.faults`` (a decode's flags). The host's own copies run in
``copy.pin`` (a pinned buffer's allocation) and ``copy.bytes`` (the copy
into the returned ``bytes``). A range costs about ten microseconds of host
time outside a profiler and about sixteen inside one.

:func:`to_bytes` makes the returned ``bytes`` without holding the
interpreter lock while it copies: a fresh copy of tens of MiB spends tens of
milliseconds in first-touch page faults, and a copy that held the lock would
keep every other host thread (another client, a card's range) from launching
or reading back meanwhile. Large buffers are copied in contiguous pieces over
a small pool of host threads. :data:`copies` counts how each copy went.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from raisin_tpu_torch.ops import _build

_waits = threading.local()

PIECE_MIN = 4 << 20  # a piece of a split copy holds at least this many bytes
MAX_PIECES = 4

# both hold the interpreter lock (ctypes.pythonapi); the fill, ctypes.memmove, releases it
_new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
_new_bytes.argtypes = (ctypes.c_void_p, ctypes.c_ssize_t)
_new_bytes.restype = ctypes.py_object
_bytes_address = ctypes.pythonapi.PyBytes_AsString
_bytes_address.argtypes = (ctypes.py_object,)
_bytes_address.restype = ctypes.c_void_p

copies = {"whole": 0, "split": 0, "pieces": 0}
_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``cuda`` (RuntimeError without a card); any other value as given."""
    if device is None:
        return require_cuda()
    return torch.device(device)


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


class sync:
    """``with sync("what"):`` around a call in which the host waits for the card: a range
    ``sync.<what>``, and the thread's count of open ones (:func:`waiting`)."""

    __slots__ = ("_range",)

    def __init__(self, what: str):
        self._range = record_function("sync." + what)

    def __enter__(self) -> None:
        _waits.depth = getattr(_waits, "depth", 0) + 1
        self._range.__enter__()

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        _waits.depth -= 1


def waiting() -> bool:
    """Whether this thread is inside a :class:`sync` range."""
    return getattr(_waits, "depth", 0) > 0


def h2d(buf, device: torch.device) -> torch.Tensor:
    """A bytes-like object -> uint8 tensor on ``device``, read and never written."""
    if len(buf) == 0:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # frombuffer warns that bytes are read-only
        host = torch.frombuffer(buf, dtype=torch.uint8)
    with sync("h2d"):  # from pageable memory: the copy waits for the card's queue
        return host.to(device)


def host_buffer(n: int, devices) -> torch.Tensor:
    """An ``n``-byte uint8 host buffer for a result's pieces (:func:`put`), allocated in ``copy.pin``:
    pinned when any of ``devices`` is a card, so that a card's piece is copied straight into it."""
    with record_function("copy.pin"):
        return torch.empty(n, dtype=torch.uint8, pin_memory=any(torch.device(d).type == "cuda" for d in devices))


def put(out: torch.Tensor, at: int, piece) -> int:
    """Copy ``piece`` (a 1-D uint8 tensor on any device, or bytes) into ``out[at:]``, the host buffer of
    :func:`host_buffer`, as far as ``out`` reaches; -> the piece's length. A tensor's copy runs in
    ``sync.d2h``."""
    n = len(piece)
    room = max(0, min(n, out.numel() - at))
    if room and torch.is_tensor(piece):
        with sync("d2h"):
            out[at : at + room].copy_(piece[:room])
    elif room:
        out.numpy()[at : at + room] = np.frombuffer(piece, dtype=np.uint8, count=room)
    return n


def d2h(t: torch.Tensor) -> bytes:
    """1-D uint8 tensor -> bytes; from a card through a pinned :func:`host_buffer` and :func:`put`."""
    if t.device.type != "cpu":
        host = host_buffer(t.numel(), [t.device])
        put(host, 0, t)
        t = host
    with record_function("copy.bytes"):
        return to_bytes(t)


def copy_pieces(n: int) -> int:
    """The number of pieces :func:`to_bytes` splits an ``n``-byte copy into: each at least
    :data:`PIECE_MIN` bytes, at most :data:`MAX_PIECES`, and at most half the host's cores."""
    if n < 2 * PIECE_MIN:  # os.cpu_count() reads a file: tens of microseconds on some hosts
        return 1
    return max(1, min(MAX_PIECES, (os.cpu_count() or 1) // 2, n // PIECE_MIN))


def to_bytes(host: torch.Tensor) -> bytes:
    """A CPU tensor's bytes (``host.numpy().tobytes()``), copied without the interpreter lock.

    The ``bytes`` is allocated uninitialised and filled by ``ctypes.memmove``, which releases the
    lock; a copy of :func:`copy_pieces` > 1 pieces runs the first on the calling thread and the
    others on a pool made at the first such copy. It returns once every piece has landed.
    """
    if host.device.type != "cpu":
        raise ValueError(f"to_bytes: a CPU tensor, not one on {host.device}")
    host = host.contiguous()
    n = host.numel() * host.element_size()
    k = copy_pieces(n)
    if n == 0:
        out = b""
    else:
        out = _new_bytes(None, n)
        dst, src = _bytes_address(out), host.data_ptr()
        step = -(-n // k)
        pieces = [_copier().submit(ctypes.memmove, dst + a, src + a, min(step, n - a))
                  for a in range(step, n, step)]
        ctypes.memmove(dst, src, step)
        for piece in pieces:
            piece.result()
    if k == 1:
        _build.count(copies, "whole")
    else:
        _build.count(copies, "split")
        _build.count(copies, "pieces", k)
    return out


def reset_copy_counts() -> None:
    for key in copies:
        copies[key] = 0


def _copier() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(MAX_PIECES - 1, thread_name_prefix="to_bytes")
        return _pool


def _forget_pool() -> None:
    """A forked child has none of its parent's pool threads: it makes a pool of its own."""
    global _pool, _pool_lock
    _pool, _pool_lock = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)
