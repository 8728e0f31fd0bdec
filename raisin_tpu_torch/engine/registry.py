"""Codec registry of the port: algorithm names -> implementations.

The counterpart of raisin_tpu/engine/registry.py, with the same names
(``ENGINES``, ``SUITES``, ``Codec``, ``register_backend``,
``set_preferred_backend``, ``available_backends``, ``get_codec``,
``expand_algorithms``) and two backends per codec:

- ``device`` — the card's single-stream codecs (``ops/arithmetic_scan.py``,
  ``ops/lzss_stream.py``, ``ops/huffman_stream.py``), registered below as
  raisin_tpu/ops/dispatch.py registers the JAX package's;
- ``host``   — the port's copies of the host oracles (``formats/``).

Every backend of a codec writes the same bytes. The auto order is
``device`` -> ``host``. The JAX package puts its ``device`` backend last
(registry.py:52-60) because a single stream there pays a multi-second jit
compile; the card's kernels are built once per checkout and loaded at first
use, so the port tries the card first. The port has no ``native`` backend:
that C library belongs to the JAX package. It does not turn a failed import
into a warning either (``_register_optional_backends``): the device codecs
are imported directly, and a kernel that does not build or launch raises.

The six host-only codecs (``mcc``, ``dmc``, ``flate``, ``gzip``, ``lzw``,
``zlib``), and through them ``all`` and ``suite``, raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from raisin_tpu_torch.formats import arithmetic, huffman, lzss
from raisin_tpu_torch.ops import arithmetic_scan, huffman_stream, lzss_stream

ENGINES = [
    "all",
    "suite",
    "lzss",
    "dmc",
    "huffman",
    "mcc",
    "flate",
    "gzip",
    "lzw",
    "zlib",
    "arithmetic",
]

SUITES: dict[str, list[str]] = {
    "all": ENGINES[2:],
    "suite": ["lzss", "dmc", "huffman", "mcc", "flate", "gzip", "lzw", "zlib", "arithmetic"],
}

HOST_ONLY = ("mcc", "dmc", "flate", "gzip", "lzw", "zlib")

_FALLBACK_ORDER = ("device", "host")


@dataclass(frozen=True)
class Codec:
    name: str
    backend: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]


# name -> backend -> (compress, decompress)
_IMPLS: dict[str, dict[str, tuple[Callable, Callable]]] = {}

_preferred_backend = "auto"


def register_backend(
    name: str,
    backend: str,
    compress: Callable[[bytes], bytes],
    decompress: Callable[[bytes], bytes],
) -> None:
    _IMPLS.setdefault(name, {})[backend] = (compress, decompress)


def set_preferred_backend(backend: str) -> None:
    """'auto' (device -> host), or a specific backend tag."""
    global _preferred_backend
    _preferred_backend = backend


def available_backends(name: str) -> list[str]:
    return sorted(_IMPLS.get(name, {}))


def get_codec(name: str, backend: str | None = None, device=None) -> Codec:
    """The codec ``name`` on ``backend`` (None: the preferred one).

    A ``device`` codec's functions come bound to ``device`` (None: the card,
    RuntimeError without one when called); a backend the codec lacks falls
    to the auto order, as in the JAX package.
    """
    if name in HOST_ONLY:
        raise NotImplementedError(
            f"raisin_tpu_torch has no {name!r} codec yet; the host-only codecs come with "
            f"ROADMAP Queue 1 item 19 (the CLI, the benchmark harness and the host-only codecs)"
        )
    impls = _IMPLS.get(name)
    if impls is None:
        raise KeyError(f"unknown compression algorithm: {name!r}")
    want = backend or _preferred_backend
    if want != "auto":
        if want not in impls:
            want_order = (want,) + _FALLBACK_ORDER  # specific backend then fallbacks
        else:
            want_order = (want,)
    else:
        want_order = _FALLBACK_ORDER
    for tag in want_order:
        if tag in impls:
            c, d = impls[tag]
            if tag == "device":
                c, d = functools.partial(c, device=device), functools.partial(d, device=device)
            return Codec(name, tag, c, d)
    raise KeyError(f"no implementation registered for {name!r}")


def expand_algorithms(algorithms: list[str]) -> list[str]:
    """Expand 'all'/'suite' pseudo-algorithms (functional superset of engine.go:36)."""
    out: list[str] = []
    for algo in algorithms:
        if algo in SUITES:
            out.extend(SUITES[algo])
        else:
            out.append(algo)
    return out


# --- host oracle registrations -------------------------------------------

register_backend("arithmetic", "host", arithmetic.compress, arithmetic.decompress)
register_backend("huffman", "host", huffman.compress, huffman.decompress)
register_backend("lzss", "host", lzss.compress, lzss.decompress)

# --- the card's single-stream codecs (raisin_tpu/ops/dispatch.py:register_all)
# Each takes ``device=`` besides the data (get_codec binds it). Raw `.rsn`
# arithmetic and LZSS streams carry no output length, so their decodes take
# the port's copies of the host oracles, as in the JAX package.

register_backend("arithmetic", "device", arithmetic_scan.compress, arithmetic_scan.decompress)
register_backend("lzss", "device", lzss_stream.compress, lzss_stream.decompress)
register_backend("huffman", "device", huffman_stream.compress, huffman_stream.decompress)
