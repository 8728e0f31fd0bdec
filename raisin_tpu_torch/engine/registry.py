"""Codec registry of the port: algorithm names -> implementations.

The counterpart of raisin_tpu/engine/registry.py, with the same names
(``ENGINES``, ``SUITES``, ``Codec``, ``register_backend``,
``set_preferred_backend``, ``available_backends``, ``get_codec``,
``expand_algorithms``) and three backends:

- ``native`` — the port's C runtime (``native/``) for ``lzss``,
  ``arithmetic``, ``mcc`` and ``dmc``, built on its first call;
- ``device`` — the card's single-stream codecs (``ops/arithmetic_scan.py``,
  ``ops/lzss_stream.py``, ``ops/huffman_stream.py``), registered below as
  raisin_tpu/ops/dispatch.py registers the JAX package's;
- ``host``   — the port's copies of the host oracles (``formats/``), for
  every codec.

Every backend of a codec writes the same bytes. The auto order is
``device`` -> ``native`` -> ``host``: the port's entry points run on the
card unless the caller asks for the CPU. The JAX package puts its
``device`` backend last (registry.py:52-60) because a single stream there
pays a multi-second jit compile; the card's kernels are built once per
checkout and loaded at first use. So ``lzss``, ``arithmetic`` and
``huffman`` compress on the card, and ``mcc`` and ``dmc``, which have no
device codec, take ``native``. A raw `.rsn` arithmetic or LZSS stream
carries no output length, so kernel C has no step count: the ``device``
codecs of ``lzss`` and ``arithmetic`` decode such a stream with the
native C runtime, as the JAX package's auto order does (its ``device``
codecs decode it in the Python oracle, 25-70x slower than C). On an
NVIDIA H100 80GB HBM3 machine (700 W; ``chip_smoke.py``'s cli phase, the
first 1 MiB of its corpus, medians of 5), compress / decompress MB/s
under auto: ``lzss`` 424 / 132, ``arithmetic`` 9.8 / 11.7,
``lzss,arithmetic`` 14.3 / 16.1; on ``native``: 21.5 / 169, 16.8 / 12.3,
13.8 / 17.1. In the auto order, an LZSS window past the card's search
(65535, ROADMAP Queue 1 item 16) takes ``native``; a ``device`` asked
for by name raises ValueError there. A failed native build or kernel
launch raises; nothing turns it into a warning or a fall to the next
backend (the JAX package's ``_register_optional_backends`` does).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from raisin_tpu_torch import native
from raisin_tpu_torch.formats import arithmetic, dmc, huffman, lzss, mcc, stdlib_codecs
from raisin_tpu_torch.ops import arithmetic_scan, huffman_stream, lzss_match, lzss_stream

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

_FALLBACK_ORDER = ("device", "native", "host")


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
    """'auto' (device -> native -> host), or a specific backend tag."""
    global _preferred_backend
    _preferred_backend = backend


def available_backends(name: str) -> list[str]:
    return sorted(_IMPLS.get(name, {}))


def get_codec(name: str, backend: str | None = None, device=None, window: int | None = None) -> Codec:
    """The codec ``name`` on ``backend`` (None: the preferred one).

    A ``device`` codec's functions come bound to ``device`` (None: the card,
    RuntimeError without one when called); a backend the codec lacks falls
    to the auto order, as in the JAX package. The auto order passes over
    the card's ``lzss`` for an LZSS ``window`` outside its search.
    """
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
        if name == "lzss" and window is not None and not 1 <= window <= lzss_match.MAX_WINDOW:
            want_order = tuple(t for t in want_order if t != "device")
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
register_backend("mcc", "host", mcc.compress, mcc.decompress)
register_backend("dmc", "host", dmc.compress, dmc.decompress)
register_backend("flate", "host", stdlib_codecs.flate_compress, stdlib_codecs.flate_decompress)
register_backend("gzip", "host", stdlib_codecs.gzip_compress, stdlib_codecs.gzip_decompress)
register_backend("zlib", "host", stdlib_codecs.zlib_compress, stdlib_codecs.zlib_decompress)
register_backend("lzw", "host", stdlib_codecs.lzw_compress, stdlib_codecs.lzw_decompress)

# --- the C runtime (raisin_tpu/native/__init__.py:register), built on its first call

register_backend("lzss", "native", native.lzss_compress, native.lzss_decompress)
register_backend("arithmetic", "native", native.arith_compress, native.arith_decompress)
register_backend("mcc", "native", native.mcc_compress, native.mcc_decompress)
register_backend("dmc", "native", native.dmc_compress, native.dmc_decompress)

# --- the card's single-stream codecs (raisin_tpu/ops/dispatch.py:register_all)
# Each takes ``device=`` besides the data (get_codec binds it). Raw `.rsn`
# arithmetic and LZSS streams carry no output length, which kernel C needs,
# so those two decode with the native C runtime on the host.


def _raw_decode(fn: Callable[[bytes], bytes]) -> Callable[..., bytes]:
    def decompress(data: bytes, device=None) -> bytes:
        return fn(data)

    return decompress


register_backend("arithmetic", "device", arithmetic_scan.compress, _raw_decode(native.arith_decompress))
register_backend("lzss", "device", lzss_stream.compress, _raw_decode(native.lzss_decompress))
register_backend("huffman", "device", huffman_stream.compress, huffman_stream.decompress)
