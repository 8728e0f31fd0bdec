"""Standard-codec bindings: flate, gzip, lzw, zlib (the port's copy).

A copy of raisin_tpu/formats/stdlib_codecs.py (the port imports nothing of
the JAX package). It is the ``host`` backend of ``flate``, ``gzip``,
``zlib`` and ``lzw``.

Parity with the reference engine's stdlib wiring (engine/engine.go:48-139):
flate at level 9 (engine.go:125), gzip/zlib at the default level, and LZW
with MSB bit order and litWidth 8 (engine.go:78,130).

flate/gzip/zlib ride Python's ``zlib`` (interoperable DEFLATE streams — the
compressed bytes differ from Go's encoder but each side decodes the other's
output). LZW is implemented here from scratch to match Go's ``compress/lzw``
semantics: 9→12-bit variable-width codes, late width change, clear code
``1<<litWidth`` emitted on table overflow at code 4095, EOF code
``clear + 1``, MSB-first bit packing.
"""

from __future__ import annotations

import gzip as _gzip
import zlib as _zlib

# ---------------------------------------------------------------------------
# DEFLATE family


def flate_compress(data: bytes) -> bytes:
    c = _zlib.compressobj(9, _zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


def flate_decompress(data: bytes) -> bytes:
    return _zlib.decompress(data, -15)


def zlib_compress(data: bytes) -> bytes:
    return _zlib.compress(data, 6)


def zlib_decompress(data: bytes) -> bytes:
    return _zlib.decompress(data)


def gzip_compress(data: bytes) -> bytes:
    return _gzip.compress(data, compresslevel=6, mtime=0)


def gzip_decompress(data: bytes) -> bytes:
    return _gzip.decompress(data)


# ---------------------------------------------------------------------------
# LZW (Go compress/lzw semantics, MSB order, litWidth 8)

LIT_WIDTH = 8
CLEAR = 1 << LIT_WIDTH  # 256
EOF_CODE = CLEAR + 1  # 257
MAX_WIDTH = 12
MAX_CODE = (1 << MAX_WIDTH) - 1  # 4095


class _MSBBitWriter:
    __slots__ = ("out", "acc", "nbits")

    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code: int, width: int) -> None:
        self.acc = (self.acc << width) | code
        self.nbits += width
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)

    def flush(self) -> bytes:
        if self.nbits > 0:
            self.out.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


class _MSBBitReader:
    __slots__ = ("data", "acc", "nbits", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.acc = 0
        self.nbits = 0
        self.pos = 0

    def read(self, width: int) -> int:
        while self.nbits < width:
            if self.pos >= len(self.data):
                raise ValueError("lzw: truncated stream")
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8
        self.nbits -= width
        code = (self.acc >> self.nbits) & ((1 << width) - 1)
        return code


def lzw_compress(data: bytes) -> bytes:
    w = _MSBBitWriter()
    table: dict[int, int] = {}
    hi = EOF_CODE  # next assigned code is hi after increment (Go writer.go incHi)
    width = LIT_WIDTH + 1
    overflow = CLEAR << 1

    def inc_hi() -> bool:
        """Returns True when the table was cleared (out of codes)."""
        nonlocal hi, width, overflow, table
        hi += 1
        if hi == overflow:
            width += 1
            overflow <<= 1
        if hi == MAX_CODE:
            w.write(CLEAR, width)
            width = LIT_WIDTH + 1
            hi = EOF_CODE
            overflow = CLEAR << 1
            table = {}
            return True
        return False

    saved = -1
    for x in data:
        if saved < 0:
            saved = x
            continue
        key = (saved << 8) | x
        code = table.get(key)
        if code is not None:
            saved = code
            continue
        w.write(saved, width)
        saved = x
        if not inc_hi():
            table[key] = hi

    if saved >= 0:
        w.write(saved, width)
        inc_hi()  # may widen before EOF, exactly like Go's Close
    else:
        w.write(CLEAR, width)
    w.write(EOF_CODE, width)
    return w.flush()


def lzw_decompress(data: bytes) -> bytes:
    r = _MSBBitReader(data)
    out = bytearray()
    suffix = bytearray(1 << MAX_WIDTH)
    prefix = [0] * (1 << MAX_WIDTH)
    hi = EOF_CODE
    width = LIT_WIDTH + 1
    overflow = CLEAR << 1
    last = -1

    buf = bytearray(1 << MAX_WIDTH)
    while True:
        code = r.read(width)
        if code < CLEAR:
            out.append(code)
            if last >= 0:
                suffix[hi] = code
                prefix[hi] = last
        elif code == CLEAR:
            width = LIT_WIDTH + 1
            hi = EOF_CODE
            overflow = CLEAR << 1
            last = -1
            continue
        elif code == EOF_CODE:
            return bytes(out)
        elif code <= hi:
            c, i = code, len(buf) - 1
            if code == hi and last >= 0:
                # code == hi is the KwKwK case: expand last + first byte of last
                c = last
                while c >= CLEAR:
                    c = prefix[c]
                buf[i] = c
                i -= 1
                c = last
            while c >= CLEAR:
                buf[i] = suffix[c]
                i -= 1
                c = prefix[c]
            buf[i] = c
            out += buf[i:]
            if last >= 0:
                suffix[hi] = buf[i]
                prefix[hi] = last
        else:
            raise ValueError("lzw: invalid code")
        last, hi = code, hi + 1
        if hi >= overflow:
            if width == MAX_WIDTH:
                last = -1
                hi -= 1  # keep hi < overflow (Go reader.go)
            else:
                width += 1
                overflow <<= 1
