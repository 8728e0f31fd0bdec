"""Huffman codec, exact `.rsn` wire format: the port's copy of the host oracle.

A copy of raisin_tpu/formats/huffman_ref.py (the port imports nothing of
the JAX package): Go's rune iteration, the tree build with Go's
container/heap mechanics, the code walk, the header and the per-stream
compress/decompress, with the same error messages. One departure: the
heap's sift-up stops at the root as Go's does, where the JAX package's
copy compares the root with the last item (``_GoTreeHeap._up``), so the
trees, and the bytes, differ wherever that comparison swaps them. The
container uses ``build_tree``/``print_codes``/``build_header``/
``read_header`` per block and ``compress_block``/``decompress_block`` for
the blocks that the card does not take.

The container's blocks (``compress_block``) add a second departure, a
lossless one. Go's rune iteration gives back a block's bytes exactly where
they are valid UTF-8; elsewhere it turns every stray byte into U+FFFD and
Go's own stream decodes to other bytes (an ``lzss,huffman`` block of text
with a ``<``, which the LZSS escape writes as 0xFF, for one). Such a block
is coded over its bytes in the same layout: the header's symbols are the
raw bytes, in ascending order, and the tree is built from their counts as
Go builds it from runes'. A byte >= 0x80 in a header is then followed by
an ASCII byte, so it begins no valid UTF-8 sequence, which Go never writes
there: ``read_header`` tells the two kinds apart by that alone. Where a
block holds one such byte value beside ASCII (the escaped ``<``), its tree,
codes and bits are Go's, and only that symbol's header bytes differ.

Format (reference compressor/huffman/huffman.go):

- RUNE-based (Unicode code points, not bytes): the input is decoded as UTF-8
  the way Go's ``string`` range loop does — each invalid byte yields one
  U+FFFD replacement rune of width 1 (binary files are therefore mangled,
  exactly as in the reference; huffman.go:306-310).
- Wire layout: ``ASCII header`` + ``\\\n`` (bytes 0x5C 0x0A) + ``pad byte`` +
  ``payload bits`` (huffman.go:255).
- Header: concatenated ``<decimal freq>|<char>`` entries; newline is encoded
  as the two characters ``\n`` (huffman.go:313-317). The reference emits
  entries in Go map iteration order (nondeterministic); we canonicalize to
  ascending rune order — the decoder rebuilds the tree from the frequency
  table, so either order decodes identically on both implementations.
- Pad byte: number of leading pad bits in the payload; 0 when the bit count
  is already byte-aligned (huffman.go:245-249). Payload bits are the
  concatenated codes ('0'=left, '1'=right), packed MSB-first from the tail so
  the pad surfaces as leading zero bits (huffman.go:174-191).
- The code assignment depends on the exact tree shape, which in the reference
  is produced by (a) pairing symbols in ascending (freq, rune) order
  (huffman.go:58-91) and (b) Go's ``container/heap`` pop/push mechanics, whose
  tie-breaking is algorithmic, not value-based. ``_GoTreeHeap`` below
  follows Go's sift-up/sift-down (container/heap ``up``/``down``) step for
  step, so codes match the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np

SEPARATOR = b"\\\n"  # 0x5C 0x0A
RUNE_ERROR = 0xFFFD
MAX_DECODED_SYMBOLS = 900_000  # reference recursion cap (huffman.go:132)


# ---------------------------------------------------------------------------
# Go-exact UTF-8 rune iteration


def go_decode_runes(data: bytes) -> list[int]:
    """Decode bytes to runes exactly like Go's ``for _, c := range string(b)``.

    Invalid UTF-8 yields one U+FFFD per invalid byte (width 1) — this differs
    from Python's ``errors='replace'`` which can merge several bytes into one
    replacement char, so we hand-roll the decoder.
    """
    runes: list[int] = []
    i, n = 0, len(data)
    while i < n:
        b0 = data[i]
        if b0 < 0x80:
            runes.append(b0)
            i += 1
            continue
        if b0 < 0xC2 or b0 > 0xF4:
            runes.append(RUNE_ERROR)
            i += 1
            continue
        if b0 < 0xE0:
            size, lo, hi = 2, 0x80, 0xBF
        elif b0 < 0xF0:
            size = 3
            # Go utf8: E0 requires A0..BF, ED requires 80..9F (no surrogates)
            lo, hi = (0xA0, 0xBF) if b0 == 0xE0 else (0x80, 0x9F) if b0 == 0xED else (0x80, 0xBF)
        else:
            size = 4
            lo, hi = (0x90, 0xBF) if b0 == 0xF0 else (0x80, 0x8F) if b0 == 0xF4 else (0x80, 0xBF)
        if i + 1 >= n or not (lo <= data[i + 1] <= hi):
            runes.append(RUNE_ERROR)
            i += 1
            continue
        ok = True
        for k in range(2, size):
            if i + k >= n or not (0x80 <= data[i + k] <= 0xBF):
                ok = False
                break
        if not ok:
            runes.append(RUNE_ERROR)
            i += 1
            continue
        if size == 2:
            cp = ((b0 & 0x1F) << 6) | (data[i + 1] & 0x3F)
        elif size == 3:
            cp = ((b0 & 0x0F) << 12) | ((data[i + 1] & 0x3F) << 6) | (data[i + 2] & 0x3F)
        else:
            cp = (
                ((b0 & 0x07) << 18)
                | ((data[i + 1] & 0x3F) << 12)
                | ((data[i + 2] & 0x3F) << 6)
                | (data[i + 3] & 0x3F)
            )
        runes.append(cp)
        i += size
    return runes


def rune_to_utf8(cp: int) -> bytes:
    return chr(cp).encode("utf-8")


# ---------------------------------------------------------------------------
# Tree build — Go's buildTree (huffman.go:58) on Go's container/heap


class Leaf:
    __slots__ = ("freq", "value")

    def __init__(self, freq: int, value: int) -> None:
        self.freq = freq
        self.value = value


class Node:
    __slots__ = ("freq", "left", "right")

    def __init__(self, freq: int, left, right) -> None:
        self.freq = freq
        self.left = left
        self.right = right


class _GoTreeHeap:
    """Go container/heap over HuffmanTree items, Less = freq-only.

    Tie behavior is determined entirely by the sift algorithms, replicated
    verbatim from Go's heap.Init/Push/Pop.
    """

    def __init__(self, items) -> None:
        self.h = list(items)
        n = len(self.h)
        for i in range(n // 2 - 1, -1, -1):
            self._down(i, n)

    def _less(self, i: int, j: int) -> bool:
        return self.h[i].freq < self.h[j].freq

    def _up(self, j: int) -> None:
        while True:
            # Go's (j - 1) / 2 truncates toward zero: the root is its own parent and the climb
            # stops there (Python's floor division would compare the root with the last item)
            i = (j - 1) // 2 if j > 0 else 0
            if i == j or not self._less(j, i):
                break
            self.h[i], self.h[j] = self.h[j], self.h[i]
            j = i

    def _down(self, i0: int, n: int) -> None:
        i = i0
        while True:
            j1 = 2 * i + 1
            if j1 >= n:
                break
            j = j1
            j2 = j1 + 1
            if j2 < n and self._less(j2, j1):
                j = j2
            if not self._less(j, i):
                break
            self.h[i], self.h[j] = self.h[j], self.h[i]
            i = j

    def push(self, x) -> None:
        self.h.append(x)
        self._up(len(self.h) - 1)

    def pop(self):
        n = len(self.h) - 1
        self.h[0], self.h[n] = self.h[n], self.h[0]
        self._down(0, n)
        return self.h.pop()

    def __len__(self) -> int:
        return len(self.h)


def build_tree(sym_freqs: dict[int, int]):
    """The reference's buildTree (huffman.go:58): the tree Go builds, leaf for leaf.

    The reference's key/value re-pairing loop is equivalent to ordering the
    leaves by (freq, rune) ascending; the heap then merges as Go's
    container/heap does, its sift-up stopping at the root.
    """
    if not sym_freqs:
        raise ValueError("huffman: empty frequency table")
    ordered = sorted(sym_freqs.items(), key=lambda kv: (kv[1], kv[0]))
    heap = _GoTreeHeap(Leaf(freq, value) for value, freq in ordered)
    while len(heap) > 1:
        a = heap.pop()
        b = heap.pop()
        heap.push(Node(a.freq + b.freq, a, b))
    return heap.pop()


def print_codes(tree) -> tuple[list[int], list[str]]:
    """DFS code assignment, '0'=left / '1'=right (huffman.go:110)."""
    vals: list[int] = []
    bins: list[str] = []

    def walk(t, prefix: str) -> None:
        if isinstance(t, Leaf):
            vals.append(t.value)
            bins.append(prefix)
            return
        walk(t.left, prefix + "0")
        walk(t.right, prefix + "1")

    walk(tree, "")
    return vals, bins


# ---------------------------------------------------------------------------
# Header


def build_header(sym_freqs: dict[int, int], raw: bool = False) -> bytes:
    """Canonical header: entries in ascending rune order (see module doc); with ``raw`` the symbols are
    bytes, each written as itself."""
    parts = []
    for rune in sorted(sym_freqs):
        freq = sym_freqs[rune]
        if rune == 10:
            parts.append(b"%d|\\n" % freq)
        else:
            parts.append(b"%d|" % freq + (bytes([rune]) if raw else rune_to_utf8(rune)))
    return b"".join(parts)


def parse_header(header: bytes) -> dict[int, int]:
    """Exact parity with reference decodeTree's scanner (huffman.go:196).

    Scans bytes; ASCII digits accumulate into the pending frequency; on '|'
    the next rune is the symbol (with ``\n`` two-char special case). All other
    bytes are skipped, which makes the parser order- and junk-tolerant.
    """
    return _scan_header(header)[0]


def read_header(header: bytes) -> tuple[dict[int, int], bool]:
    """(counts, raw): a container block's header. Where a symbol's first byte begins no valid UTF-8
    sequence, which only a byte-coded block writes (module doc), every symbol is the byte after its
    '|' and ``raw`` is True; otherwise ``parse_header``'s runes."""
    sym_freqs, raw = _scan_header(header)
    if not raw:
        return sym_freqs, False
    return _scan_header(header, raw=True)[0], True


def _starts_no_rune(data: bytes) -> bool:
    """Whether ``data`` begins with a byte >= 0x80 that begins no valid UTF-8 sequence."""
    return data[0] >= 0x80 and go_decode_runes(data[:4])[0] == RUNE_ERROR and data[:3] != b"\xef\xbf\xbd"


def _scan_header(header: bytes, raw: bool = False) -> tuple[dict[int, int], bool]:
    """parse_header's scan, its symbols bytes with ``raw``; -> (counts, whether a symbol begins no rune)."""
    sym_freqs: dict[int, int] = {}
    stray = False
    temp = ""
    i, n = 0, len(header)
    while i < n:
        b = header[i]
        if b != 0x7C:  # '|'
            if 0x30 <= b <= 0x39:
                temp += chr(b)
            i += 1
            continue
        freq = int(temp) if temp.strip().isdigit() else 0
        temp = ""
        if i + 2 < n and header[i + 1] == 0x5C and header[i + 2] == 0x6E:  # "\n"
            sym_freqs[10] = freq
            i += 1
        else:
            tail = header[i + 1 : i + 5]
            if not tail:
                raise ValueError("huffman: truncated header")
            stray = stray or _starts_no_rune(tail)
            sym_freqs[tail[0] if raw else go_decode_runes(tail)[0]] = freq
        i += 2  # reference: inner i++ plus loop i++
    return sym_freqs, stray


# ---------------------------------------------------------------------------
# Encode / decode


def compress(data: bytes) -> bytes:
    """Parity with reference huffman.Compress (huffman.go:299), canonical header."""
    runes = go_decode_runes(data)
    if not runes:
        raise ValueError("huffman: cannot compress empty input (reference panics)")
    sym_freqs: dict[int, int] = {}
    for r in runes:
        sym_freqs[r] = sym_freqs.get(r, 0) + 1

    tree = build_tree(sym_freqs)
    vals, bins = print_codes(tree)
    code_of = dict(zip(vals, bins))

    bits = "".join(code_of[r] for r in runes)
    return build_header(sym_freqs) + SEPARATOR + _padded(bits)


def _padded(bits: str) -> bytes:
    """The pad byte, then ``bits`` packed MSB-first behind that many zero bits."""
    rem = len(bits) % 8
    pad = 0 if rem == 0 else 8 - rem
    padded = "0" * pad + bits
    payload = np.packbits(
        np.frombuffer(padded.encode("ascii"), dtype=np.uint8) - ord("0")
    ).tobytes() if padded else b""
    return bytes([pad]) + payload


def go_lossless(data: bytes) -> bool:
    """Whether Go's rune iteration gives ``data`` back: exactly where it is valid UTF-8, whose
    sequences Python's strict decoder accepts as Go's does."""
    try:
        data.decode("utf-8")
    except UnicodeDecodeError:
        return False
    return True


def compress_block(data: bytes) -> bytes:
    """A container block's stream: Go's (``compress``) where Go's rune iteration gives the block back,
    else the block coded over its bytes (module doc)."""
    if go_lossless(data):
        return compress(data)
    counts = np.bincount(np.frombuffer(data, dtype=np.uint8), minlength=256)
    syms = np.nonzero(counts)[0]
    sym_freqs = dict(zip(syms.tolist(), counts[syms].tolist()))
    code_of = [""] * 256
    for value, code in zip(*print_codes(build_tree(sym_freqs))):
        code_of[value] = code
    return build_header(sym_freqs, raw=True) + SEPARATOR + _padded("".join(map(code_of.__getitem__, data)))


def decompress_block(data: bytes) -> bytes:
    """The inverse of ``compress_block``: Go's ``decompress``, or a byte-coded block's bytes."""
    header, sep, rest = data.partition(SEPARATOR)
    sym_freqs, raw = read_header(header) if sep else ({}, False)
    if not raw:
        return decompress(data)
    return bytes(_walk(build_tree(sym_freqs), rest))


def decompress(data: bytes) -> bytes:
    """Parity with reference huffman.Decompress (huffman.go:327)."""
    try:
        header, rest = data.split(SEPARATOR, 1)
    except ValueError:
        raise ValueError("huffman: missing header separator") from None
    sym_freqs = parse_header(header)
    tree = build_tree(sym_freqs)
    return b"".join(rune_to_utf8(r) for r in _walk(tree, rest))


def _walk(tree, rest: bytes) -> list[int]:
    """The symbols of the pad byte and payload ``rest`` walked through ``tree``."""
    if not rest:
        raise ValueError("huffman: missing pad byte")
    pad = rest[0]
    payload = rest[1:]
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))[pad:]

    out_runes: list[int] = []
    if isinstance(tree, Leaf):
        # Single-symbol input assigns a zero-length code, so the payload
        # carries no information and the reference's decoder loops at the
        # root leaf until its 900k recursion cap panics (huffman.go:131-133).
        # Raising beats silently returning truncated data.
        raise ValueError(
            "huffman: single-symbol stream is not decodable "
            "(zero-length code; reference panics here)"
        )

    node = tree
    i, nbits = 0, int(bits.size)
    while True:
        if isinstance(node, Leaf):
            out_runes.append(node.value)
            if len(out_runes) > MAX_DECODED_SYMBOLS:
                raise ValueError("huffman: max decode length exceeded (parity cap)")
            if i < nbits:
                node = tree
                continue
            break
        if i >= nbits:
            raise ValueError("huffman: bitstream ends inside a code")
        node = node.left if bits[i] == 0 else node.right
        i += 1

    return out_runes

