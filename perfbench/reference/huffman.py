"""Plain Huffman encoder of the `.rsn` wire format (go-compression/raisin compressor/huffman/huffman.go).

The benchmark's own reference, written from the Go rules and not from the
program: NumPy for the runes, the counts and the bits, plain Python for the
tree. It imports nothing of the program and nothing of the JAX package.

- Symbols are runes, as Go's ``for _, c := range string(b)`` yields them
  (huffman.go:306-310): a valid UTF-8 sequence is its code point, and each
  byte of an invalid one is U+FFFD, width 1. Python's strict UTF-8 decoder
  accepts exactly the sequences Go's does, and ``surrogateescape`` gives
  each byte it rejects one code point of its own, which becomes U+FFFD.
- The tree (``buildTree``, huffman.go:58): the leaves in ascending (count,
  rune) order, which is what Go's key/value re-pairing leaves them in
  (huffman.go:64-87); Go's ``container/heap`` ``Init`` over them, then,
  while more than one tree is left, two ``Pop`` and a ``Push`` of their
  join, the first popped on the left. ``Less`` compares counts only, so
  which of equal counts comes first is decided by the heap's sifts alone,
  as written below from Go's ``up`` and ``down``. ``up`` computes the
  parent with Go's division, which truncates toward zero: at the root the
  parent is the root itself and the climb stops.
- Codes (``printCodes``, huffman.go:110): a walk from the root, ``0`` to the
  left and ``1`` to the right; a lone leaf has the empty code.
- The stream (huffman.go:229-255): the header, ``<count>|<rune>`` a rune
  with a newline written as the two characters ``\\n``; the separator
  ``\\\\\\n`` (0x5C 0x0A); the pad byte, ``8 - bits % 8`` with 8 written as
  0 (huffman.go:245-249); then the codes' bits, most significant first,
  behind that many zero bits.

Two departures. Go writes the header's entries in its map's order, which
changes from run to run; here they are in ascending rune order, the
program's canonical order. The decoder rebuilds the same tree from either.
And where the input is not valid UTF-8, Go's runes lose its stray bytes
(its own stream decodes to other bytes), so such an input is coded over its
bytes instead: the symbols are the bytes, each written into the header as
itself, and the tree, codes and stream follow the same rules. A byte >=
0x80 there is followed by an ASCII byte, so it begins no valid UTF-8
sequence, which Go never writes after a ``|``: a decoder tells the two
kinds apart by that. This is what the deployment guarantees: every input
decodes to itself (an LZSS stream of text with a ``<``, which the LZSS
escape writes as 0xFF, is such an input), and where the input is valid
UTF-8 the stream is Go's.

``max_freq`` below MAX_FREQ is the benchmark's control: each block's counts
are clipped at it before the tree and the header are built, so a block in
which a rune occurs more often gets another header and, often, another
tree.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference.arithmetic import MAX_FREQ

SEPARATOR = b"\\\n"
RUNE_ERROR = 0xFFFD
NEWLINE = 10


def runes(data: bytes) -> np.ndarray:
    """The runes of ``data`` as Go's range over a string yields them, int64."""
    text = data.decode("utf-8", "surrogateescape")
    points = np.frombuffer(text.encode("utf-32-le", "surrogatepass"), dtype="<u4").astype(np.int64)
    return np.where((points >= 0xDC80) & (points <= 0xDCFF), RUNE_ERROR, points)


def _go_parent(j: int) -> int:
    """``(j - 1) / 2`` in Go: integer division truncates toward zero, so the root's parent is 0."""
    q = abs(j - 1) // 2
    return q if j - 1 >= 0 else -q


class GoHeap:
    """Go's ``container/heap`` over trees, ``Less`` comparing their counts (``tree[0]``)."""

    def __init__(self, trees: list) -> None:
        self.h = trees
        n = len(self.h)
        for i in range(n // 2 - 1, -1, -1):
            self.down(i, n)

    def less(self, i: int, j: int) -> bool:
        return self.h[i][0] < self.h[j][0]

    def swap(self, i: int, j: int) -> None:
        self.h[i], self.h[j] = self.h[j], self.h[i]

    def up(self, j: int) -> None:
        while True:
            i = _go_parent(j)
            if i == j or not self.less(j, i):
                break
            self.swap(i, j)
            j = i

    def down(self, i: int, n: int) -> None:
        while True:
            j1 = 2 * i + 1
            if j1 >= n:
                break
            j = j1
            if j1 + 1 < n and self.less(j1 + 1, j1):
                j = j1 + 1
            if not self.less(j, i):
                break
            self.swap(i, j)
            i = j

    def push(self, tree) -> None:
        self.h.append(tree)
        self.up(len(self.h) - 1)

    def pop(self):
        n = len(self.h) - 1
        self.swap(0, n)
        self.down(0, n)
        return self.h.pop()


def codes(symbols: list[int], counts: list[int]) -> dict[int, str]:
    """Each symbol's code in the tree Go builds from these counts.

    A leaf is ``(count, symbol)``, a join ``(count, left, right)``.
    """
    heap = GoHeap(sorted(zip(counts, symbols)))
    while len(heap.h) > 1:
        a = heap.pop()
        b = heap.pop()
        heap.push((a[0] + b[0], a, b))
    out: dict[int, str] = {}
    stack = [(heap.pop(), "")]
    while stack:
        tree, code = stack.pop()
        if len(tree) == 2:
            out[tree[1]] = code
        else:
            stack += [(tree[1], code + "0"), (tree[2], code + "1")]
    return out


def header(symbols: list[int], counts: list[int], raw: bool = False) -> bytes:
    """``<count>|<rune>`` a symbol in the order given, a newline as ``\\n``; with ``raw`` the symbols
    are bytes, each written as itself."""
    return b"".join(b"%d|\\n" % c if s == NEWLINE else b"%d|" % c + (bytes([s]) if raw else chr(s).encode("utf-8"))
                    for s, c in zip(symbols, counts))


def pack(lengths: np.ndarray, values: np.ndarray) -> tuple[int, bytes]:
    """(pad, bytes): the codes (``lengths[k]`` low bits of ``values[k]``) one after another, most
    significant bit first, behind ``pad`` zero bits that fill the last byte. A code past 62 bits would
    overflow ``values``; a tree that deep needs Fib(64) symbols, some 10^13."""
    total = int(lengths.sum())
    pad = (8 - total % 8) % 8
    bits = np.zeros(pad + total, dtype=np.uint8)
    starts = pad + np.cumsum(lengths) - lengths
    for k in range(int(lengths.max(initial=0))):
        has = lengths > k
        bits[starts[has] + k] = (values[has] >> (lengths[has] - 1 - k)) & 1
    return pad, np.packbits(bits).tobytes()


def compress(data: bytes, max_freq: int = MAX_FREQ) -> bytes:
    """The `.rsn` Huffman stream of ``data``, coded over its bytes where it is not valid UTF-8;
    ValueError on empty input, where Go panics."""
    try:
        data.decode("utf-8")
        raw, r = False, runes(data)
    except UnicodeDecodeError:
        raw, r = True, np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    if r.size == 0:
        raise ValueError("huffman: empty input")
    symbols, index, counts = np.unique(r, return_inverse=True, return_counts=True)
    if max_freq < MAX_FREQ:
        counts = np.minimum(counts, max_freq)
    table = codes(symbols.tolist(), counts.tolist())
    code = [table[s] for s in symbols.tolist()]
    lengths = np.array([len(c) for c in code], dtype=np.int64)
    values = np.array([int(c, 2) if c else 0 for c in code], dtype=np.int64)
    pad, payload = pack(lengths[index], values[index])
    return header(symbols.tolist(), counts.tolist(), raw) + SEPARATOR + bytes([pad]) + payload


def compress_many(inputs: list[bytes], window: int, device, max_freq: int = MAX_FREQ) -> list[bytes]:
    """The Huffman stream of each input (``window`` and ``device`` are the pipeline's, unused)."""
    return [compress(b, max_freq) for b in inputs]
