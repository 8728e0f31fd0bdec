"""Plain LZSS encoder of the `.rsn` wire format (go-compression/raisin compressor/lz/lzss.go).

The benchmark's own reference, written from the format and not from the
program: plain PyTorch for the match search (on whatever device its input
lies on), NumPy for the escape pass and plain Python for the greedy
commit. It imports nothing of the program and nothing of the JAX package.

- Escape pre-pass (lzss.go:369): ``<`` (0x3C) -> 0xFF, 0xFF -> 0x5C 0xFF,
  0x5C -> 0x5C 0x5C.
- Match at position i (lzss.go:119-130): the longest L such that the L
  bytes at i occur wholly inside the trailing ``window`` bytes before i
  (so L <= D), with D = i - s for the leftmost such occurrence s
  (``bytes.Index``), i.e. the largest distance that reaches L.
- Commit (lzss.go:134-151): walk the positions in order; a match emits
  ``<D,L>`` when that text is shorter than L, else its L bytes raw, and
  consumes L positions; no match emits the byte.

The search tries every distance d in 1..window at every position at once:
the run of equal bytes at distance d, capped at d, is a match of that
length there. Many streams share one flat tensor, each a segment that no
match may cross.
"""

from __future__ import annotations

import numpy as np
import torch

OPENING, ENCODED_OPENING, ESCAPE = 0x3C, 0xFF, 0x5C
CHUNK = 1024  # the row length of the search's scans


def escape(data: bytes) -> bytes:
    """The escape pre-pass (lzss.go:369)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    grows = (arr == ENCODED_OPENING) | (arr == ESCAPE)
    starts = np.arange(arr.size) + np.cumsum(grows) - grows
    out = np.empty(arr.size + int(grows.sum()), dtype=np.uint8)
    out[starts + grows] = np.where(arr == OPENING, np.uint8(ENCODED_OPENING), arr)
    out[starts[grows]] = ESCAPE
    return out.tobytes()


def escaped_length(data: bytes) -> int:
    """Bytes after the escape pass: one more for every 0xFF and 0x5C."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return arr.size + int(np.count_nonzero((arr == ENCODED_OPENING) | (arr == ESCAPE)))


def runs_ending(same: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """For each k, the count of consecutive True in ``same`` (1-d) that ends at k.

    ``idx`` is ``arange`` over ``same`` viewed as rows of CHUNK, the length
    a multiple of CHUNK. The scan runs within each row, then carries each
    row's last False over to the next rows: a scan along one long row
    would run in one thread block.
    """
    rows = idx.shape[0]
    last = torch.where(same.view(rows, CHUNK), -1, idx).cummax(1).values
    before = torch.cat([last.new_full((1,), -1), last[:-1, -1].cummax(0).values])
    return (idx - torch.maximum(last, before[:, None])).view(-1)


def longest_matches(streams: list[bytes], window: int, device) -> list[tuple[list[int], list[int]]]:
    """Each escaped stream's (L, D) at every position, as lists; (0, 0) where nothing matches.

    Works in reversed order, where the run of equal bytes that starts at a
    position is a run that ends there, so one forward scan a distance finds
    it.
    """
    lengths = [len(s) for s in streams]
    total = sum(lengths)
    if total == 0:
        return [([], []) for _ in streams]
    size = -(-total // CHUNK) * CHUNK  # past the streams: a pad that matches nothing
    flat = np.zeros(size, dtype=np.uint8)
    flat[:total] = np.frombuffer(b"".join(streams), dtype=np.uint8)[::-1]
    x = torch.from_numpy(flat).to(device)
    # a position's index within its own stream, in the reversed layout (-1 in the pad)
    within = np.full(size, -1, dtype=np.int32)
    within[:total] = np.concatenate([np.arange(n, dtype=np.int32) for n in lengths])[::-1]
    pos = torch.from_numpy(within).to(device)
    idx = torch.arange(size, dtype=torch.int32, device=device).view(-1, CHUNK)
    best_l = torch.zeros(size, dtype=torch.int32, device=device)
    best_d = torch.zeros(size, dtype=torch.int32, device=device)
    same = torch.zeros(size, dtype=torch.bool, device=device)
    for d in range(1, min(window, max(lengths) - 1) + 1):
        # reversed index k holds original position i; its source i - d lies at k + d
        torch.eq(x[: size - d], x[d:], out=same[: size - d])
        same[size - d :] = False
        same &= pos >= d  # the source lies in the same stream
        run = runs_ending(same, idx).clamp_(max=d)
        better = (run > 0) & (run >= best_l)  # ties go to the larger distance: the leftmost source
        best_l = torch.where(better, run, best_l)
        best_d.masked_fill_(better, d)
    best_l = best_l[:total].flip(0).cpu().numpy()
    best_d = best_d[:total].flip(0).cpu().numpy()
    out, at = [], 0
    for n in lengths:
        out.append((best_l[at : at + n].tolist(), best_d[at : at + n].tolist()))
        at += n
    return out


def commit(enc: bytes, L: list[int], D: list[int]) -> bytes:
    """The greedy commit over per-position matches (lzss.go:134-151)."""
    out = bytearray()
    i, n = 0, len(enc)
    while i < n:
        length = L[i]
        if length == 0:
            out.append(enc[i])
            i += 1
            continue
        token = b"<%d,%d>" % (D[i], length)
        out += token if len(token) < length else enc[i : i + length]
        i += length
    return bytes(out)


def compress_many(inputs: list[bytes], window: int, device, max_freq: int = 0) -> list[bytes]:
    """The LZSS stream of each input, the searches of all in one pass (``max_freq`` is the arithmetic
    layer's, unused)."""
    escaped = [escape(b) for b in inputs]
    matches = longest_matches(escaped, window, device)
    return [commit(enc, L, D) for enc, (L, D) in zip(escaped, matches)]
