"""LZSS match search: the port of raisin_tpu/ops/lzss_jax.py:find_matches_blocks.

:func:`find_matches` gives, for every position i of every escaped block,
the greedy longest match of the reference encoder (lzss.go:119-130, oracle
raisin_tpu/formats/lzss_ref.py:find_matches):

- L[i] is the longest run ``x[i:i+L] == x[i-D:i-D+L]`` over distances
  D in 1..window with ``i - D >= 0``, capped so that ``L <= D`` (the match
  lies wholly before i);
- D[i] is the largest distance that reaches L (the leftmost occurrence,
  bytes.Index semantics);
- positions with no match, and positions at or past ``lengths[b]``, get
  (0, 0); runs stop at ``lengths[b]``.

The plain version :func:`_find_matches_torch` loops over distances and,
for all positions at once, takes the forward run from a reverse cumulative
minimum of the next mismatch, then ``min(run, d)``, and picks the best
distance with a max over the packed key ``(c << 16) | d``, so distances
and lengths up to 65535 fit; the JAX package packs 14 bits and caps the
window at 8191.

Kernel D (csrc/lzss_match.cu) gives the same function with two paths in
one launch of one CTA per tile of positions:

- windows up to 8191 (``CHAIN_MAX_WINDOW`` in the kernel): tiles of 16384
  positions, each with its bytes from ``window`` before to ``window``
  after it in shared memory. A tile first takes the **chain path**: the earlier
  positions sharing a position's 2-gram (a hash chain, checked byte by
  byte) are its only candidates with L >= 2; without one, L = 1 at the
  earliest occurrence of the byte in the window, or (0, 0). If any
  position of the tile needs more than 1024 chain and compare steps, the
  whole tile takes the **sweep path** instead: the capped-run recurrence
  ``c[i] = eq(i) ? min(c[i+1] + 1, d) : 0`` over every distance, walked
  down from ``window`` positions above the tile (exact, since
  ``c <= d <= window``);
- wider windows: the sweep path, one tile per block.

With a distance sub-range (d_lo, d_hi], the kernel searches it alone:
the tiles' spans reach ``d_hi`` back, the chain walk passes over
candidates nearer than ``d_lo + 1`` (each still a step of the budget),
the one-byte rule looks for the earliest occurrence at distances in the
range, and the sweep runs the recurrence over ``d_lo + 1 .. d_hi``. So
the far half of a window costs about what the whole window does: its
walks still go through the near candidates.

The wrapper reads back how many tiles took each path, into
``find_matches.chain_tiles`` and ``find_matches.sweep_tiles`` beside
``find_matches.launches`` (a tile wholly past its block's length counts in
neither). Reading them synchronises the host with the card once a launch.
"""

from __future__ import annotations

import torch

from raisin_tpu_torch.ops import _build
from raisin_tpu_torch.ops.arithmetic_rows import _check_cuda

MAX_WINDOW = 65535  # the packed key holds d and the capped run in 16 bits each


def check_window(window: int) -> None:
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(
            f"LZSS window {window} outside 1..{MAX_WINDOW}; larger windows come with "
            f"ROADMAP Queue 1 item 16 (windows past 65535)"
        )


def _check_range(window: int, d_lo: int, d_hi: int | None) -> int:
    """Check the distance sub-range (d_lo, d_hi] of ``window``; -> d_hi (``window`` for None)."""
    check_window(window)
    d_hi = window if d_hi is None else d_hi
    if not 0 <= d_lo < d_hi <= window:
        raise ValueError(f"distance range ({d_lo}, {d_hi}] outside 0 <= d_lo < d_hi <= window = {window}")
    return d_hi


def _find_matches_torch(x: torch.Tensor, lengths: torch.Tensor, window: int, d_lo: int = 0, d_hi: int | None = None):
    """Plain version of kernel D over distances (d_lo, d_hi]: (L, D), each (B, S) int32."""
    d_hi = window if d_hi is None else d_hi
    B, S = x.shape
    dev = x.device
    n = lengths.to(torch.int64)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    best = torch.zeros((B, S), dtype=torch.int64, device=dev)
    for d in range(d_lo + 1, min(d_hi, S - 1) + 1):
        # eq at positions i in [d, S): x[i] == x[i - d] and i < n
        j = pos[: S - d]  # i - d
        eq = (x[:, d:] == x[:, :-d]) & (pos[None, d:] < n[:, None])
        # forward run: distance to the next mismatch (S - d past the end)
        miss = torch.where(eq, S - d, j[None, :])
        run = miss.flip(1).cummin(1).values.flip(1) - j[None, :]
        c = run.clamp(max=d).to(torch.int64)
        key = torch.where(c > 0, (c << 16) | d, 0)
        best[:, d:] = torch.maximum(best[:, d:], key)
    return (best >> 16).to(torch.int32), (best & 0xFFFF).to(torch.int32)


def find_matches(x: torch.Tensor, lengths: torch.Tensor, window: int, d_lo: int = 0, d_hi: int | None = None):
    """Per-position greedy longest match (kernel D, or its plain version).

    Args:
      x: (B, S) uint8 escaped block bytes (what lies past ``lengths`` is
        ignored).
      lengths: (B,) int32, each <= S.
      window: search window, 1..65535.
      d_lo, d_hi: search only the distances in (d_lo, d_hi], with
        0 <= d_lo < d_hi <= window (``d_hi=None``: the window). This is the
        JAX package's ``_match_scan(xb, n, window, wl=d_hi - d_lo, d0=d_lo)``,
        one rank's shard of the tensor-parallel search
        (``parallel/lzss_sharded.py``).

    Returns (L, D): (B, S) int32 each; (0, 0) where no distance of the
    range matches.
    """
    d_hi = _check_range(window, d_lo, d_hi)
    if x.device.type == "cpu":
        return _find_matches_torch(x, lengths, window, d_lo, d_hi)
    B, S = _check_cuda("find_matches", x, torch.uint8, 2)
    _check_cuda("find_matches", lengths, torch.int32, 1, (B,), x.device)
    dev = x.device
    L = torch.empty((B, S), dtype=torch.int32, device=dev)
    D = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B == 0 or S == 0:
        return L, D
    counts = torch.zeros(2, dtype=torch.int32, device=dev)  # tiles by path: chain, sweep
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.count(find_matches)
        rc = lib.rsn_lzss_match(
            x.data_ptr(), lengths.data_ptr(), L.data_ptr(), D.data_ptr(), counts.data_ptr(),
            B, S, d_lo, d_hi, _build.stream_handle(dev),
        )
    _build.check("rsn_lzss_match", rc)
    chain, sweep = counts.tolist()
    _build.count(find_matches, "chain_tiles", chain)
    _build.count(find_matches, "sweep_tiles", sweep)
    return L, D


find_matches.launches = 0
find_matches.chain_tiles = 0
find_matches.sweep_tiles = 0
