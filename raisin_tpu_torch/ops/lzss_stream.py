"""Single-stream LZSS on the card: the port of raisin_tpu/ops/lzss_jax.py:compress (:323) and decompress (:338).

The ``device`` backend of ``lzss`` (``engine/registry.py``). :func:`compress`
is one block of the container's own stages: the escape layer
(:func:`escape.escape_blocks`, plain PyTorch on the card), kernel D (the
match search, :func:`lzss_match.find_matches`) and kernel E (the greedy
commit and token emission, :func:`lzss_commit.commit_tokens`). Windows run
up to 65535, where the JAX package's device search stops at 8191.
:func:`decompress` is the port's copy of the host oracle, as in the JAX
package.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from raisin_tpu_torch.formats import lzss
from raisin_tpu_torch.ops import escape, lzss_commit, lzss_match
from raisin_tpu_torch.ops.device import d2h, h2d, resolve_device


def compress(data: bytes, window: int = lzss.DEFAULT_WINDOW_SIZE, device: torch.device | str | None = None) -> bytes:
    """Exact `.rsn` LZSS encode with the match search and the commit on ``device``.

    ValueError for a window outside 1..65535 (ROADMAP Queue 1 item 16).
    """
    lzss_match.check_window(window)
    dev = resolve_device(device)
    if not data:
        return b""
    with record_function("stream.enc.h2d"):
        x = h2d(data, dev)[None]
        n = torch.tensor([len(data)], dtype=torch.int32, device=dev)
    with record_function("stream.enc.escape"):
        xe, en = escape.escape_blocks(x, n)
    with record_function("stream.enc.match"):
        L, D = lzss_match.find_matches(xe, en, window)
    with record_function("stream.enc.commit"):
        tok, tok_len = lzss_commit.commit_tokens(xe, L, D, en)
    with record_function("stream.enc.d2h"):
        return d2h(tok[0, : int(tok_len[0])])


def decompress(data: bytes, device: torch.device | str | None = None) -> bytes:
    """LZSS decode of a raw stream: the port's copy of the host oracle.

    The decode runs on the host, as in the JAX package, so it needs no card;
    ``device`` is taken for the registry's common signature and not read.
    """
    return lzss.decompress(data)
