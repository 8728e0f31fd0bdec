"""Requests of Canterbury-shaped text: one input a client, ``bytes`` long.

Each ``block`` of an input is a slice of one text class's source: the
output of one of the corpus's seven text generators (``perfbench/corpus.py``),
``source_bytes`` long and seeded from the seed. Every seed has the same
number of blocks of each class, in an order drawn from the seed.
"""

from __future__ import annotations

import numpy as np

from perfbench import corpus, generate


def text_sources(seed: int, source_bytes: int) -> list[np.ndarray]:
    """One source of ``source_bytes`` a text class, each generator seeded from ``seed``."""
    return [np.frombuffer(gen(source_bytes, generate.sub_seed(seed, 1, k)), dtype=np.uint8)
            for k, gen in enumerate(corpus.TEXT_CLASSES)]


def text_blocks(seed: int, key: int, size: int, block: int, sources: list[np.ndarray]) -> bytes:
    """``size`` bytes of text, each ``block`` a slice of one class's source at an offset drawn from the
    seed."""
    r = generate.rng(seed, 2, key)
    count = -(-size // block)
    kinds = r.permutation(np.arange(count) % len(sources))
    starts = r.integers(0, sources[0].size - block + 1, count)
    out = np.empty(count * block, dtype=np.uint8)
    for i, (k, s) in enumerate(zip(kinds, starts)):
        out[i * block : (i + 1) * block] = sources[k][s : s + block]
    return out[:size].tobytes()


def make(seed: int, requests: dict, clients: int) -> tuple[list[bytes], list[list[int]]]:
    sources = text_sources(seed, requests["source_bytes"])
    items = [text_blocks(seed, c, requests["bytes"], requests["block"], sources) for c in range(clients)]
    return items, [[c] for c in range(clients)]
