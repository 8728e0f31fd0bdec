"""Requests of uniform random bytes, as files that are already compressed: one input a client,
``bytes`` long."""

from __future__ import annotations

import numpy as np

from perfbench import generate


def make(seed: int, requests: dict, clients: int) -> tuple[list[bytes], list[list[int]]]:
    items = [generate.rng(seed, 3, c).integers(0, 256, requests["bytes"], dtype=np.uint8).tobytes()
             for c in range(clients)]
    return items, [[c] for c in range(clients)]
