"""Requests of the corpus's 11 Canterbury-shaped files (``perfbench/corpus.py``) at ``scale`` of their
sizes, in ``corpus.SPEC``'s order, each generator seeded from the seed; every client sends all 11."""

from __future__ import annotations

from perfbench import corpus, generate


def make(seed: int, requests: dict, clients: int) -> tuple[list[bytes], list[list[int]]]:
    items = [gen(max(1024, int(size * requests["scale"])), generate.sub_seed(seed, 4, k))
             for k, (_, gen, size, _) in enumerate(corpus.SPEC)]
    return items, [list(range(len(items)))] * clients
