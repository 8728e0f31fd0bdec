"""The benchmark's plain reference: the `.rsn` formats written from the Go reference's rules.

Nothing here imports the program (``raisin_tpu_torch``), the JAX package
(``raisin_tpu``) or JAX. A pipeline of layers, ``("lzss", "arithmetic")``
for example, runs each layer's module of this package by its name, in
order: a layer is a module ``perfbench/reference/<layer>.py`` with
``compress_many(inputs, window, device, max_freq)``.
"""

from __future__ import annotations

import importlib
import sys
import time

from perfbench.reference.arithmetic import MAX_FREQ


def compress_pipeline(inputs: list[bytes], algorithms: tuple[str, ...], window: int, device,
                      max_freq: int = MAX_FREQ) -> tuple[list[bytes], list[list[int]]]:
    """-> (each input's stream through every layer, each layer's output length of every input)."""
    lengths = []
    for name in algorithms:
        layer = importlib.import_module(f"perfbench.reference.{name}")
        t = time.perf_counter()
        inputs = layer.compress_many(inputs, window, device, max_freq=max_freq)
        lengths.append([len(b) for b in inputs])
        print(f"perfbench: reference {name} on {len(inputs)} inputs in {time.perf_counter() - t:.3f} s",
              file=sys.stderr, flush=True)
    return inputs, lengths
