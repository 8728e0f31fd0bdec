"""Entry ``stream``: the raw layered `.rsn` stream, what ``raisin f`` writes by default.

Calls ``raisin_tpu_torch.engine.core.compress_bytes(data, algorithms,
window)`` under the auto order, which puts the LZSS and arithmetic layers
on the card (escape, kernels D and E, then kernel I and the event
expansion). Raw streams decode on the host (native C), so the entry
compresses only.

The check compares every stream the run kept, whole, with the
reference's stream of its input.
"""

from __future__ import annotations

from perfbench.reference import compress_pipeline, lzss
from perfbench.reference.arithmetic import CONTROL_MAX_FREQ, MAX_FREQ


class Entry:
    def __init__(self, config: dict, device):
        from raisin_tpu_torch.engine.core import compress_bytes

        self.algorithms = tuple(config["algorithms"])
        self.window = config["window"]

        def compress(data: bytes) -> bytes:
            return compress_bytes(data, self.algorithms, window=self.window, device=device)

        self.directions = {"compress": compress}

    @staticmethod
    def phase_input(direction: str, item: int, items: list[bytes], made: dict[int, bytes]) -> bytes:
        return items[item]

    def check(self, traffic, kept: dict[str, list[tuple[int, bytes]]], device,
              control: bool = False) -> tuple[dict[str, tuple[float, float]], dict[int, dict]]:
        """-> ({number: (value, limit)}, the stats of every input the metrics read). With ``control``
        the control's streams (the model's counts one bit narrower) stand in the program's place."""
        streams = kept.get("compress", [])
        items = sorted({i for i, _ in streams})
        data = [traffic.items[i] for i in items]
        want, lengths = compress_pipeline(data, self.algorithms, self.window, device, MAX_FREQ)
        expected = dict(zip(items, want))
        if control:
            low = dict(zip(items, compress_pipeline(data, self.algorithms, self.window, device, CONTROL_MAX_FREQ)[0]))
            streams = [(i, low[i]) for i, _ in streams]
        numbers = {"streams_differing": (sum(out != expected[i] for i, out in streams), 0)}
        stats = {i: {"bytes": len(d), "escaped": lzss.escaped_length(d), "lzss": lengths[0][k],
                     "stream": len(want[k])} for k, (i, d) in enumerate(zip(items, data))}
        return numbers, stats
