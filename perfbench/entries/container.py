"""Entry ``container``: the RSNB block container on one card, ``raisin -container`` and its decode.

Calls ``raisin_tpu_torch.parallel.blocks.compress_container(data,
algorithms, block_size, window=window)`` and ``decompress_container``.
The decompress phase decodes the first container that the compress phase
made of each input.

The check, against the benchmark's own reference:

- every kept container's framing: magic, version, pipeline, block size,
  window, input size, block count, aux tables, and a length that its
  size table accounts for;
- in every kept container, its own sample of SAMPLED_BLOCKS blocks drawn
  from the seed and the container's place among those kept, with the
  first and last block always among them: each one's payload size, aux
  entry (the block's LZSS stream length) and payload bytes against the
  reference's stream of that block (escape, kernels D and E, A and B);
- every kept restored output against its input (kernels C and F, the
  unescape and the framing).
"""

from __future__ import annotations

import struct

from perfbench import generate
from perfbench.reference import compress_pipeline, rsnb
from perfbench.reference.arithmetic import CONTROL_MAX_FREQ, MAX_FREQ

SAMPLED_BLOCKS = 24  # blocks drawn a kept container, besides its first and last


class Entry:
    def __init__(self, config: dict, device):
        from raisin_tpu_torch.parallel import blocks

        self.algorithms = tuple(config["algorithms"])
        self.block_size = config["block_size"]
        self.window = config["window"]
        self.aux_tables = config["aux_tables"]

        def compress(data: bytes) -> bytes:
            return blocks.compress_container(data, self.algorithms, self.block_size, window=self.window,
                                             device=device)

        def decompress(blob: bytes) -> bytes:
            return blocks.decompress_container(blob, device=device)

        self.directions = {"compress": compress, "decompress": decompress}

    @staticmethod
    def phase_input(direction: str, item: int, items: list[bytes], made: dict[int, bytes]) -> bytes:
        return items[item] if direction == "compress" else made[item]

    def sampled_blocks(self, traffic, item: int, kept: int) -> list[int]:
        """The blocks compared in the ``kept``-th kept container, an answer for ``item``."""
        count = max(1, -(-len(traffic.items[item]) // self.block_size))
        drawn = generate.rng(traffic.seed, 7, item, kept).choice(count, size=min(count, SAMPLED_BLOCKS),
                                                                  replace=False).tolist()
        return sorted({0, count - 1, *drawn})

    def expected(self, traffic, samples: list[tuple[int, list[int]]], device, max_freq: int) -> dict:
        """The reference's stream and LZSS length of every sampled (item, block)."""
        keys = sorted({(i, b) for i, blocks in samples for b in blocks})
        data = [traffic.items[i][b * self.block_size : (b + 1) * self.block_size] for i, b in keys]
        streams, lengths = compress_pipeline(data, self.algorithms, self.window, device, max_freq)
        return {key: (s, lengths[0][k]) for k, (key, s) in enumerate(zip(keys, streams))}

    def framing_wrong(self, blob: bytes, size: int) -> int:
        """Fields of the container's framing that differ from what its input calls for."""
        try:
            f = rsnb.parse(blob)
        except (ValueError, IndexError, struct.error) as e:
            print(f"container framing unreadable: {e}")
            return 1
        want = {"version": rsnb.VERSION, "algorithms": self.algorithms, "block_size": self.block_size,
                "window": self.window, "orig_size": size, "num_blocks": max(1, -(-size // self.block_size)),
                "length": int(f["offsets"][-1])}
        got = {k: f[k] for k in want}
        got["aux"] = len(f["aux"])
        want["aux"] = self.aux_tables
        return sum(got[k] != want[k] for k in want)

    def blocks_wrong(self, blob: bytes, item: int, sampled: list[int], expected: dict) -> int:
        try:
            f = rsnb.parse(blob)
        except (ValueError, IndexError, struct.error):
            return len(sampled)
        wrong = 0
        for b in sampled:
            stream, tokens = expected[(item, b)]
            if b >= f["num_blocks"] or (self.aux_tables and (not f["aux"] or int(f["aux"][0][b]) != tokens)):
                wrong += 1
            elif int(f["sizes"][b]) != len(stream) or rsnb.payload(blob, f, b) != stream:
                wrong += 1
        return wrong

    def check(self, traffic, kept: dict[str, list[tuple[int, bytes]]], device,
              control: bool = False) -> tuple[dict[str, tuple[float, float]], dict[int, dict]]:
        """-> ({number: (value, limit)}, the stats of every input the metrics read). With ``control``
        the control's answers stand in the program's place."""
        containers = kept.get("compress", [])
        samples = [(i, self.sampled_blocks(traffic, i, k)) for k, (i, _) in enumerate(containers)]
        expected = self.expected(traffic, samples, device, MAX_FREQ)
        stats = self.item_stats(traffic, containers)
        if control:
            containers = self.control_answers(traffic, containers, samples, device)
        numbers = {
            "framing_fields_differing": (sum(self.framing_wrong(b, len(traffic.items[i])) for i, b in containers), 0),
            "sampled_blocks_differing": (sum(self.blocks_wrong(b, i, sampled, expected)
                                             for (i, b), (_, sampled) in zip(containers, samples)), 0),
            "restored_differing": (sum(out != traffic.items[i] for i, out in kept.get("decompress", [])), 0),
        }
        return numbers, stats

    def control_answers(self, traffic, containers, samples, device) -> list[tuple[int, bytes]]:
        """The control in the program's place: each container's sampled blocks as the reference codes
        them with the model's counts one bit narrower (max_freq 8191), framed as the container frames
        them; the check reads nothing else of a container."""
        low = self.expected(traffic, samples, device, CONTROL_MAX_FREQ)
        out = []
        for (item, blob), (_, sampled) in zip(containers, samples):
            f = rsnb.parse(blob)
            sizes = f["sizes"].copy()
            aux = [a.copy() for a in f["aux"]]
            payloads = [rsnb.payload(blob, f, b) for b in range(f["num_blocks"])]
            for b in sampled:
                payloads[b], tokens = low[(item, b)]
                sizes[b] = len(payloads[b])
                if aux:
                    aux[0][b] = tokens
            head = rsnb.header(f["algorithms"], f["block_size"], f["window"], f["orig_size"], sizes.tolist(),
                               [a.tolist() for a in aux])
            out.append((item, head + b"".join(payloads)))
        return out

    @staticmethod
    def item_stats(traffic, containers) -> dict[int, dict]:
        """Each input's sizes, and of its first kept container the payload bytes, token bytes and blocks."""
        from perfbench.reference import lzss

        stats = {}
        for item, blob in containers:
            if item in stats:
                continue
            s = {"bytes": len(traffic.items[item]), "escaped": lzss.escaped_length(traffic.items[item])}
            try:
                f = rsnb.parse(blob)
                s.update(blocks=int(f["num_blocks"]), payload=int(f["sizes"].sum()),
                         tokens=int(f["aux"][0].sum()) if f["aux"] else None)
            except (ValueError, IndexError, struct.error):
                pass
            stats[item] = s
        return stats
