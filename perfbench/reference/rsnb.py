"""The RSNB block container's framing, as the benchmark's reference reads and writes it.

Layout (little-endian): magic "RSNB" | version u8 (2) | algo_len u8 |
algo CSV | block_size u32 | window u32 | orig_size u64 | num_blocks u32 |
num_aux u8 | num_blocks x u32 payload sizes | num_aux x (num_blocks x
u32) per-block token lengths | the payloads, in block order. An
``lzss,arithmetic`` container at a window up to 8191 carries one aux
table, the LZSS stream's length of every block; every block's payload is
the block's own `.rsn` stream through the pipeline.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"RSNB"
VERSION = 2
AUX_MAX_WINDOW = 8191


def header(algorithms: tuple[str, ...], block_size: int, window: int, orig_size: int,
           sizes: list[int], aux: list[list[int]]) -> bytes:
    """Everything of a container before its payloads."""
    algo = ",".join(algorithms).encode("ascii")
    head = MAGIC + struct.pack("<BB", VERSION, len(algo)) + algo
    head += struct.pack("<IIQIB", block_size, window, orig_size, len(sizes), len(aux))
    return head + b"".join(np.asarray(t, dtype="<u4").tobytes() for t in (sizes, *aux))


def parse(blob: bytes) -> dict:
    """The container's fields; ValueError where the framing does not hold together."""
    if len(blob) < 6 or blob[:4] != MAGIC:
        raise ValueError("no RSNB magic")
    version, algo_len = struct.unpack_from("<BB", blob, 4)
    pos = 6 + algo_len
    algorithms = tuple(blob[6:pos].decode("ascii", "replace").split(","))
    block_size, window, orig_size, num_blocks, num_aux = struct.unpack_from("<IIQIB", blob, pos)
    pos += 21
    tables = np.frombuffer(blob, dtype="<u4", count=num_blocks * (1 + num_aux), offset=pos)
    pos += tables.nbytes
    sizes = tables[:num_blocks].astype(np.int64)
    aux = [tables[num_blocks * (1 + k) : num_blocks * (2 + k)].astype(np.int64) for k in range(num_aux)]
    offsets = pos + np.concatenate([[0], np.cumsum(sizes)])
    return {"version": version, "algorithms": algorithms, "block_size": block_size, "window": window,
            "orig_size": orig_size, "num_blocks": num_blocks, "sizes": sizes, "aux": aux, "offsets": offsets,
            "length": len(blob)}


def payload(blob: bytes, fields: dict, block: int) -> bytes:
    """Block ``block``'s payload bytes."""
    return blob[int(fields["offsets"][block]) : int(fields["offsets"][block + 1])]
