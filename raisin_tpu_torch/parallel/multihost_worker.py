"""One process of a multi-process container encode: the counterpart of scripts/multihost_worker.py.

    python -m raisin_tpu_torch.parallel.multihost_worker INPUT OUTDIR \\
        [--rank R --world N --coordinator ADDRESS] [--device D] [--backend B] \\
        [--block-size 8192] [--window 2048]

``ADDRESS`` is "host:port" or a URL (``file:///path`` on one host), as
``multihost.initialize`` takes it. Without ``--rank``, ``--world`` and
``--coordinator`` the process joins through ``env://``, as ``torchrun``
starts it. Each process joins the group
(``multihost.initialize``; ``--device`` defaults to ``cuda:LOCAL_RANK``),
proves the collective path with an ``all_reduce(SUM)`` of
``arange(4) + 10 * rank`` on its device (the JAX worker's ``psum``),
encodes its ``process_block_range`` of INPUT into the default
``lzss,arithmetic`` container's payloads on its device and writes its
ordered segment: ``OUTDIR/seg<rank>.bin`` holds the payloads,
``OUTDIR/seg<rank>.json`` their sizes, the aux table's entries, the block
range and the sum. :func:`load_segments` reads them back in rank order
for ``parallel.blocks.assemble_container``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from raisin_tpu_torch.parallel import blocks, multihost


def encode_segment(data: bytes, lo: int, hi: int, block_size: int, window: int,
                   device) -> tuple[list[bytes], list[int]]:
    """Blocks [lo, hi) of ``data`` -> (their lzss,arithmetic payloads, their aux entries), as one
    container holds them."""
    part = blocks.compress_container(data[lo * block_size : hi * block_size], blocks.LZ_ARITH, block_size,
                                     window=window, device=device)
    _, _, _, payloads, aux, _ = blocks.parse_container(part)
    return payloads, aux[0] if aux else []


def load_segments(outdir: str, world: int) -> tuple[list[dict], list[bytes], list[int]]:
    """The segments of ranks 0 .. world - 1 -> (their records, the payloads and aux entries in rank order)."""
    records, payloads, aux = [], [], []
    for rank in range(world):
        with open(os.path.join(outdir, f"seg{rank}.json")) as f:
            rec = json.load(f)
        with open(os.path.join(outdir, f"seg{rank}.bin"), "rb") as f:
            body = f.read()
        records.append(rec)
        payloads += blocks._split(body, rec["sizes"])
        aux += rec["aux"]
    return records, payloads, aux


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raisin_tpu_torch.parallel.multihost_worker")
    ap.add_argument("input")
    ap.add_argument("outdir")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--coordinator")
    ap.add_argument("--device")
    ap.add_argument("--backend")
    ap.add_argument("--block-size", type=int, default=8192)
    ap.add_argument("--window", type=int, default=2048)
    args = ap.parse_args(argv)

    dev = multihost.initialize(args.coordinator, args.world, args.rank, backend=args.backend, device=args.device)
    try:
        rank = dist.get_rank()
        total = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
        dist.all_reduce(total, dist.ReduceOp.SUM)
        with open(args.input, "rb") as f:
            data = f.read()
        nblocks = max(1, -(-len(data) // args.block_size))
        lo, hi = multihost.process_block_range(nblocks)
        print(f"[worker {rank}] owns blocks [{lo}, {hi}) of {nblocks} on {dev}", flush=True)
        payloads, aux = encode_segment(data, lo, hi, args.block_size, args.window, dev) if hi > lo else ([], [])
        with open(os.path.join(args.outdir, f"seg{rank}.bin"), "wb") as f:
            f.write(b"".join(payloads))
        with open(os.path.join(args.outdir, f"seg{rank}.json"), "w") as f:
            json.dump({"range": [lo, hi], "nblocks": nblocks, "sizes": [len(p) for p in payloads], "aux": aux,
                       "sum": total.cpu().tolist(), "block_size": args.block_size, "window": args.window,
                       "orig_size": len(data), "device": str(dev)}, f)
        print(f"[worker {rank}] done", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
