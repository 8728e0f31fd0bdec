"""Kernel G with parts of it taken away, on the card: what each part costs.

    python3 tests/cuda_host/variants_huffman_encode.py   # from the repository root, on a CUDA machine

Builds copies of ``raisin_tpu_torch/csrc/huffman_encode.cu`` with nvcc into
``raisin_tpu_torch/_build/variants/``: the kernel as it is; with blockIdx in
place of the atomic ticket; with every tile's prefix given (the probe
computes the exclusive sums of the tiles' bit counts with torch and the
kernel reads them; no look-back, no status words published); and with the
tile's sums alone (loads, tables, lookups and scan, then the CTA stores its
bit count and returns). Each runs on three of chip_smoke.py's
``HENCODE_INPUTS`` (the lzss,huffman container's token rows, the 1 MiB
huffman stream and the 64 MiB corpus as one block). It prints the ms of a
launch (CUDA events over 20, less the same count of the launch's zero fills
alone) and whether its outputs equal the wrapper's (the sums alone write
none). The variants with blockIdx rely on CTAs starting in index order,
which the kernel itself does not assume.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TICKET = "    if (tid == 0) tile_id = (int)atomicAdd(ticket, 1u);\n"
BY_INDEX = "    if (tid == 0) tile_id = blockIdx.x;\n"
SCAN_END = "        tile_bits += s;\n    }\n"
INPUTS = ("lzss,huffman container", "huffman stream", "corpus stream")


def _replace(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


def variants(src: str) -> dict[str, tuple[str, str]]:
    """Variant name -> (source, what the status words hold before the launch)."""
    look = src[src.index("    if (warp == 0) {\n        unsigned long long* block_status"):
               src.index("    // the thread's codes into the image")]
    given = re.sub(r"if \(lane == 0\) publish\([^;]*;", "", look)
    given = _replace(given, "prefix = look_back(block_status, t, lane);", "prefix = (long long)block_status[t];")
    return {
        "as it is": (src, "zeros"),
        "blockIdx, no ticket": (_replace(src, TICKET, BY_INDEX), "zeros"),
        "prefixes given, no look-back": (_replace(_replace(src, look, given), TICKET, BY_INDEX), "prefixes"),
        "tile sums alone": (_replace(_replace(src, SCAN_END, SCAN_END + "    if (tid == 0) status[(size_t)b * tiles + t]"
                                              " = tile_bits;\n    return;\n"), TICKET, BY_INDEX), "zeros"),
    }


def main() -> int:
    import torch

    import bench
    import chip_smoke
    from raisin_tpu_torch.ops import _build, huffman_rows
    from raisin_tpu_torch.ops.device import require_cuda

    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    data = bench.make_corpus(chip_smoke.MAIN_BYTES)
    inputs = {}
    for name in INPUTS:
        args, bits, _ = chip_smoke.huffman_encode_args(*chip_smoke.huffman_input(name, data, dev))
        inputs[name] = (args, bits, huffman_rows.encode_rows(*args, bits=bits))
    for k, (label, (src, status)) in enumerate(variants((_build.CSRC / "huffman_encode.cu").read_text()).items()):
        cu, so = out_dir / f"variant{k}.cu", out_dir / f"variant{k}.so"
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
        lib = ctypes.CDLL(str(so))
        lib.rsn_huffman_encode.argtypes = _build.SIGNATURES["rsn_huffman_encode"]
        line = {}
        for name, ((x, n, codes, lens, capw), bits, want) in inputs.items():
            B, S = x.shape
            tiles = huffman_rows.tiles(S)
            rows = torch.empty((B, 4 * capw), dtype=torch.uint8, device=dev)
            bl, pads = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(2))
            totals = torch.empty(B, dtype=torch.int64, device=dev)
            work = torch.empty(B * tiles + 1, dtype=torch.int64, device=dev)
            start = torch.zeros_like(work)
            if status == "prefixes":
                live = torch.arange(S, device=dev)[None] < n[:, None]
                L = torch.where(live & (x < 128), lens.long().gather(1, x.long().clamp(max=127)), 0)
                sums = torch.nn.functional.pad(L, (0, tiles * huffman_rows.TILE - S)).view(B, tiles, -1).sum(-1)
                start[: B * tiles] = (sums.cumsum(1) - sums).reshape(-1)

            def fills():
                rows.zero_()
                work.copy_(start)

            def run():
                fills()
                rc = lib.rsn_huffman_encode(x.data_ptr(), n.data_ptr(), codes.data_ptr(), lens.data_ptr(),
                                            bits.data_ptr(), rows.data_ptr(), bl.data_ptr(), pads.data_ptr(),
                                            totals.data_ptr(), work.data_ptr(), B, S, capw,
                                            torch.cuda.current_stream(dev).cuda_stream)
                chip_smoke.check(rc == 0, f"launch failed ({rc})")

            run()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip((rows, bl, pads), want)) and torch.equal(totals, bits)
            ms = chip_smoke.cuda_ms(run, 20) - chip_smoke.cuda_ms(fills, 20)
            line[name] = {"ms": round(ms, 4), "outputs equal": equal if label != "tile sums alone" else None}
        print(f"{label}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
