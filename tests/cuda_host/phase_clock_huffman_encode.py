"""Kernel G's time by phase, on the card: clock64 marks in a copy of its source.

    python3 tests/cuda_host/phase_clock_huffman_encode.py   # from the repository root, on a CUDA machine

Copies ``raisin_tpu_torch/csrc/huffman_encode.cu`` with marks that thread 0
of each CTA reads between the kernel's phases (the ticket; the symbols'
loads with the tables; the lookups and the tile's scan; the look-back,
which thread 0's warp runs; thread 0's own codes into the image and the
heads' ORs, with the waits for the other warps; the image's copy to the
row),
builds it with nvcc into ``raisin_tpu_torch/_build/phase_clock/`` and runs it
on each of chip_smoke.py's ``HENCODE_INPUTS``. Per input it prints the ms
of one launch with the zero fills of its rows and workspace (CUDA events
over 5; outputs equal to the wrapper's), the CTAs an SM, and the SM cycles a CTA
that thread 0 spent in each phase, the mean over the CTAs (waits at
barriers and for the tiles before it included). The marks cost a few
registers and instructions, so the phases add up to a little more than the
uninstrumented kernel's time.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

PREFIX = r"""
#include <cstdint>
#include <cuda_runtime.h>
__device__ unsigned long long g_clock[8];
__shared__ long long clock_[8], last_;
#define MARK(i) if (threadIdx.x == 0) { const long long now_ = clock64(); clock_[i] += now_ - last_; last_ = now_; }
#define FLUSH(lo, hi) if (threadIdx.x == 0) { for (int i_ = lo; i_ < hi; ++i_) atomicAdd(g_clock + i_, (unsigned long long)clock_[i_]); }
"""
SUFFIX = r"""
extern "C" int clock_occupancy() {
    int n = -1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, huffman_encode_kernel, THREADS, 0);
    return n;
}
extern "C" int clock_read(unsigned long long* out) {  // the sums since the last read
    cudaDeviceSynchronize();
    const int e = cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock));
    unsigned long long z[8] = {0};
    cudaMemcpyToSymbol(g_clock, z, sizeof(z));
    return e;
}
"""
# (source text, the same with a mark), each found once
MARKS = [
    ("    if (tid == 0) tile_id = (int)atomicAdd(ticket, 1u);\n    __syncthreads();\n",
     "    if (tid == 0) { for (int i = 0; i < 8; ++i) clock_[i] = 0; last_ = clock64(); }\n"
     "    if (tid == 0) tile_id = (int)atomicAdd(ticket, 1u);\n    __syncthreads();\n    MARK(0)\n"),
    ("        len_of[i] = (uint8_t)len;\n    }\n    __syncthreads();\n",
     "        len_of[i] = (uint8_t)len;\n    }\n    __syncthreads();\n    MARK(1)\n"),
    ("        tile_bits += s;\n    }\n", "        tile_bits += s;\n    }\n    MARK(2)\n"),
    ("\n    // the thread's codes into the image", "\n    MARK(3)\n    // the thread's codes into the image"),
    ("    __syncthreads();\n\n    // the image to the row",
     "    __syncthreads();\n    MARK(4)\n    FLUSH(0, 5)\n    if (tid == 0) atomicAdd(g_clock + 7, 1ull);\n\n"
     "    // the image to the row"),
    ("        else row[g0 + j] = big_endian(v);\n    }\n}\n",
     "        else row[g0 + j] = big_endian(v);\n    }\n    MARK(5)\n    FLUSH(5, 6)\n"
     "    if (tid == 0) atomicAdd(g_clock + 6, 1ull);\n}\n"),
]
PHASES = ["ticket", "loads, tables", "lookups, scan", "look-back (warp 0)", "build and heads, waits for the CTA",
          "copy to the row"]


def instrumented(src: str) -> str:
    for plain, marked in MARKS:
        assert src.count(plain) == 1, plain
        src = src.replace(plain, marked)
    return PREFIX + src.replace("#include <cstdint>\n#include <cuda_runtime.h>\n", "") + SUFFIX


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
    out_dir = _build.BUILD_DIR / "phase_clock"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "huffman_encode_clock.cu", out_dir / "huffman_encode_clock.so"
    cu.write_text(instrumented((_build.CSRC / "huffman_encode.cu").read_text()))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.rsn_huffman_encode.argtypes = _build.SIGNATURES["rsn_huffman_encode"]
    lib.clock_read.argtypes = [ctypes.c_void_p]
    print(f"CTAs an SM: {lib.clock_occupancy()}", flush=True)
    data = bench.make_corpus(chip_smoke.MAIN_BYTES)
    for name in chip_smoke.HENCODE_INPUTS:
        x, n = chip_smoke.huffman_input(name, data, dev)
        (x, n, codes, lens, capw), bits, _ = chip_smoke.huffman_encode_args(x, n)
        want = huffman_rows.encode_rows(x, n, codes, lens, capw, bits=bits)
        B, S = x.shape
        rows = torch.empty((B, 4 * capw), dtype=torch.uint8, device=dev)
        bl, pads = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(2))
        totals = torch.empty(B, dtype=torch.int64, device=dev)
        work = torch.empty(B * huffman_rows.tiles(S) + 1, dtype=torch.int64, device=dev)

        def run():
            rows.zero_()
            work.zero_()
            rc = lib.rsn_huffman_encode(x.data_ptr(), n.data_ptr(), codes.data_ptr(), lens.data_ptr(), bits.data_ptr(),
                                        rows.data_ptr(), bl.data_ptr(), pads.data_ptr(), totals.data_ptr(),
                                        work.data_ptr(), B, S, capw, torch.cuda.current_stream(dev).cuda_stream)
            chip_smoke.check(rc == 0, f"launch failed ({rc})")

        run()
        sums = (ctypes.c_ulonglong * 8)()
        lib.clock_read(sums)  # the warm-up's
        run()
        lib.clock_read(sums)
        chip_smoke.check(all(torch.equal(a, b) for a, b in zip((rows, bl, pads), want)), f"{name}: outputs differ")
        chip_smoke.check(torch.equal(totals, bits), f"{name}: totals differ")
        ms = chip_smoke.cuda_ms(run, 5)
        ctas, written = max(1, sums[7]), max(1, sums[6])
        a_cta = {label: round(sums[i] / (written if i == 5 else ctas)) for i, label in enumerate(PHASES)}
        print(f"{name} {[B, S]}: {ms:.4f} ms a launch with its two memsets, {sums[7]} CTAs ({sums[6]} with bits), "
              f"SM cycles a CTA by phase (thread 0): {a_cta}", flush=True)
        del x, n, rows, want, work
    return 0


if __name__ == "__main__":
    sys.exit(main())
