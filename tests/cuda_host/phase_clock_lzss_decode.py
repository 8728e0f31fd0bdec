"""Kernel F's time by phase, on the card: clock64 marks in a copy of its source.

    python3 tests/cuda_host/phase_clock_lzss_decode.py   # from the repository root, on a CUDA machine

Copies ``raisin_tpu_torch/csrc/lzss_decode.cu`` with marks that thread 0 of
each CTA reads between the kernel's phases (tile load, pass A with its
scan, pass B's walk and its scan, pass C with its reduction, the rounds'
set-up, round 0, the later rounds' two halves, the one-warp walk, the row's
store), builds it with nvcc into ``raisin_tpu_torch/_build/phase_clock/``
and runs it on each of chip_smoke.py's ``WALK_INPUTS``. Per input it
prints the ms of one launch (CUDA events over 5, outputs equal to the
wrapper's), the CTAs an SM, the rounds and one-warp steps a block, and
the SM cycles a block that thread 0 spent in each phase, summed over the
block's tiles (waits at barriers included), with the slowest and the mean
warp's own cycles in pass B's walk. The marks add a barrier before pass
B's walk and cost a few registers, so the phases add up to a little more
than the uninstrumented kernel's time.
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
__device__ unsigned long long g_clock[16];
__shared__ long long clock_[16], last_;
__shared__ unsigned walk_max_, walk_sum_;
#define MARK(i) if (threadIdx.x == 0) { const long long now_ = clock64(); clock_[i] += now_ - last_; last_ = now_; }
"""
SUFFIX = r"""
extern "C" int clock_occupancy() {
    cudaFuncSetAttribute(lzss_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    int n = -1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, lzss_decode_kernel, THREADS, SMEM_BYTES);
    return n;
}
extern "C" int clock_read(unsigned long long* out) {  // the sums since the last read
    cudaDeviceSynchronize();
    const int e = cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock));
    unsigned long long z[16] = {0};
    cudaMemcpyToSymbol(g_clock, z, sizeof(z));
    return e;
}
"""
# (source text, the same with a mark), each found once
MARKS = [
    ("    int rounds = 0, steps = 0;\n",
     "    int rounds = 0, steps = 0;\n    if (tid == 0) { for (int i = 0; i < 16; ++i) clock_[i] = 0; last_ = clock64(); }\n"),
    ("        // A: the chunk's state map", "        MARK(0)\n        // A: the chunk's state map"),
    ("        state = apply(all, state);\n", "        state = apply(all, state);\n        MARK(1)\n"),
    ("        walk_chunk<false>(st, sh, out, w, lo, hi, entry, o, k, (unsigned)cap);\n",
     "        if (tid == 0) walk_max_ = walk_sum_ = 0;\n        __syncthreads();\n        const long long b0_ = clock64();\n"
     "        walk_chunk<false>(st, sh, out, w, lo, hi, entry, o, k, (unsigned)cap);\n"
     "        { const unsigned dt = __reduce_max_sync(FULL_MASK, (unsigned)(clock64() - b0_));\n"
     "          if ((tid & 31) == 0) { atomicMax(&walk_max_, dt); atomicAdd(&walk_sum_, dt); } }\n"),
    ("        scan_counts(o, k, tile_out, tile_toks);\n",
     "        scan_counts(o, k, tile_out, tile_toks);\n"
     "        if (tid == 0) { clock_[12] += walk_max_; clock_[13] += walk_sum_ / WARPS; }\n        MARK(2)\n"),
    ("        if (fault != NO_FAULT) break;\n", "        MARK(3)\n        if (fault != NO_FAULT) break;\n"),
    ("rounds, steps);\n    }\n", "rounds, steps);\n        MARK(4)\n    }\n"),
    ("        if (tid + k * THREADS < count) pending |= 1u << k;\n    __syncthreads();\n",
     "        if (tid + k * THREADS < count) pending |= 1u << k;\n    __syncthreads();\n    MARK(8)\n"),
    ("        __syncthreads();\n        const unsigned nq = *queued;\n",
     "        __syncthreads();\n        if (round == 0) { MARK(11) } else { MARK(9) }\n        const unsigned nq = *queued;\n"),
    ("        const int left = __syncthreads_or(pending != 0);\n",
     "        const int left = __syncthreads_or(pending != 0);\n        MARK(10)\n"),
    ("    // the rest of the tile: one warp", "    MARK(5)\n    // the rest of the tile: one warp"),
    ("    }\n    __syncthreads();\n}\n\n// Stores the row", "    }\n    MARK(7)\n    __syncthreads();\n}\n\n// Stores the row"),
    ("    write_row(out, skew, total, cap);\n",
     "    write_row(out, skew, total, cap);\n    __syncthreads();\n    MARK(6)\n"
     "    if (tid == 0) for (int i = 0; i < 16; ++i) atomicAdd(g_clock + i, (unsigned long long)clock_[i]);\n"),
]


def instrumented(src: str) -> str:
    for plain, marked in MARKS:
        assert src.count(plain) == 1, plain
        src = src.replace(plain, marked)
    return PREFIX + src.replace("#include <cstdint>\n#include <cuda_runtime.h>\n", "") + SUFFIX


def main() -> int:
    import torch

    import bench
    import chip_smoke
    from raisin_tpu_torch.ops import _build, lzss_decode
    from raisin_tpu_torch.ops.device import require_cuda

    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    out_dir = _build.BUILD_DIR / "phase_clock"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "lzss_decode_clock.cu", out_dir / "lzss_decode_clock.so"
    cu.write_text(instrumented((_build.CSRC / "lzss_decode.cu").read_text()))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.rsn_lzss_decode.argtypes = _build.SIGNATURES["rsn_lzss_decode"]
    lib.clock_read.argtypes = [ctypes.c_void_p]
    print(f"CTAs an SM: {lib.clock_occupancy()}", flush=True)
    data = bench.make_corpus(chip_smoke.MAIN_BYTES)
    names = ["load", "A", "B", "C", "between rounds and walk", "", "write", "one-warp walk", "rounds set-up",
             "later rounds, first half", "rounds, second half", "round 0, first half", "B walk, slowest warp",
             "B walk, mean warp"]
    for name in chip_smoke.WALK_INPUTS:
        (tok, tl, cap), _ = chip_smoke.walk_input(name, data, dev)
        B, S = tok.shape
        want = lzss_decode.walk_tokens(tok, tl, cap)
        rows = torch.empty((B, cap), dtype=torch.uint8, device=dev)
        ol, err = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(2))
        stats = torch.zeros((B, 2), dtype=torch.int32, device=dev)

        def run():
            rc = lib.rsn_lzss_decode(tok.data_ptr(), tl.data_ptr(), rows.data_ptr(), ol.data_ptr(), err.data_ptr(),
                                     stats.data_ptr(), B, S, cap, torch.cuda.current_stream(dev).cuda_stream)
            chip_smoke.check(rc == 0, f"launch failed ({rc})")

        run()
        sums = (ctypes.c_ulonglong * 16)()
        lib.clock_read(sums)  # the warm-up's
        run()
        lib.clock_read(sums)
        chip_smoke.check(all(torch.equal(a, b) for a, b in zip((rows, ol, err), want)), f"{name}: outputs differ")
        ms = chip_smoke.cuda_ms(run, 5)
        a_block = {label: round(sums[i] / B) for i, label in enumerate(names) if label}
        a_block["between rounds and walk"] += round(sums[5] / B)
        print(f"{name} {[B, S]}: {ms:.4f} ms, rounds and one-warp steps a block "
              f"{[round(v, 2) for v in stats.float().mean(0).tolist()]}, SM cycles a block by phase "
              f"(thread 0): {a_block}", flush=True)
        del tok, tl, rows, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
