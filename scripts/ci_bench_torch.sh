#!/bin/sh
# The CI benchmark page on the PyTorch/CUDA port: the counterpart of
# scripts/ci_bench.sh (the reference's Travis flow, .travis.yml:19-29) over
# raisin_tpu_torch.
#
#   scripts/ci_bench_torch.sh [outdir]                        # on the CUDA card
#   RAISIN_CI_DEVICE=cpu scripts/ci_bench_torch.sh [outdir]   # on the CPU: the kernels' plain versions
#
# Writes the Canterbury-shaped corpus (raisin_tpu_torch.utils.corpus, at
# RAISIN_CI_SCALE, 0.05 by default) under $outdir/corpus/, runs the port's
# benchmark table over it with the reference CI's algorithm list, each entry
# a list of layers, and writes index.html and results.json into $outdir
# (ci_out_torch/ by default), never into docs/sample_benchmark/
# (raisin_tpu_torch.engine.benchmark.write_ci_page).
set -eu

OUT="${1:-ci_out_torch}"
SCALE="${RAISIN_CI_SCALE:-0.05}"
DEVICE="${RAISIN_CI_DEVICE:-}"
ROOT="$(cd "$(dirname "$0")/.." && pwd)"
case "$(realpath -m "$OUT")" in
"$ROOT/docs/sample_benchmark"*) echo "ci_bench_torch.sh: docs/sample_benchmark/ is the JAX script's page" >&2; exit 1 ;;
esac
mkdir -p "$OUT"
OUT="$(cd "$OUT" && pwd)"

cd "$ROOT"
python3 - "$OUT" "$SCALE" "$DEVICE" <<'PY'
import os
import sys

sys.path.insert(0, os.getcwd())
from raisin_tpu_torch.engine.benchmark import write_ci_page

out, scale, device = sys.argv[1], float(sys.argv[2]), sys.argv[3] or None
rows = write_ci_page(out, scale, device)
print(f"wrote {out}/index.html and {out}/results.json ({len(rows)} rows)")
PY
