"""The benchmark of raisin_tpu_torch on the card: see perfbench/run.py and BENCHMARK.json."""
