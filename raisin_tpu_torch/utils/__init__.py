"""Helpers of the port: the benchmark table's byte counts, the profiling hook, the Canterbury-shaped corpus."""

from raisin_tpu_torch.utils.corpus import generate, text_files, write_corpus

__all__ = ["generate", "text_files", "write_corpus"]
