"""Helpers of the port: the benchmark table's byte counts, the profiling hook."""
