"""Block-parallel RSNB container on PyTorch."""

from raisin_tpu_torch.parallel.blocks import compress_container, decompress_container  # noqa: F401
