"""Codec registry and algorithm layering on PyTorch (the port of raisin_tpu/engine)."""

from raisin_tpu_torch.engine.registry import ENGINES, SUITES, get_codec, register_backend  # noqa: F401
from raisin_tpu_torch.engine.core import (  # noqa: F401
    CompressedFile,
    compress_bytes,
    decompress_bytes,
)
