"""Block-parallel RSNB container on PyTorch, and the meshes that shard it."""

from raisin_tpu_torch.parallel.blocks import (  # noqa: F401
    DEFAULT_BLOCK_SIZE,
    compress_container,
    decompress_container,
)
from raisin_tpu_torch.parallel.mesh import best_mesh, data_mesh  # noqa: F401
