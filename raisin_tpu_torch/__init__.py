"""raisin_tpu_torch: the PyTorch/CUDA port of raisin_tpu.

The JAX package ``raisin_tpu`` stays the reference; each part of this
package is held byte-for-byte against it. Ported so far:

- the engine entry points (``compress_bytes``, ``decompress_bytes``,
  ``compress_file``, ``decompress_file``, ``compress_files``,
  ``decompress_files``, ``CompressedFile``, ``get_codec``) over the
  ``arithmetic``, ``lzss`` and ``huffman`` codecs, each with a ``device``
  backend on the card and a ``host`` backend (the port's copies of the
  oracles); raw streams decode on the host, as in the JAX package;
- the RSNB block container (``compress_container``,
  ``decompress_container``) for the ``lzss,arithmetic``, ``arithmetic``,
  ``lzss``, ``huffman`` and ``lzss,huffman`` pipelines.

The work over the data runs in nine hand-written Hopper kernels
(``raisin_tpu_torch/csrc``). ``device=None`` means the CUDA card and raises
without one; ``device="cpu"`` runs the kernels' plain PyTorch versions.
Nothing here imports ``jax`` or ``raisin_tpu``.
"""

from raisin_tpu_torch.engine.core import (  # noqa: F401
    CompressedFile,
    compress_bytes,
    compress_file,
    compress_files,
    decompress_bytes,
    decompress_file,
    decompress_files,
)
from raisin_tpu_torch.engine.registry import ENGINES, SUITES, get_codec  # noqa: F401
from raisin_tpu_torch.parallel import compress_container, decompress_container  # noqa: F401
