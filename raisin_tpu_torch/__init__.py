"""raisin_tpu_torch: the PyTorch/CUDA port of raisin_tpu.

The JAX package ``raisin_tpu`` stays the reference; each part of this
package is held byte-for-byte against it. Ported so far:

- the ``raisin``/``grape`` command line (``cli.main``; ``bin/raisin_torch``,
  ``bin/grape_torch``), the benchmark table (``engine.benchmark``) and the
  profiling hook (``utils.profiling.trace``);
- the engine entry points (``compress_bytes``, ``decompress_bytes``,
  ``compress_file``, ``decompress_file``, ``compress_files``,
  ``decompress_files``, ``CompressedFile``, ``get_codec``) over every
  codec: a ``host`` backend for each (the port's copies of the oracles),
  a ``device`` backend on the card for ``arithmetic``, ``lzss`` and
  ``huffman``, and a ``native`` one (the port's copy of the C runtime)
  for ``lzss``, ``arithmetic``, ``mcc`` and ``dmc``;
- the RSNB block container (``compress_container``,
  ``decompress_container``): the ``lzss,arithmetic``, ``arithmetic``,
  ``lzss``, ``huffman`` and ``lzss,huffman`` pipelines on the card, any
  other block by block through the engine.

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
