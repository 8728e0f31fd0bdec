"""raisin_tpu_torch: the PyTorch/CUDA port of raisin_tpu.

The JAX package ``raisin_tpu`` stays the reference; each part of this
package is held byte-for-byte against it. Ported so far: the RSNB
container for the pure-arithmetic pipeline (``("arithmetic",)``), with
hand-written Hopper kernels for the encoder, the `.rsn` prepad and the
decoder (``raisin_tpu_torch/csrc``).

Nothing here imports ``raisin_tpu`` (whose package import loads JAX) at
module level.
"""

from raisin_tpu_torch.parallel import compress_container, decompress_container  # noqa: F401
