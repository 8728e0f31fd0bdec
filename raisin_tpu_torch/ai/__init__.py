"""Algorithm-selection harness on the port: the counterpart of raisin_tpu/ai.

Per-file features, a synthesized dataset, benchmark records from the
port's engine, and an MLP picker (``torch.nn``) that chooses the best
algorithm from the features; it also takes a flax picker's weights.
"""

from raisin_tpu_torch.ai.features import entropy_nats, file_features, sniff_mime  # noqa: F401
from raisin_tpu_torch.ai.harness import benchmark_files, generate_dataset  # noqa: F401
from raisin_tpu_torch.ai.model import AlgorithmPicker  # noqa: F401
