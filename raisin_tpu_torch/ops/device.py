"""Device choice for the port (the counterpart of raisin_tpu/ops/jax_setup.py).

The rule for ``device=None`` is written down once, here: the first CUDA
card when PyTorch sees one, else the CPU. Every entry point of the port
takes an explicit ``device`` and passes it through :func:`resolve_device`.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``cuda`` when a card is present, else ``cpu``."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")
