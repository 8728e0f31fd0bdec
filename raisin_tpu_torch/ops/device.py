"""Device choice and host copies for the port (the counterpart of raisin_tpu/ops/jax_setup.py).

The rule for ``device=None`` is written down once, here: it means the CUDA
card, and raises when PyTorch sees none. The CPU runs only when a caller
asks for it (``device="cpu"``, as the tests do); nothing falls back to it.
Every entry point of the port takes an explicit ``device`` and passes it
through :func:`resolve_device`.

:func:`h2d` and :func:`d2h` move whole buffers between Python bytes and a
device, for the container and the single-stream codecs alike.
"""

from __future__ import annotations

import warnings

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``cuda`` (RuntimeError without a card); any other value as given."""
    if device is None:
        return require_cuda()
    return torch.device(device)


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


def h2d(buf, device: torch.device) -> torch.Tensor:
    """A bytes-like object -> uint8 tensor on ``device``, read and never written."""
    if len(buf) == 0:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # frombuffer warns that bytes are read-only
        return torch.frombuffer(buf, dtype=torch.uint8).to(device)


def d2h(t: torch.Tensor) -> bytes:
    """uint8 tensor -> bytes; from the card through pinned host memory."""
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    return t.numpy().tobytes()
