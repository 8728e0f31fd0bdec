"""Device meshes for the block-sharded container: the port of raisin_tpu/parallel/mesh.py.

A :class:`Mesh` lays devices out on named axes, as ``jax.sharding.Mesh``
does: ``('data',)`` shards a container's blocks, ``('data', 'model')``
also splits the LZSS distance window of the match search
(``parallel/lzss_sharded.py``). There is no sharding object: blocks go to
the ``'data'`` entries as contiguous ranges (:func:`block_ranges`), each
encoded or decoded by the entry's own device, one host thread each
(``parallel/blocks.py``).

``device=None`` means the CUDA cards (RuntimeError without one), as
``ops.device.resolve_device`` does. On any other device type the entries
are that device repeated, the counterpart of the JAX package's virtual
host devices: ``data_mesh(8, device="cpu")`` gives 8 CPU entries, each a
host thread over the kernels' plain versions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from raisin_tpu_torch.ops.device import require_cuda


class DeviceCountError(ValueError):
    """A device count that this machine cannot give."""


class Mesh:
    """Devices on named axes: ``devices`` an object array of :class:`torch.device`."""

    def __init__(self, devices: list[torch.device], shape: tuple[int, ...], axis_names: tuple[str, ...]):
        arr = np.empty(len(devices), dtype=object)
        arr[:] = devices
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def data_devices(self) -> list[torch.device]:
        """One device per ``'data'`` entry: the first of its ``'model'`` group."""
        return list(self.devices.reshape(self.shape["data"], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _kind(device) -> str:
    return "cuda" if device is None else torch.device(device).type


def device_count(device: torch.device | str | None = None) -> int:
    """How many entries of ``device``'s type a mesh may name: the visible cards, or the CPU's cores."""
    if _kind(device) == "cuda":
        require_cuda()
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def first_devices(n_devices: int | None, device) -> list[torch.device]:
    """The first n devices of ``device``'s type (all cards, or one entry of another type, for None).

    n past :func:`device_count` raises :class:`DeviceCountError` naming both
    numbers; nothing falls back to fewer devices.
    """
    kind = _kind(device)
    have = device_count(device)
    n = (have if kind == "cuda" else 1) if n_devices is None else n_devices
    if n < 1:
        raise DeviceCountError(f"devices={n}: a mesh needs at least one device")
    if n > have:
        noun = "card" if kind == "cuda" else "CPU core"
        raise DeviceCountError(f"devices={n}: more than the {have} visible {noun}{'s' if have != 1 else ''}")
    return [torch.device("cuda", i) for i in range(n)] if kind == "cuda" else [torch.device(kind)] * n


def data_mesh(n_devices: int | None = None, device: torch.device | str | None = None) -> Mesh:
    """1-D mesh over the first n devices: axis ``'data'`` shards blocks."""
    devices = first_devices(n_devices, device)
    return Mesh(devices, (len(devices),), ("data",))


def best_mesh(n_devices: int | None = None, model_axis: int = 1, device: torch.device | str | None = None) -> Mesh:
    """2-D mesh ``('data', 'model')``: blocks x the match search's distance shards."""
    devices = first_devices(n_devices, device)
    n = len(devices)
    if n % model_axis != 0:
        raise ValueError(f"n_devices={n} not divisible by model_axis={model_axis}")
    return Mesh(devices, (n // model_axis, model_axis), ("data", "model"))


def block_range(num_blocks: int, index: int, count: int) -> tuple[int, int]:
    """The contiguous blocks [lo, hi) of entry ``index`` of ``count``: ceil(num_blocks / count) each."""
    per = -(-num_blocks // count)
    lo = min(index * per, num_blocks)
    return lo, min(lo + per, num_blocks)


def block_ranges(num_blocks: int, mesh: Mesh) -> list[tuple[int, int]]:
    """One contiguous block range per ``'data'`` entry (the counterpart of ``block_sharding``)."""
    count = mesh.shape["data"]
    return [block_range(num_blocks, i, count) for i in range(count)]
