"""Multi-process entry points: the port of raisin_tpu/parallel/multihost.py.

One process drives one device, as ``torchrun`` lays processes out:
:func:`initialize` joins the ``torch.distributed`` group, over NCCL between
cards and gloo on the CPU, and sets this process's device.
:func:`global_data_mesh` is the ``('data', 'model')`` layout over every
process's device, with the ``'model'`` groups (the tensor-parallel match
search of ``parallel/lzss_sharded.py``) kept inside one host, and
:func:`process_block_range` the contiguous blocks a process encodes. Each
process encodes its range on its own device and the segments join in rank
order through ``parallel.blocks.assemble_container``
(``parallel/multihost_worker.py`` does that on the command line).

Without an initialised group every function describes this one process.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from raisin_tpu_torch.ops.device import require_cuda
from raisin_tpu_torch.parallel.mesh import Mesh, block_range, first_devices

# this process's device, set by initialize(); torch.distributed's own group state is process-wide too
_process = {"device": None}


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: torch.device | str | None = None,
) -> torch.device:
    """Join the process group; -> this process's device.

    With ``coordinator_address`` ("host:port", or a URL: ``tcp://``, or
    ``file://`` for processes of one host) the group meets there, and
    ``num_processes`` and ``process_id`` are required; without it, ``env://`` reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE``, as ``torchrun`` sets them (the env
    defaults of ``jax.distributed.initialize``). The device is ``device``,
    else ``cuda:LOCAL_RANK``; a ``LOCAL_RANK`` past the visible cards
    raises ValueError (no process wraps round onto another's card). The
    backend is ``"nccl"`` for a card and ``"gloo"`` otherwise, unless
    ``backend`` names one.
    """
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    else:
        init, world, rank = "env://", -1, -1
    if device is None:
        require_cuda()
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK={local} past the {torch.cuda.device_count()} visible cards")
        device = torch.device("cuda", local)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=init,
                            world_size=world, rank=rank)
    _process["device"] = dev
    return dev


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_data_mesh(model_axis: int = 1, n_devices: int | None = None,
                     device: torch.device | str | None = None) -> Mesh:
    """Mesh over every process's device: ``('data', 'model')``, rank r at (r // model_axis, r % model_axis).

    Collective: every process of the group calls it. ``model_axis`` must
    divide the device count and stay within one host's devices, so that
    the match search's collectives never cross hosts (ValueError
    otherwise, as the JAX package). Without an initialised group the mesh
    covers this process's devices: ``n_devices`` of ``device``'s type (every
    card for None, as ``parallel.mesh.data_mesh``).
    """
    if dist.is_available() and dist.is_initialized():
        if _process["device"] is None:
            raise RuntimeError("global_data_mesh: the group was not joined through initialize()")
        found = [None] * dist.get_world_size()
        dist.all_gather_object(found, (socket.gethostname(), str(_process["device"])))
        devices = [torch.device(d) for _, d in found]
        local = sum(host == socket.gethostname() for host, _ in found)
    else:
        devices = first_devices(n_devices, device)
        local = len(devices)
    n = len(devices)
    if n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")
    if model_axis > local:
        raise ValueError(f"model_axis={model_axis} would span hosts (local devices: {local})")
    return Mesh(devices, (n // model_axis, model_axis), ("data", "model"))


def process_block_range(num_blocks: int) -> tuple[int, int]:
    """The contiguous block range [lo, hi) this process owns: ceil(num_blocks / processes) each."""
    rank, world = _rank_world()
    return block_range(num_blocks, rank, world)
