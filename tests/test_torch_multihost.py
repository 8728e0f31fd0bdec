"""The port's multi-process paths on two gloo CPU processes, against the JAX package.

- ``python -m raisin_tpu_torch.parallel.multihost_worker`` on two ranks:
  the ``all_reduce(SUM)`` proof, disjoint, covering and ordered block
  ranges, and the rank-order ``assemble_container`` equal to the JAX
  package's single-process container of the same 256 KiB (the JAX
  worker's input) and round-tripping;
- ``parallel.lzss_sharded.sharded_pipeline_step`` on two ranks at
  ``model_axis=2`` (each rank searches half the distance window, then the
  two MAX all-reduces) equal to the JAX ``sharded_pipeline_step`` on a
  (1, 2) mesh of the conftest's virtual devices, exactly;
- the single-process semantics of ``multihost`` (tests/test_aux_subsystems.py:34).

Every subprocess has a timeout; each rank uses its share of the cores.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import bench
from raisin_tpu.parallel import blocks as jax_blocks
from raisin_tpu.parallel.lzss_sharded import sharded_pipeline_step as jax_step
from raisin_tpu.parallel.mesh import best_mesh as jax_best_mesh
from raisin_tpu_torch.entry import rendezvous, run_ranks
from raisin_tpu_torch.parallel import blocks as port_blocks
from raisin_tpu_torch.parallel import multihost
from raisin_tpu_torch.parallel.lzss_sharded import sharded_pipeline_step
from raisin_tpu_torch.parallel.multihost_worker import load_segments

TIMEOUT = 600


def _ranks(argv_of, n: int = 2) -> list[str]:
    """Start n processes, each with its share of the cores (spinning OpenMP threads collide); -> their output."""
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // n)))
    return run_ranks(argv_of, n, env, timeout=TIMEOUT)


def test_two_process_container_equals_the_jax_single_process_container(tmp_path):
    data = bench.make_corpus(1 << 18)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    with rendezvous() as url:
        outs = _ranks(lambda r: [sys.executable, "-m", "raisin_tpu_torch.parallel.multihost_worker", str(src),
                                 str(tmp_path), "--rank", str(r), "--world", "2", "--coordinator", url, "--device",
                                 "cpu"])
    assert all("owns blocks" in out for out in outs)
    records, payloads, aux = load_segments(str(tmp_path), 2)
    # the collective: sum over ranks of arange(4) + 10 * rank, on both
    assert records[0]["sum"] == records[1]["sum"] == [10.0, 12.0, 14.0, 16.0]
    (lo0, hi0), (lo1, hi1) = records[0]["range"], records[1]["range"]
    assert lo0 == 0 and hi0 == lo1 and hi1 == records[0]["nblocks"] == 32
    container = port_blocks.assemble_container(payloads, [aux], ("lzss", "arithmetic"), 8192, 2048, len(data))
    single = jax_blocks.compress_container(data, ("lzss", "arithmetic"), block_size=8192, window=2048)
    assert container == single
    assert port_blocks.decompress_container(container, device="cpu") == data


STEP_RANK = """
import sys, numpy as np, torch
from raisin_tpu_torch.parallel import multihost
from raisin_tpu_torch.parallel.lzss_sharded import sharded_pipeline_step
rank, url, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(url, 2, rank, device="cpu")
mesh = multihost.global_data_mesh(model_axis=2)
assert mesh.shape == {"data": 1, "model": 2}, mesh.shape
z = np.load(path)
step = sharded_pipeline_step(mesh, z["x"].shape[1], 4096)
tok, tok_len, bits, bit_len = step(torch.from_numpy(z["x"]), torch.from_numpy(z["lengths"]))
np.savez(f"{path}.rank{rank}.npz", tok=tok.numpy(), tok_len=tok_len.numpy(), bits=bits.numpy(),
         bit_len=bit_len.numpy())
torch.distributed.destroy_process_group()
"""


def _step_blocks(B: int, S: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded blocks of bytes 97..104 (none that the escape rewrites), each a random run of
    2100..3000 bytes repeated: their longest matches lie in the far half of the window."""
    rng = np.random.default_rng(11)
    x = np.zeros((B, S), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for i in range(B):
        n = int(rng.integers(S // 2, S))
        x[i, :n] = np.resize(rng.integers(97, 105, size=int(rng.integers(2100, 3000))), n)
        lengths[i] = n
    return x, lengths


def test_two_process_sharded_step_equals_the_jax_step(tmp_path):
    B, S = 2, 4096
    x, lengths = _step_blocks(B, S)
    path = tmp_path / "blocks.npz"
    np.savez(path, x=x, lengths=lengths)
    with rendezvous() as url:
        _ranks(lambda r: [sys.executable, "-c", STEP_RANK, str(r), url, str(path)])
    got = [np.load(f"{path}.rank{r}.npz") for r in range(2)]

    mesh = jax_best_mesh(2, model_axis=2)
    xj = np.where(np.arange(S)[None, :] < lengths[:, None], x.astype(np.int32), -1)
    xs = jax.device_put(xj, NamedSharding(mesh, P("data", None)))
    ls = jax.device_put(lengths, NamedSharding(mesh, P("data")))
    tok, tok_len, bits, bit_len = (np.asarray(a) for a in jax_step(mesh, S)(xs, ls))
    for g in got:
        assert np.array_equal(g["tok_len"], tok_len) and np.array_equal(g["bit_len"], bit_len)
        for b in range(B):
            assert np.array_equal(g["tok"][b, : tok_len[b]], tok[b, : tok_len[b]])
            assert np.array_equal(g["bits"][b, : bit_len[b]], bits[b, : bit_len[b]])
        assert g["bits"].shape == bits.shape and not g["bits"][np.arange(bits.shape[1])[None, :] >= bit_len[:, None]].any()
    # and the one-process step (every shard in turn, combined by the same rule) agrees
    one = sharded_pipeline_step(multihost.global_data_mesh(2, n_devices=2, device="cpu"), S, 4096)
    t1, tl1, b1, bl1 = one(torch.from_numpy(x), torch.from_numpy(lengths))
    assert np.array_equal(tl1.numpy(), tok_len) and np.array_equal(b1.numpy(), got[0]["bits"])


def test_multihost_helpers_single_process(monkeypatch):
    monkeypatch.setattr("os.cpu_count", lambda: 8)  # the 8 CPU entries, on any host
    assert multihost.process_block_range(10) == (0, 10)
    assert multihost.process_block_range(0) == (0, 0)
    mesh = multihost.global_data_mesh(model_axis=2, n_devices=8, device="cpu")
    assert mesh.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="not divisible by model_axis=3"):
        multihost.global_data_mesh(model_axis=3, n_devices=8, device="cpu")


def test_initialize_refuses_what_it_cannot_join(monkeypatch):
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.initialize("localhost:1", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="LOCAL_RANK=1 past the 1 visible cards"):
        multihost.initialize("localhost:1", 2, 1)
