"""The port's mesh, sharded container and kernel D's distance sub-range against the JAX package.

On a mesh of 8 CPU entries (``raisin_tpu_torch.parallel.data_mesh(8,
device="cpu")``, the counterpart of the conftest's 8 virtual host devices)
every pipeline's container equals the JAX package's on its 8-device mesh
and the unsharded call's, byte for byte; each package decodes the other's.
Kernel D's plain version over a distance sub-range (d_lo, d_hi] equals the
JAX scan ``_match_scan(xb, n, window, wl, d0)`` exactly, and the MAX
combine of two halves equals the whole window. Inputs come from seeded
numpy and bench.make_corpus; every comparison is exact.
"""

from __future__ import annotations

import functools
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from raisin_tpu.formats import lzss_ref
from raisin_tpu.ops import lzss_jax
from raisin_tpu.parallel import blocks as jax_blocks
from raisin_tpu.parallel import mesh as jax_mesh
from raisin_tpu_torch.engine.core import _resolve_mesh
from raisin_tpu_torch.ops import lzss_match
from raisin_tpu_torch.parallel import blocks as port_blocks
from raisin_tpu_torch.parallel import mesh as port_mesh
from raisin_tpu_torch.parallel.lzss_sharded import combine

torch.set_num_threads(2)

CPU = "cpu"
BS = 2048
PIPELINES = [("lzss", "arithmetic"), ("arithmetic",), ("lzss",), ("huffman",), ("lzss", "huffman"), ("gzip",)]
IDS = [",".join(p) for p in PIPELINES]
DATA = bench.make_corpus(9 * BS - 300)  # nine blocks, a ragged tail: ranges of 2, 2, 2, 2, 1 on 8 entries


@pytest.fixture(autouse=True)
def _eight_cpu_entries(monkeypatch):
    """A CPU mesh may name as many entries as the host has cores; these tests name 8 on any host."""
    cores = os.cpu_count() or 1
    monkeypatch.setattr("os.cpu_count", lambda: max(8, cores))


@functools.cache
def _containers(algorithms: tuple[str, ...]):
    """(JAX on its 8-device mesh, the port on 8 CPU entries, the port unsharded)."""
    jax_c = jax_blocks.compress_container(DATA, algorithms, block_size=BS, mesh=jax_mesh.data_mesh(8))
    mesh = port_mesh.data_mesh(8, device=CPU)
    port_c = port_blocks.compress_container(DATA, algorithms, block_size=BS, mesh=mesh, device=CPU)
    one = port_blocks.compress_container(DATA, algorithms, block_size=BS, device=CPU)
    return jax_c, port_c, one


@pytest.mark.parametrize("algorithms", PIPELINES, ids=IDS)
def test_mesh_container_equals_jax_and_unsharded(algorithms):
    jax_c, port_c, one = _containers(algorithms)
    assert port_c == jax_c
    assert port_c == one


@pytest.mark.parametrize("algorithms", PIPELINES, ids=IDS)
def test_mesh_decode_and_each_package_decodes_the_other(algorithms):
    jax_c, port_c, _ = _containers(algorithms)
    assert port_blocks.decompress_container(port_c, mesh=port_mesh.data_mesh(8, device=CPU)) == DATA
    assert port_blocks.decompress_container(jax_c, mesh=port_mesh.data_mesh(3, device=CPU)) == DATA
    assert jax_blocks.decompress_container(port_c, mesh=jax_mesh.data_mesh(8)) == DATA


@pytest.mark.parametrize("algorithms", [("lzss", "arithmetic"), ("arithmetic",), ("lzss", "huffman")], ids=str)
def test_three_blocks_on_eight_entries(algorithms):
    """Ragged: five of the eight entries get no block."""
    data = DATA[: 2 * BS + 77]
    mesh = port_mesh.data_mesh(8, device=CPU)
    assert port_mesh.block_ranges(3, mesh) == [(0, 1), (1, 2), (2, 3)] + [(3, 3)] * 5
    got = port_blocks.compress_container(data, algorithms, block_size=BS, mesh=mesh)
    assert got == jax_blocks.compress_container(data, algorithms, block_size=BS, mesh=jax_mesh.data_mesh(8))
    assert got == port_blocks.compress_container(data, algorithms, block_size=BS, device=CPU)
    assert port_blocks.decompress_container(got, mesh=mesh) == data


def test_empty_input_on_a_mesh():
    mesh = port_mesh.data_mesh(4, device=CPU)
    c = port_blocks.compress_container(b"", ("lzss", "arithmetic"), block_size=BS, mesh=mesh)
    assert c == jax_blocks.compress_container(b"", ("lzss", "arithmetic"), block_size=BS)
    assert port_blocks.decompress_container(c, mesh=mesh) == b""


@pytest.mark.parametrize("extra", [-5, 5])
def test_mesh_decode_checks_the_total_like_jax(extra):
    """A header that disagrees with what the blocks decode to: the ranges' slices of the one output
    buffer take no more than they hold, and the total names both numbers, as the JAX package's."""
    c = port_blocks.compress_container(DATA, ("gzip",), block_size=BS, device=CPU)
    _, _, _, payloads, _, window = port_blocks.parse_container(c)
    bad = port_blocks.assemble_container(payloads, [], ("gzip",), BS, window, len(DATA) + extra)
    want = f"decoded {len(DATA)} bytes, expected {len(DATA) + extra}$"
    with pytest.raises(ValueError, match=want):
        jax_blocks.decompress_container(bad, mesh=jax_mesh.data_mesh(8))
    with pytest.raises(ValueError, match=want):
        port_blocks.decompress_container(bad, mesh=port_mesh.data_mesh(3, device=CPU))


def test_put_copies_as_far_as_the_buffer_reaches():
    out = torch.zeros(6, dtype=torch.uint8)
    assert port_blocks._put(out, 1, torch.tensor([1, 2, 3], dtype=torch.uint8)) == 3
    assert port_blocks._put(out, 4, b"\x07\x08\x09") == 3
    assert port_blocks._put(out, 6, b"\x05") == 1
    assert out.tolist() == [0, 1, 2, 3, 7, 8]


def test_mesh_shapes_and_ranges():
    m = port_mesh.data_mesh(8, device=CPU)
    assert m.shape == {"data": 8} and m.size == 8 and m.axis_names == ("data",)
    assert m.data_devices() == [torch.device("cpu")] * 8
    assert port_mesh.data_mesh(device=CPU).shape == {"data": 1}
    b = port_mesh.best_mesh(8, model_axis=2, device=CPU)
    assert b.shape == {"data": 4, "model": 2} == dict(jax_mesh.best_mesh(8, model_axis=2).shape)
    assert len(b.data_devices()) == 4
    assert port_mesh.block_ranges(10, port_mesh.data_mesh(4, device=CPU)) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert port_mesh.block_ranges(10, b) == [(0, 3), (3, 6), (6, 9), (9, 10)]


def test_mesh_value_errors(monkeypatch):
    with pytest.raises(ValueError, match="not divisible by model_axis=3"):
        port_mesh.best_mesh(8, model_axis=3, device=CPU)
    with pytest.raises(ValueError, match="not divisible by model_axis=3"):
        jax_mesh.best_mesh(8, model_axis=3)
    with pytest.raises(ValueError, match="at least one device"):
        port_mesh.data_mesh(0, device=CPU)
    # a mesh beside a device of another type
    with pytest.raises(ValueError, match="not of device 'meta'"):
        port_blocks.compress_container(DATA[:100], ("arithmetic",), mesh=port_mesh.data_mesh(2, device=CPU),
                                       device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.data_mesh()


def test_mesh_past_the_cards_names_both_numbers(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(port_mesh.DeviceCountError, match="devices=2: more than the 1 visible card$"):
        port_mesh.data_mesh(2)
    assert port_mesh.data_mesh().devices.tolist() == [torch.device("cuda", 0)]


@pytest.mark.parametrize("devices, want", [(None, None), (1, None), ("1", None), ("", None), ("auto", {"data": 1}),
                                           (2, {"data": 2}), ("2", {"data": 2})])
def test_resolve_mesh(devices, want):
    mesh = _resolve_mesh(devices, CPU)
    assert (mesh and mesh.shape) == want


@pytest.mark.parametrize("devices", [99, "99", "many"])
def test_resolve_mesh_refuses_what_the_machine_lacks(devices, monkeypatch):
    monkeypatch.setattr("os.cpu_count", lambda: 8)
    with pytest.raises(ValueError, match="devices="):
        _resolve_mesh(devices, CPU)


def test_ranges_on_distinct_devices_run_in_threads_in_block_order():
    devices = [torch.device("cpu"), torch.device("meta"), torch.device("cpu", 0)]
    seen = []

    def fn(lo, hi, dev):
        seen.append((lo, threading.current_thread().name))
        return f"{lo}-{hi}@{dev}"

    assert port_blocks._over_ranges(7, devices, fn) == ["0-3@cpu", "3-6@meta", "6-7@cpu:0"]
    assert all(name.startswith("rsnb") for _, name in seen) and len(seen) == 3

    def fail(lo, hi, dev):
        if lo == 3:
            raise ValueError("range 3 failed")
        return lo

    with pytest.raises(ValueError, match="range 3 failed"):
        port_blocks._over_ranges(7, devices, fail)
    # entries of one device run in turn, on the calling thread
    seen.clear()
    assert port_blocks._over_ranges(3, [torch.device("cpu")] * 8, fn) == ["0-1@cpu", "1-2@cpu", "2-3@cpu"]
    assert {name for _, name in seen} == {threading.current_thread().name}


# ---------------------------------------------------------------------------
# Kernel D over a distance sub-range


def _blocks(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    text = bench.make_corpus(1500)[int(rng.integers(0, 200)):][:1200]
    runs = b"".join(bytes([int(c)]) * int(r) for c, r in zip(rng.integers(0, 4, 60), rng.integers(1, 40, 60)))[:900]
    rand = bytes(rng.integers(0, 256, 700, dtype=np.uint8))
    return [lzss_ref.encode_opening_symbols(b) for b in (text, runs, rand, b"\x00" * 600, b"ab", b"")]


S_RANGE = 1280


@functools.cache
def _range_inputs():
    encs = _blocks(5)
    x = np.full((len(encs), S_RANGE), -1, dtype=np.int32)
    for i, e in enumerate(encs):
        x[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
    lengths = np.array([len(e) for e in encs], dtype=np.int32)
    return x, lengths


def _port_range(window: int, d0: int, wl: int):
    x, lengths = _range_inputs()
    xt = torch.from_numpy(np.where(x >= 0, x, 0).astype(np.uint8))
    L, D = lzss_match.find_matches(xt, torch.from_numpy(lengths), window, d0, d0 + wl)
    return L.numpy(), D.numpy()


RANGES = [(16, 0, 8), (16, 8, 8), (16, 3, 10), (16, 0, 16),
          (64, 0, 32), (64, 32, 32), (64, 5, 50), (64, 63, 1),
          (4096, 0, 2048), (4096, 2048, 2048), (4096, 3, 4088), (4096, 1000, 24)]


@pytest.mark.parametrize("window, d0, wl", RANGES)
def test_plain_find_matches_over_a_range_equals_the_jax_scan(window, d0, wl):
    x, lengths = _range_inputs()
    L, D = _port_range(window, d0, wl)
    for i in range(len(lengths)):
        Lj, Dj, _ = lzss_jax._match_scan(jnp.asarray(x[i]), int(lengths[i]), window, wl, jnp.int32(d0))
        assert np.array_equal(L[i], np.asarray(Lj)) and np.array_equal(D[i], np.asarray(Dj)), i
    assert (D[L > 0] > d0).all() and (D <= d0 + wl).all() and not L[D == 0].any()


@pytest.mark.parametrize("window", [16, 64, 4096])
def test_max_combine_of_the_halves_equals_the_whole_window(window):
    half = window // 2
    full = _port_range(window, 0, window)
    lo, hi = _port_range(window, 0, half), _port_range(window, half, half)
    L, D = combine(*(torch.from_numpy(a) for a in (*lo, *hi)))
    assert np.array_equal(L.numpy(), full[0]) and np.array_equal(D.numpy(), full[1])
    # the two all-reduce rules, as the sharded step applies them
    Lg = np.maximum(lo[0], hi[0])
    Dg = np.maximum(np.where(lo[0] == Lg, lo[1], 0), np.where(hi[0] == Lg, hi[1], 0))
    assert np.array_equal(Lg, full[0]) and np.array_equal(Dg, full[1])


@pytest.mark.parametrize("d_lo, d_hi", [(-1, 8), (8, 8), (9, 8), (0, 17)])
def test_find_matches_refuses_a_range_outside_the_window(d_lo, d_hi):
    x = torch.zeros((1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="distance range"):
        lzss_match.find_matches(x, torch.tensor([8], dtype=torch.int32), 16, d_lo, d_hi)


def test_new_modules_import_without_jax():
    """The mesh, multi-process, sharded-step, ai and entry modules and chip_smoke import no JAX."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import raisin_tpu_torch.parallel.mesh, raisin_tpu_torch.parallel.multihost\n"
        "import raisin_tpu_torch.parallel.multihost_worker, raisin_tpu_torch.parallel.lzss_sharded\n"
        "import raisin_tpu_torch.ai, raisin_tpu_torch.entry, chip_smoke\n"
        "from raisin_tpu_torch.parallel import data_mesh, best_mesh\n"
        "assert best_mesh(4, 2, device='cpu').shape == {'data': 2, 'model': 2}\n"
        "leaked = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raisin_tpu.')))\n"
        "assert not leaked and 'raisin_tpu' not in sys.modules, leaked\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_launch_counts_lose_nothing_across_threads():
    """The mesh's threads count launches at once: more threads than cores, a short switch interval."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from raisin_tpu_torch.ops import _build

    def fake():
        pass

    fake.launches = 0
    split = {"encode": 0}

    def work(_):
        for _ in range(2000):
            _build.count(fake)
            _build.count(split, "encode", 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(work, range(16), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert fake.launches == 16 * 2000 and split["encode"] == 16 * 4000
