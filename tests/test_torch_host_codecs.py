"""The port's host-only codecs against the JAX package's, byte for byte.

``raisin_tpu_torch/formats/stdlib_codecs.py``, ``mcc.py`` and ``dmc.py``
are copies of ``raisin_tpu/formats/stdlib_codecs.py``, ``mcc_ref.py`` and
``dmc_ref.py``: each function must give the original's bytes and raise its
errors. Through the engine, ``mcc``, ``dmc``, ``flate``, ``gzip``, ``lzw``,
``zlib``, ``all`` and ``suite`` must write the JAX package's streams with
every backend the codec has, and each package must decode the other's
(tolerance 0: the outputs are bytes).
"""

from __future__ import annotations

import pytest
import torch

import raisin_tpu
import raisin_tpu.native
import raisin_tpu_torch
from raisin_tpu.formats import dmc_ref, mcc_ref
from raisin_tpu.formats import stdlib_codecs as jax_stdlib
from raisin_tpu_torch.engine import registry
from raisin_tpu_torch.formats import dmc, mcc, stdlib_codecs
from tests.fixtures import ABC, HELLO, UNICODE_TEXT, VERSE, random_bytes, random_text

torch.set_num_threads(1)

CPU = "cpu"
CASES = {
    "empty": b"",
    "one": b"a",
    "hello": HELLO,
    "abc": ABC,
    "run": b"a" * 300,
    "verse": VERSE,
    "unicode": UNICODE_TEXT,
    "tokens": b"<><>,<>\x5c\xff<tag>\x5c\x5c",
    "binary": random_bytes(3000, seed=90),
    "text": random_text(6000, seed=91),
    "nul": b"ab\x00cd",
}
STDLIB = ["flate", "gzip", "zlib", "lzw"]
HOST_ONLY = ["mcc", "dmc", *STDLIB]


@pytest.fixture(scope="module", autouse=True)
def _own_native_cache(tmp_path_factory):
    """Builds of the JAX package's native library go to this module's directory."""
    patch = pytest.MonkeyPatch()
    patch.setattr(raisin_tpu.native, "_CACHE", str(tmp_path_factory.mktemp("native")))
    yield
    patch.undo()


def _result(fn, data):
    """fn(data), or the type and message of the exception it raised."""
    try:
        return fn(data)
    except Exception as e:  # noqa: BLE001 — compared below
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", STDLIB)
@pytest.mark.parametrize("case", CASES)
def test_stdlib_copy_equals_original(name, case):
    data = CASES[case]
    port_c, jax_c = getattr(stdlib_codecs, f"{name}_compress"), getattr(jax_stdlib, f"{name}_compress")
    port_d, jax_d = getattr(stdlib_codecs, f"{name}_decompress"), getattr(jax_stdlib, f"{name}_decompress")
    c = port_c(data)
    assert c == jax_c(data)
    assert port_d(c) == jax_d(c) == data
    # a cut stream fails the same way in both
    assert _result(port_d, c[: len(c) // 2]) == _result(jax_d, c[: len(c) // 2])


def test_lzw_table_reset_equals_original():
    """Past 4095 codes the writer emits the clear code and starts again (Go's compress/lzw)."""
    data = random_bytes(40_000, seed=94)
    c = stdlib_codecs.lzw_compress(data)
    assert c == jax_stdlib.lzw_compress(data)
    assert stdlib_codecs.lzw_decompress(c) == data


@pytest.mark.parametrize("case", CASES)
def test_mcc_copy_equals_original(case):
    data = CASES[case]
    c = _result(mcc.compress, data)
    assert c == _result(mcc_ref.compress, data)
    if isinstance(c, bytes):
        assert _result(mcc.decompress, c) == _result(mcc_ref.decompress, c)


@pytest.mark.parametrize("case", CASES)
def test_dmc_copy_equals_original(case):
    data = CASES[case]
    c = _result(dmc.compress, data)
    assert c == _result(dmc_ref.compress, data)
    assert dmc.decompress(data) == dmc_ref.decompress(data) == b"Hello!"
    if isinstance(c, bytes):  # the in-memory decoder over the copy's chain and transitions
        chain = dmc.build_chain(data)
        dmc._sort_nodes(chain)
        transitions = dmc.chain_to_transitions(chain, data)
        ref_chain = dmc_ref.build_chain(data)
        dmc_ref._sort_nodes(ref_chain)
        assert transitions == dmc_ref.chain_to_transitions(ref_chain, data)
        assert dmc.decode_with_chain(transitions, chain) == dmc_ref.decode_with_chain(transitions, ref_chain)


@pytest.mark.parametrize("name", HOST_ONLY + ["all", "suite"])
def test_engine_equals_jax_on_every_backend(name):
    data = CASES["verse"]
    want = raisin_tpu.compress_bytes(data, [name], backend="host")
    backends = registry.available_backends(name) if name in registry._IMPLS else ["host", "native", "device"]
    for backend in backends:
        got = raisin_tpu_torch.compress_bytes(data, [name], backend=backend, device=CPU)
        assert got == want, backend
        assert raisin_tpu_torch.decompress_bytes(got, [name], backend=backend, device=CPU) == \
            raisin_tpu.decompress_bytes(got, [name], backend="host")


def test_suites_expand_like_jax():
    for name in ("all", "suite"):
        assert registry.expand_algorithms([name]) == raisin_tpu.engine.registry.expand_algorithms([name])
        assert all(registry.available_backends(n) for n in registry.expand_algorithms([name]))
