"""The port's native C runtime against the JAX package's and the port's oracle copies.

``raisin_tpu_torch.native`` (its own copy of ``rsn_native.c``, built with
g++ into ``raisin_tpu_torch/_build/native``) must write the bytes of
``raisin_tpu.native`` and of the port's Python copies in ``formats/`` on
tests/test_native.py's cases and windows (tolerance 0: the outputs are
bytes). The copy's token buffer holds any ``<D,L>`` of two longs, so it also
runs at a window of 2^21, where the JAX package's overflows; there it is
held against the port's Python copy alone. Threads and processes that
build into one fresh cache directory at once all load the library, and a
failed build raises ``NativeBuildError``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import raisin_tpu.native
from raisin_tpu.formats import dmc_ref
from raisin_tpu_torch import native
from raisin_tpu_torch.engine import registry
from raisin_tpu_torch.formats import arithmetic, dmc, lzss, mcc
from tests.fixtures import ABC, HELLO, VERSE, random_bytes, random_text

REPO = Path(__file__).resolve().parent.parent

CASES = [
    b"",
    b"a",
    HELLO,
    ABC,
    b"a" * 300,
    VERSE,
    b"<><>,<>",
    b"\x5c\xff<tag>\x5c\x5c",
    random_bytes(3000, seed=90),
    random_text(6000, seed=91),
]
IDS = [f"case{i}" for i in range(len(CASES))]


@pytest.fixture(scope="module", autouse=True)
def _own_native_cache(tmp_path_factory):
    """Builds of the JAX package's native library go to this module's directory."""
    patch = pytest.MonkeyPatch()
    patch.setattr(raisin_tpu.native, "_CACHE", str(tmp_path_factory.mktemp("native")))
    yield
    patch.undo()


@pytest.mark.parametrize("payload", CASES, ids=IDS)
def test_lzss_equals_jax_and_oracle(payload):
    got = native.lzss_compress(payload)
    assert got == raisin_tpu.native.lzss_compress(payload) == lzss.compress(payload)
    assert native.lzss_decompress(got) == payload


@pytest.mark.parametrize("payload", CASES, ids=IDS)
def test_arithmetic_equals_jax_and_oracle(payload):
    got = native.arith_compress(payload)
    assert got == raisin_tpu.native.arith_compress(payload) == arithmetic.compress(payload)
    assert native.arith_decompress(got) == payload


@pytest.mark.parametrize("payload", CASES, ids=IDS)
def test_mcc_equals_jax_and_oracle(payload):
    got = native.mcc_compress(payload)
    assert got == raisin_tpu.native.mcc_compress(payload) == mcc.compress(payload)
    if not payload:  # just the separator: Atoi("") panics in the reference (mcc.go:401)
        with pytest.raises(ValueError):
            native.mcc_decompress(got)
        return
    assert native.mcc_decompress(got) == mcc.decompress(got) == payload


@pytest.mark.parametrize("payload", CASES, ids=IDS)
def test_dmc_equals_jax_and_oracle(payload):
    try:
        want = dmc.compress(payload)
    except dmc.DmcError:  # a NUL whose only stack match is the root (dmc.go:43-51)
        with pytest.raises(dmc.DmcError):
            native.dmc_compress(payload)
        with pytest.raises(dmc_ref.DmcError):
            raisin_tpu.native.dmc_compress(payload)
        return
    assert native.dmc_compress(payload) == raisin_tpu.native.dmc_compress(payload) == want
    assert native.dmc_decompress(want) == dmc.decompress(want) == b"Hello!"


@pytest.mark.parametrize("window", [1024, 4096, 8192])
def test_lzss_windows_equal_jax_and_oracle(window):
    chunk = b"0123456789unique-pattern-here"
    data = chunk + random_bytes(5000, seed=92) + chunk
    got = native.lzss_compress(data, window)
    assert got == raisin_tpu.native.lzss_compress(data, window) == lzss.compress(data, window)
    assert native.lzss_decompress(got) == data


def test_lzss_window_2_21_equals_oracle():
    """A 4 KiB text repeated to 2 MiB: the greedy parse doubles its matches, up to
    "<1048576,1048576>", 17 bytes, one past the JAX package's token buffer."""
    data = random_text(4096, seed=5) * 512
    got = native.lzss_compress(data, 1 << 21)
    assert b"<1048576,1048576>" in got
    assert got == lzss.compress(data, 1 << 21)
    assert native.lzss_decompress(got) == lzss.decompress(got) == data


def test_arithmetic_freeze_path_equals_jax():
    payload = random_text(20_000, seed=93)
    got = native.arith_compress(payload)
    assert got == raisin_tpu.native.arith_compress(payload) == arithmetic.compress(payload)
    assert native.arith_decompress(got) == payload


def test_long_runs_equal_oracle():
    zs = b"\x00" * 3000
    assert native.lzss_compress(zs, 4096) == lzss.compress(zs, 4096)
    z = b"\x00" * 200_000
    assert native.lzss_decompress(native.lzss_compress(z, 4096)) == z


def test_garbage_raises_like_jax():
    for port_fn, jax_fn, bad in (
        (native.arith_decompress, raisin_tpu.native.arith_decompress, b"\x00\x00\x00"),  # no sentinel bit
        (native.lzss_decompress, raisin_tpu.native.lzss_decompress, b"<999,999>"),  # outside the window
        (native.mcc_decompress, raisin_tpu.native.mcc_decompress, b"12,abc\\xyz"),
        (native.mcc_decompress, raisin_tpu.native.mcc_decompress, b"no separator at all"),
    ):
        with pytest.raises(ValueError) as port_err:
            port_fn(bad)
        with pytest.raises(ValueError) as jax_err:
            jax_fn(bad)
        assert str(port_err.value) == str(jax_err.value)


def test_dmc_rc_minus_3_raises_the_ports_error():
    with pytest.raises(dmc.DmcError, match="stack emptied"):
        native.dmc_compress(b"\x00")
    assert not issubclass(dmc.DmcError, dmc_ref.DmcError)


def test_registered_as_native_backend():
    for name, compress in (("lzss", lzss.compress), ("arithmetic", arithmetic.compress),
                           ("mcc", mcc.compress), ("dmc", dmc.compress)):
        codec = registry.get_codec(name, "native")
        assert codec.backend == "native"
        assert codec.compress(VERSE) == compress(VERSE)
    for name in ("mcc", "dmc"):  # no device codec: auto takes native
        assert registry.get_codec(name).backend == "native"
    # the device codecs decode a raw stream with the C runtime: its messages are the JAX native's
    for name, jax_fn, bad in (("arithmetic", raisin_tpu.native.arith_decompress, b"\x00\x00\x00"),
                              ("lzss", raisin_tpu.native.lzss_decompress, b"<999,999>")):
        with pytest.raises(ValueError) as port_err:
            registry.get_codec(name, "device", device="cpu").decompress(bad)
        with pytest.raises(ValueError) as jax_err:
            jax_fn(bad)
        assert str(port_err.value) == str(jax_err.value)


def _fresh(monkeypatch, cache: Path) -> None:
    monkeypatch.setattr(native, "_CACHE", str(cache))
    monkeypatch.setattr(native, "_lib", None)


def test_threads_build_once_into_a_fresh_cache(tmp_path, monkeypatch):
    _fresh(monkeypatch, tmp_path)
    out, errors = [], []

    def run():
        try:
            out.append(native.arith_compress(VERSE))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and out == [arithmetic.compress(VERSE)] * 4
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]


def test_processes_build_into_one_fresh_cache(tmp_path):
    code = (
        "import sys\n"
        "from raisin_tpu_torch import native\n"
        "native._CACHE = sys.argv[1]\n"
        "sys.stdout.write(native.arith_compress(b'two processes build at once').hex())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    want = arithmetic.compress(b"two processes build at once").hex()
    assert [o for o, _ in outs] == [want, want]
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]  # no temporary file left


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.c"
    bad.write_text("this is not C\n")
    _fresh(monkeypatch, tmp_path / "cache")
    monkeypatch.setattr(native, "_SRC", str(bad))
    with pytest.raises(native.NativeBuildError, match="native build failed"):
        native.lzss_compress(b"abc")
    assert list((tmp_path / "cache").iterdir()) == []
