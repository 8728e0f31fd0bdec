"""The kernel build of ``raisin_tpu_torch/ops/_build.py`` under threads, with a stub nvcc.

The benchmark table runs each row in its own thread, so several threads
may ask for the kernel library at once. A stub ``nvcc`` on ``PATH`` logs
each call and writes the file it is asked for, and ``ctypes.CDLL`` is
stubbed: two threads calling ``library()`` together must compile each
source once and link once, into objects and a temporary library named by
process and thread, and get the same library.
"""

from __future__ import annotations

import os
import stat
import threading
import types

import pytest

from raisin_tpu_torch.ops import _build

STUB_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
case "$1" in --version) echo "stub nvcc, release 0.0"; exit 0;; esac
sleep 0.2
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then : > "$2"; fi
  shift
done
"""


class _FakeLib:
    """Every attribute is a namespace that takes argtypes and restype."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    bindir, log = tmp_path / "bin", tmp_path / "nvcc.log"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or _FakeLib())
    monkeypatch.setattr(_build, "_lib", None)
    yield log, loaded


def test_two_threads_build_once(stub_nvcc):
    log, loaded = stub_nvcc
    libs, errors = [], []

    def run():
        try:
            libs.append(_build.library())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(libs) == 2 and libs[0] is libs[1]
    calls = [line.split() for line in log.read_text().splitlines() if "--version" not in line]
    sources = sorted(_build.CSRC.glob("*.cu"))
    compiles = [c for c in calls if "-c" in c]
    links = [c for c in calls if "-c" not in c]
    assert len(compiles) == len(sources) and len(links) == 1 and len(loaded) == 1
    # objects and the temporary library carry the process and the building thread
    tag = f".{os.getpid()}."
    outputs = [c[c.index("-o") + 1] for c in calls]
    assert all(tag in os.path.basename(o) for o in outputs)
    assert len({os.path.basename(o).split(tag)[1].split(".")[0] for o in outputs}) == 1
    # only the library is left in the build directory
    assert [p.suffix for p in _build.BUILD_DIR.iterdir()] == [".so"]
    assert loaded == [str(_build.BUILD_DIR / _build.library_name("stub nvcc, release 0.0\n"))]


def test_failed_compile_raises_and_cleans_up(stub_nvcc, tmp_path, monkeypatch):
    log, _ = stub_nvcc
    (tmp_path / "bin" / "nvcc").write_text(
        f'#!/bin/sh\necho "$@" >> "{log}"\ncase "$1" in --version) echo v; exit 0;; esac\necho boom >&2\nexit 1\n'
    )
    with pytest.raises(_build.KernelBuildError, match="boom"):
        _build.library()
    assert list(_build.BUILD_DIR.iterdir()) == []
