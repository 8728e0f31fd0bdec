"""Build and load the port's CUDA kernels (route: nvcc -> .so -> ctypes).

The pattern follows raisin_tpu/native/__init__.py: a hash of the sources,
the nvcc flags and ``nvcc --version`` names the library, it is built on first use (one nvcc
process per source, in parallel, then a link) and loaded with ctypes. The
sources are ``raisin_tpu_torch/csrc/*.cu`` (plus their ``*.cuh``); the
library lands in ``raisin_tpu_torch/_build/``. Nothing here runs at import
time, and a failed build raises: no caller falls back to a plain version.
Threads may ask for the library at once (the benchmark table runs each
row in its own thread): :func:`build` holds a module lock, and
:func:`library` loads the library once under the same lock, so a process
builds once; the objects and the temporary library are named by process
and thread, so processes do not collide either.

Every exported function returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into a RuntimeError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# exported C function -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "rsn_arith_encode": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rsn_arith_prepad": [_P, _P, _P, _P, _I, _I, _P],
    "rsn_arith_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rsn_arith_events": [_P, _P, _P, _P, _P, _I, _I, _P],
    "rsn_lzss_match": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rsn_lzss_commit": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "rsn_lzss_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rsn_huffman_encode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rsn_huffman_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


_lib = None
_lock = threading.RLock()


class KernelBuildError(RuntimeError):
    pass


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cuda_nvcc):
        return cuda_nvcc
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def library_name(nvcc_version: str) -> str:
    """The library's file name: a hash of the flags, the compiler and the sources."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version.encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return f"raisin_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if no library of this name exists yet.

    Each source compiles in its own nvcc process, all started together;
    one more nvcc call links the objects into the library.
    """
    with _lock:
        nvcc = _nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout
        so_path = BUILD_DIR / library_name(version)
        if so_path.exists():
            return so_path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so_path.stem}.{os.getpid()}.{threading.get_ident()}"
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({' '.join(cmd)}):\n{err}")
        objs = [obj for _, obj, _ in jobs]
        try:
            if failed:
                raise KernelBuildError("\n".join(failed))
            tmp = BUILD_DIR / f"{tag}.so.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(o) for o in objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelBuildError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
            os.replace(tmp, so_path)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        return so_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once for all threads)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rsn_error_string.argtypes = [ctypes.c_int]
        lib.rsn_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(name: str, rc: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = library().rsn_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle for ctypes."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
