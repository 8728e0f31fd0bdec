"""Algorithm layering and file orchestration: the port of raisin_tpu/engine/core.py.

Parity with reference engine/engine.go: stacking N algorithms feeds the full
output of layer k as the input of layer k+1 (engine.go:443-452), and
decompression applies the layers in reverse (engine.go:454-459). A `.rsn`
file has no container or header — layer identity/order is supplied
out-of-band (cmd/cli.go:99,133).

The functions take the JAX package's arguments plus ``device``: it goes to
every ``device`` codec and to the container (None: the CUDA card, and
RuntimeError without one; ``"cpu"`` runs the kernels' plain versions).
``container=True`` writes the RSNB block container of ``parallel/blocks``;
``devices`` shards its blocks over a ``'data'`` mesh (:func:`_resolve_mesh`).
Each codec call runs in a ``stream.compress`` or ``stream.decompress``
profiler range.
"""

from __future__ import annotations

import os
from typing import Iterable

from torch.profiler import record_function

from raisin_tpu_torch import native
from raisin_tpu_torch.engine.registry import expand_algorithms, get_codec
from raisin_tpu_torch.formats import lzss
from raisin_tpu_torch.ops import lzss_stream
from raisin_tpu_torch.parallel.blocks import compress_container, decompress_container
from raisin_tpu_torch.parallel.mesh import DeviceCountError, Mesh, data_mesh

DEFAULT_WINDOW_SIZE = 4096


def compress_bytes(
    data: bytes,
    algorithms: Iterable[str],
    backend: str | None = None,
    window: int | None = None,
    device=None,
) -> bytes:
    """Apply codec layers in order (engine.go:443).

    ``window`` overrides the LZSS search window (lz.NewWriterLevel parity,
    lzss.go:42); other layers ignore it. Decompression never needs it (the
    token format carries explicit distances). Every layer's codec is looked
    up before any runs, so an unknown one raises first.
    """
    codecs = [get_codec(name, backend, device, window) for name in expand_algorithms(list(algorithms))]
    for codec in codecs:
        with record_function("stream.compress"):
            if codec.name == "lzss" and window not in (None, DEFAULT_WINDOW_SIZE):
                data = _lzss_compress_windowed(data, window, codec.backend, device)
            else:
                data = codec.compress(data)
    return data


def _lzss_compress_windowed(data: bytes, window: int, backend: str, device=None) -> bytes:
    """LZSS compress at a non-default window on the selected backend."""
    if backend == "native":
        return native.lzss_compress(data, window)
    if backend == "device":
        return lzss_stream.compress(data, window, device=device)
    return lzss.compress(data, window)


def decompress_bytes(data: bytes, algorithms: Iterable[str], backend: str | None = None, device=None) -> bytes:
    """Apply codec layers in reverse (engine.go:454)."""
    codecs = [get_codec(name, backend, device) for name in reversed(expand_algorithms(list(algorithms)))]
    for codec in codecs:
        with record_function("stream.decompress"):
            data = codec.decompress(data)
    return data


class CompressedFile:
    """Object API parity with reference engine.CompressedFile (engine.go:39).

    ``write`` compresses its argument and appends to ``compressed``;
    ``read`` lazily decompresses ``compressed`` into ``decompressed`` and
    streams it out in chunks.
    """

    def __init__(
        self,
        compression_engine: str = "",
        compressed: bytes = b"",
        max_search_buffer_length: int = DEFAULT_WINDOW_SIZE,
        device=None,
    ) -> None:
        self.compression_engine = compression_engine
        self.compressed = compressed
        self.decompressed: bytes | None = None
        self.max_search_buffer_length = max_search_buffer_length
        self.device = device
        self._pos = 0

    def write(self, content: bytes) -> int:
        chunk = get_codec(self.compression_engine, device=self.device).compress(content)
        self.compressed += chunk
        return len(chunk)

    def read(self, size: int = -1) -> bytes:
        if self.decompressed is None:
            codec = get_codec(self.compression_engine, device=self.device)
            self.decompressed = codec.decompress(self.compressed)
        if size < 0:
            out = self.decompressed[self._pos :]
            self._pos = len(self.decompressed)
            return out
        out = self.decompressed[self._pos : self._pos + size]
        self._pos += len(out)
        return out


def get_compressed_file_from_path(path: str, device=None) -> CompressedFile:
    """Parity with engine.GetCompressedFileFromPath (engine.go:142)."""
    with open(path, "rb") as f:
        return CompressedFile(compressed=f.read(), device=device)


def _resolve_mesh(devices: int | str | None, device=None) -> Mesh | None:
    """Build the 1-D ``'data'`` mesh for the container (raisin_tpu/engine/core.py:106).

    ``devices``: None, 1, "1" or "" -> one device (no mesh); "auto" -> every
    visible device of ``device``'s type (every card for None, one entry for
    the CPU); N -> the first N. A count past what the machine offers raises
    :class:`DeviceCountError` (``parallel.mesh.first_devices``).
    """
    if devices in (None, 1, "1", ""):
        return None
    if devices == "auto":
        return data_mesh(device=device)
    try:
        n = int(devices)
    except ValueError:
        raise DeviceCountError(f"devices={devices!r}: expected a number or 'auto'") from None
    return None if n <= 1 else data_mesh(n, device)


def compress_file(
    algorithms: list[str],
    path: str,
    output: str,
    quiet: bool = False,
    backend: str | None = None,
    container: bool = False,
    block_size: int = 1 << 16,
    devices: int | str | None = None,
    window: int | None = None,
    device=None,
) -> bytes:
    """Parity with engine.CompressFile (engine.go:157).

    With ``container=True`` the output is an RSNB block container (the
    block-parallel path) instead of a raw layered stream; ``devices``
    shards the container's blocks over a ``'data'`` mesh (see
    :func:`_resolve_mesh`, checked before the file is read); ``window``
    sets the LZSS search window (NewWriterLevel parity).
    """
    mesh = _resolve_mesh(devices, device)
    with open(path, "rb") as f:
        contents = f.read()
    if not quiet:
        print("Compressing...")
    if container:
        compressed = compress_container(
            contents, tuple(algorithms), block_size, mesh=mesh,
            window=window if window is not None else DEFAULT_WINDOW_SIZE, device=device,
        )
    else:
        compressed = compress_bytes(contents, algorithms, backend, window=window, device=device)
    with open(output, "wb") as f:
        f.write(compressed)
    if not quiet:
        print(f"Original bytes: {len(contents)}")
        print(f"Compressed bytes: {len(compressed)}")
        ratio = len(compressed) / len(contents) * 100 if contents else float("inf")
        print(f"Compression ratio: {ratio:.2f}%")
    return compressed


def decompress_file(
    algorithms: list[str],
    path: str,
    output: str,
    quiet: bool = False,
    backend: str | None = None,
    devices: int | str | None = None,
    device=None,
) -> bytes:
    """Parity with engine.DecompressFile (engine.go:187); ``devices`` as in :func:`compress_file`."""
    mesh = _resolve_mesh(devices, device)
    with open(path, "rb") as f:
        contents = f.read()
    if not quiet:
        print("Decompressing...")
    if contents[:4] == b"RSNB":
        decompressed = decompress_container(contents, mesh=mesh, device=device)
    else:
        decompressed = decompress_bytes(contents, algorithms, backend, device=device)
    with open(output, "wb") as f:
        f.write(decompressed)
    return decompressed


def compress_files(algorithms: list[str], files: list[str], extension: str, **kw) -> None:
    """Parity with engine.CompressFiles (engine.go:150)."""
    for path in files:
        compress_file(algorithms, path, path + extension, **kw)


def decompress_files(algorithms: list[str], files: list[str], extension: str, **kw) -> None:
    """Parity with engine.DecompressFiles (engine.go:175)."""
    for path in files:
        if extension.strip():
            out = path + extension
        else:
            out = os.path.splitext(path)[0]
        decompress_file(algorithms, path, out, **kw)
