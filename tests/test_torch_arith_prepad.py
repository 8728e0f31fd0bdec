"""Kernel B (csrc/arith_prepad.cu) modelled on the CPU, against the plain
version, the prepad of the JAX package and its Pallas encode.

Kernel B runs only on the card. Its grid is 2D: a row a blockIdx.y (rows
past the grid's height in strides) and chunks of THREADS quads along x.
Each thread takes a quad of QUAD output words aligned to 16 bytes in the
output row, so a row that starts off 16 bytes begins with a cut quad. A
quad at or past the row's live end, ceil((T + pad) / 32) words, is stored
as zeros without a load; a live quad loads its raw words (one 16-byte load
where the raw row is aligned alike and all four hold stream bits, else word
by word) and the word before them, and no raw word at or past ceil(T / 32)
is read. ``_prepad_model`` mirrors that in numpy, with the constants read
from the kernel's source, records every raw word it loads and asserts that
none lies past the live end. It is held, exactly (tolerance 0: bytes and
integers), against the plain version ``arithmetic_rows._prepad_torch``
(the wrapper's route for CPU tensors), against
``raisin_tpu.bitkit.packing.pack_prepad_sentinel`` and, on rows of the plain
kernel A, against ``raisin_tpu.ops.arithmetic_pallas.encode_rows`` in
interpret mode. The kernel's own source runs here too, built with g++ over
``tests/cuda_host/cuda_emu.h`` (a 2D grid), on rows whose words past the live
end lie on a page that the process may not read: an aligned 16-byte load
never crosses a page, so that guard catches loads word by word, and the
model checks the condition of the 16-byte load.
"""

from __future__ import annotations

import functools
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from raisin_tpu.bitkit.packing import pack_prepad_sentinel
from raisin_tpu.formats import arithmetic_ref
from raisin_tpu.ops import arithmetic_pallas as ap
from raisin_tpu_torch.ops import arithmetic_rows as ar
from tests.test_torch_arith_rows import _blocks, _symbols

torch.set_num_threads(1)

CSRC = Path(ar.__file__).resolve().parent.parent / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"
M32 = 0xFFFFFFFF


@functools.cache
def _constants() -> dict[str, int]:
    """Kernel B's integer constants, read from its source (the model mirrors them)."""
    src = (CSRC / "arith_prepad.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


K = _constants()


# ---------------------------------------------------------------------------
# The model


def _prepad_model(raw: np.ndarray, bits: np.ndarray, skew: np.ndarray | None = None, grid_y: int | None = None):
    """Kernel B's decomposition: (rows (B, 4 * capw) uint8, byte_lens, stats).

    ``skew[b]`` is row b's words before its first 16-byte boundary in the
    output (0 where the rows are aligned, as the wrapper's are), and the raw
    row is aligned alike; ``grid_y`` the launch's rows (the kernel's
    MAX_GRID_Y)."""
    B, capw = raw.shape
    quad, threads = K["QUAD"], K["THREADS"]
    skew = np.zeros(B, dtype=np.int64) if skew is None else skew
    grid_y = min(B, grid_y or K["MAX_GRID_Y"])
    quads = (capw + 3 + quad - 1) // quad  # a row's quads at the largest skew
    grid_x = (quads + threads - 1) // threads
    u = raw.astype(np.int64) & M32
    out = np.full((B, capw), -1, dtype=np.int64)  # -1: no store
    byte_lens = np.full(B, -1, dtype=np.int64)
    stats = {"vector": 0, "scalar": 0, "zero": 0, "loads": 0}
    for y in range(grid_y):
        for b in range(y, B, grid_y):
            T = int(bits[b])
            pad = 8 - (T & 7)
            live_raw = min((T + 31) >> 5, capw) if T > 0 else 0
            live_out = min(max((T + pad + 31) >> 5, 1), capw)
            loaded: set[int] = set()

            def word(i: int) -> int:
                if i < 0:
                    return 1 if i == -1 else 0
                if i >= live_raw:
                    return 0
                loaded.add(i)
                keep = T - 32 * i
                return int(u[b, i]) & ~(M32 >> keep) & M32 if keep < 32 else int(u[b, i])

            for q in range(grid_x * threads):
                j0 = quad * q - int(skew[b])
                if j0 >= capw:
                    continue
                if q == 0:
                    byte_lens[b] = (T + pad) >> 3
                vals = [0] * quad
                if j0 < live_out:
                    if j0 >= 0 and j0 + quad <= live_raw:  # the 16-byte load
                        stats["vector"] += 1
                        cur = [word(j0 + k) for k in range(quad)]
                    else:
                        stats["scalar"] += 1
                        cur = [word(j0 + k) if j0 + k < live_out else 0 for k in range(quad)]
                    prev = word(j0 - 1)
                    for k in range(quad):
                        if j0 + k < live_out:
                            v = ((prev << (32 - pad)) | (cur[k] >> pad)) & M32
                            vals[k] = int.from_bytes(v.to_bytes(4, "big"), "little")
                        prev = cur[k]
                else:
                    stats["zero"] += 1
                for k in range(quad):
                    if 0 <= j0 + k < capw:
                        assert out[b, j0 + k] == -1  # every word stored once
                        out[b, j0 + k] = vals[k]
            assert all(i < live_raw for i in loaded)  # no raw word past the live end
            stats["loads"] += len(loaded)
    assert (out >= 0).all() and (byte_lens >= 0).all()
    return out.astype("<u4").view(np.uint8).reshape(B, 4 * capw), byte_lens.astype(np.int32), stats


def _plain(raw: np.ndarray, bits: np.ndarray):
    rows, bl = ar.prepad_rows(torch.from_numpy(raw.astype(np.uint32).view(np.int32)),
                              torch.from_numpy(bits.astype(np.int32)))
    return rows.numpy(), bl.numpy()


def _stream_rows(streams: list[np.ndarray], capw: int, garbage: bool, seed: int = 0):
    """Bit streams -> (raw (B, capw) uint32 MSB-first, bits): zeros past each stream, or garbage."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**32, size=(len(streams), capw), dtype=np.uint64).astype(np.uint32) if garbage \
        else np.zeros((len(streams), capw), dtype=np.uint32)
    for r, s in enumerate(streams):
        n = min(len(s), 32 * capw)
        words = np.packbits(np.pad(s[:n], (0, 32 * capw - n))).view(">u4").astype(np.uint32)
        if garbage:  # keep the garbage past the stream, also in its last word
            m = np.zeros(32 * capw, dtype=np.uint8)
            m[:n] = 1
            keep = np.packbits(m).view(">u4").astype(np.uint32)
            words = (words & keep) | (raw[r] & ~keep)
        raw[r] = words
    return raw, np.array([len(s) for s in streams], dtype=np.int64)


def _case(name: str):
    """(raw (B, capw) uint32, bits (B,)) of the named input."""
    rng = np.random.default_rng(len(name))
    capw = 23
    edge = [0, 1, 7, 8, 31, 32, 33, 40, 64, 96, 255, 256, 32 * capw - 8, 32 * capw - 1, 32 * capw]
    if name == "edges":  # pad 8, T = 0, multiples of 32, a stream that fills capw exactly
        streams = [rng.integers(0, 2, size=T, dtype=np.uint8) for T in edge]
        return _stream_rows(streams, capw, garbage=False)
    if name == "garbage past T":
        streams = [rng.integers(0, 2, size=T, dtype=np.uint8) for T in edge]
        return _stream_rows(streams, capw, garbage=True, seed=1)
    if name == "past capw":  # kernel A's overflow: bits counts past the row
        raw, _ = _stream_rows([rng.integers(0, 2, size=32 * capw, dtype=np.uint8)], capw, garbage=False)
        return raw, np.array([32 * capw + 13])
    if name.startswith("capw % 4 = "):  # rows at every word skew of 16 bytes
        capw = 4 * 9 + int(name[-1])
        Ts = rng.integers(0, 32 * capw - 8, size=11)
        return _stream_rows([rng.integers(0, 2, size=T, dtype=np.uint8) for T in Ts], capw, garbage=True, seed=2)
    raise KeyError(name)


CASES = ["edges", "garbage past T", "past capw", "capw % 4 = 0", "capw % 4 = 1", "capw % 4 = 2", "capw % 4 = 3"]


# ---------------------------------------------------------------------------
# The model's tests


def test_model_reads_kernel_constants():
    assert K["QUAD"] == 4  # one 16-byte store a thread
    assert K["MAX_GRID_Y"] == 65535 and K["THREADS"] % 32 == 0


@pytest.mark.parametrize("name", CASES)
def test_model_matches_plain(name):
    raw, bits = _case(name)
    rows, bl, stats = _prepad_model(raw, bits)
    want = _plain(raw, bits)
    assert np.array_equal(rows, want[0]) and np.array_equal(bl, want[1])
    for r, T in enumerate(bits):
        if T + 8 - T % 8 <= 32 * raw.shape[1]:  # the whole stream fits the row
            stream = np.unpackbits(raw[r].astype(">u4").view(np.uint8))[:T]
            assert rows[r, : bl[r]].tobytes() == pack_prepad_sentinel(stream)
    assert stats["loads"] <= sum(min(-(-int(T) // 32), raw.shape[1]) for T in bits)


@pytest.mark.parametrize("skew", [1, 2, 3])
def test_model_matches_plain_at_every_skew(skew):
    """Output rows that start `skew` words past 16 bytes: cut quads at both ends, the same bytes."""
    raw, bits = _case("capw % 4 = 1")
    rows, bl, stats = _prepad_model(raw, bits, skew=np.full(len(bits), skew))
    assert stats["scalar"] >= len(bits)
    for g, w in zip((rows, bl), _plain(raw, bits)):
        assert np.array_equal(g, w)


def test_model_strides_rows_past_the_grid():
    raw, bits = _case("capw % 4 = 2")
    rows, bl, _ = _prepad_model(raw, bits, grid_y=4)
    for g, w in zip((rows, bl), _plain(raw, bits)):
        assert np.array_equal(g, w)


def test_model_on_plain_a_matches_pallas_interpret_and_oracle():
    """Kernel A's plain rows of 128 blocks through the model equal the Pallas encode's rows."""
    S, B = 512, 128
    blocks = _blocks(S, B)
    symbols, lengths = _symbols(blocks, S)
    rows_j, bl_j, of_j = (np.asarray(a) for a in ap.encode_rows(symbols, lengths, capw=1024, interpret=True))
    raw, bits, oflow = ar.encode_bits(torch.from_numpy(symbols), torch.from_numpy(lengths), ar.capw_bound(S))
    assert not oflow.any()
    rows, bl, stats = _prepad_model(raw.numpy().view(np.uint32), bits.numpy())
    assert np.array_equal(bl, bl_j) and stats["zero"] > 0
    for i, p in enumerate(blocks):
        got = rows[i, : bl[i]].tobytes()
        if not of_j[i]:
            assert got == rows_j[i].tobytes()[: bl_j[i]], i
        assert got == arithmetic_ref.compress(p), i


# ---------------------------------------------------------------------------
# The kernel's own source on the host: arith_prepad.cu built with g++ over
# cuda_host/cuda_emu.h. In guard mode each row is launched alone, with its
# words from ceil(T / 32) on placed on pages that the process may not read,
# so a load past the live end ends the process.

HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/mman.h>
#include <unistd.h>
int main(int argc, char** argv) {  // B capw skew guard in out: raw, bits -> rows, byte_lens
    const int B = atoi(argv[1]), capw = atoi(argv[2]), skew = atoi(argv[3]), guard = atoi(argv[4]);
    std::vector<uint32_t> raw((size_t)B * capw);
    std::vector<int32_t> bits(B), lens(B, -1);
    FILE* f = fopen(argv[5], "rb");
    if (fread(raw.data(), 4, raw.size(), f) + fread(bits.data(), 4, B, f) != raw.size() + B) return 1;
    fclose(f);
    const size_t tail = 16;  // words after the rows that no store may touch
    std::vector<uint32_t> obuf((size_t)B * capw + skew + tail + 4);
    uint32_t* out = obuf.data() + ((4 - (((uintptr_t)obuf.data() >> 2) & 3)) & 3) + skew;
    for (size_t i = 0; i < (size_t)B * capw + tail; ++i) out[i] = 0xA5A5A5A5u;
    int rc = 0;
    if (!guard) {
        std::vector<uint32_t> rbuf(raw.size() + 4);
        uint32_t* in = rbuf.data() + ((4 - (((uintptr_t)rbuf.data() >> 2) & 3)) & 3) + skew;  // aligned as out
        memcpy(in, raw.data(), 4 * raw.size());
        rc = rsn_arith_prepad(in, bits.data(), out, lens.data(), B, capw, nullptr);
    } else {
        const size_t page = (size_t)sysconf(_SC_PAGESIZE);
        for (int b = 0; b < B && rc == 0; ++b) {
            const long long T = bits[b];
            const size_t live = T > 0 ? std::min<long long>((T + 31) / 32, capw) : 0;
            const size_t head = (4 * live + page - 1) / page * page, rest = (4 * (capw - live) + page - 1) / page * page + page;
            char* m = (char*)mmap(nullptr, head + rest, PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
            if (m == MAP_FAILED) return 4;
            uint32_t* in = (uint32_t*)(m + head) - live;  // word `live` starts the unreadable pages
            memcpy(in, raw.data() + (size_t)b * capw, 4 * live);
            if (mprotect(m + head, rest, PROT_NONE)) return 4;
            std::vector<uint32_t> one((size_t)capw + 4);
            uint32_t* o = one.data() + ((4 - (((uintptr_t)one.data() >> 2) & 3)) & 3) + (((uintptr_t)in >> 2) & 3);
            rc = rsn_arith_prepad(in, &bits[b], o, &lens[b], 1, capw, nullptr);
            memcpy(out + (size_t)b * capw, o, 4 * (size_t)capw);
            munmap(m, head + rest);
        }
    }
    f = fopen(argv[6], "wb");
    fwrite(out, 4, (size_t)B * capw, f);
    fwrite(lens.data(), 4, B, f);
    fclose(f);
    for (size_t i = (size_t)B * capw; i < (size_t)B * capw + tail; ++i)
        if (out[i] != 0xA5A5A5A5u) return 3;  // a store past the last row
    return rc;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """A function running kernel B's source, built for the CPU, on numpy raw rows."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build kernel B's source for the host")
    tmp = tmp_path_factory.mktemp("arith_prepad_host")
    cu = (CSRC / "arith_prepad.cu").read_text()
    # name<<<grid, block, smem, stream>>>(args) -> emu_launch(name, grid, block, args)
    cu = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\)?)",
                lambda m: f"emu_launch({m[1]}, {m[2]}, {m[3]}{')' if m[4] else ', '}", cu)
    src = tmp / "arith_prepad_host.cpp"
    src.write_text('#include "cuda_emu.h"\n' + cu + HOST_MAIN)
    exe = tmp / "arith_prepad_host"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(HOST), "-I", str(CSRC), "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(raw, bits, skew: int = 0, guard: bool = False):
        B, capw = raw.shape
        inp, out = tmp / "in.bin", tmp / "out.bin"
        inp.write_bytes(raw.astype(np.uint32).tobytes() + bits.astype(np.int32).tobytes())
        subprocess.run([str(exe), str(B), str(capw), str(skew), str(int(guard)), str(inp), str(out)], check=True)
        r = out.read_bytes()
        n = 4 * B * capw
        return np.frombuffer(r[:n], np.uint8).reshape(B, 4 * capw), np.frombuffer(r[n:], np.int32)

    return run


@pytest.mark.parametrize("skew", [0, 1, 3])
@pytest.mark.parametrize("name", CASES)
def test_kernel_source_on_host_matches_plain(host_kernel, name, skew):
    raw, bits = _case(name)
    got = host_kernel(raw, bits, skew)
    for g, w in zip(got, _plain(raw, bits)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("name", ["edges", "garbage past T", "capw % 4 = 3"])
def test_kernel_source_on_host_reads_no_word_past_the_live_end(host_kernel, name):
    raw, bits = _case(name)
    got = host_kernel(raw, bits, guard=True)
    for g, w in zip(got, _plain(raw, bits)):
        assert np.array_equal(g, w)


def test_kernel_source_on_host_matches_pallas_interpret(host_kernel):
    S, B = 512, 128
    blocks = _blocks(S, B)
    symbols, lengths = _symbols(blocks, S)
    rows_j, bl_j, of_j = (np.asarray(a) for a in ap.encode_rows(symbols, lengths, capw=1024, interpret=True))
    raw, bits, _ = ar.encode_bits(torch.from_numpy(symbols), torch.from_numpy(lengths), ar.capw_bound(S))
    rows, bl = host_kernel(raw.numpy().view(np.uint32), bits.numpy())
    assert np.array_equal(bl, bl_j)
    for i in range(B):
        if not of_j[i]:
            assert rows[i, : bl[i]].tobytes() == rows_j[i].tobytes()[: bl_j[i]], i
    for g, w in zip((rows, bl), _plain(raw.numpy().view(np.uint32), bits.numpy())):
        assert np.array_equal(g, w)
