"""Kernel G (csrc/huffman_encode.cu) modelled on the CPU, against the plain
version, the oracles and the JAX package.

Kernel G runs only on the card. Its grid covers every (block, tile) of TILE
symbols; a tile takes its (block, tile) from an atomic ticket, sums its
threads' code lengths (PER_THREAD consecutive symbols a thread), publishes
that aggregate, and warp 0 looks back over the block's earlier tiles, 32
status words at a time, summing aggregates until it meets an inclusive
prefix. Meanwhile each thread builds its codes in a 64-bit window into an
image of the tile's bits that starts on a word boundary (it stores the
words whose first bit is its own, and ORs its bits in the word before them,
its head, after a barrier), and the CTA writes the image to the row shifted
by the tile's offset (plain stores inside, OR on the first and last words,
which the neighbouring tiles share). ``_encode_model`` mirrors that in numpy
and Python, with the constants read from the kernel's source, and asserts
the kernel's ownership rules: every word of the image is stored once, by
its owner, before any head is ORed into it, and no row word that one tile
stores plainly is touched by another. The look-back
runs on snapshots of the status words in which each earlier tile has
published either its aggregate or its inclusive prefix. The model is held,
exactly (tolerance 0: bytes and integers), against the plain version
``huffman_rows._encode_rows_torch`` (the wrapper's route for CPU tensors),
the port's copy of the oracle, ``raisin_tpu.formats.huffman_ref`` and the
Pallas kernel ``raisin_tpu.ops.huffman_pallas.encode_rows_huffman`` in
interpret mode. The kernel's own source runs here too, built with g++ over
``tests/cuda_host/cuda_emu.h`` (a CTA's threads as threads, warps exchanging
through barriers, CTAs in ticket order), against the same references.
"""

from __future__ import annotations

import functools
import re
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from raisin_tpu.formats import huffman_ref
from raisin_tpu_torch.formats import huffman as port_hf
from raisin_tpu_torch.ops import huffman_blocks, huffman_rows
from tests.test_torch_huffman import _fibonacci_block, _interp_case, split_packed_codes
from tests.go_heap import jax_heap_at_go_rule  # noqa: F401  (a fixture)

# the JAX oracle builds Go's Huffman tree here, as the port does (tests/go_heap.py)
pytestmark = pytest.mark.usefixtures("jax_heap_at_go_rule")

torch.set_num_threads(1)

CSRC = Path(huffman_rows.__file__).resolve().parent.parent / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"
M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
AGGREGATE, INCLUSIVE = 1, 2  # a status word's flags


@functools.cache
def _constants() -> dict[str, int]:
    """Kernel G's integer constants, read from its source (the model mirrors them)."""
    src = (CSRC / "huffman_encode.cu").read_text()
    out: dict[str, int] = {}
    for k, v in re.findall(r"constexpr int (\w+) = ([\w */+-]+);", src):  # integer arithmetic on earlier ones
        out[k] = eval(v.replace(" / ", " // "), {}, dict(out))
    return out


K = _constants()


# ---------------------------------------------------------------------------
# The model


def _look_back(status: list, t: int, stats: dict) -> int:
    """Warp 0's walk: the bits of the block's tiles before tile t, from (flag, value) status words."""
    prefix, look = 0, t - 1
    while True:
        win = [status[look - lane] if look - lane >= 0 else (INCLUSIVE, 0) for lane in range(32)]
        assert all(flag for flag, _ in win)  # every tile waited on has published
        stats["windows"] += 1
        done = [flag == INCLUSIVE for flag, _ in win]
        upto = done.index(True) if any(done) else 31
        prefix += sum(v for _, v in win[: upto + 1])
        if any(done):
            return prefix
        look -= 32


def _thread_codes(xb: np.ndarray, n: int, i0: int, code: np.ndarray, length: np.ndarray):
    """A thread's PER_THREAD (code, length) pairs: no code for bytes >= 128 or past the block."""
    per = K["PER_THREAD"]
    c = np.full(per, 0x80, dtype=np.int64)
    live = max(0, min(per, n - i0))
    c[:live] = xb[i0 : i0 + live]
    has = c < K["NSYM"]
    cc = np.where(has, c, 0)
    return np.where(has, code[cc], 0), np.where(has, length[cc], 0)


def _build(codes_k, lens_k, first: int, image: dict, owner: dict, tid: int) -> int:
    """One thread's codes into the tile's image through its 64-bit window: it stores the words whose
    first bit is its own (zeros past its bits included) and returns its head, its bits in the word
    that an earlier thread owns (0 if none)."""
    wi, fill = first >> 5, first & 31
    owned = fill == 0
    acc = head = 0
    for c, l in zip(codes_k.tolist(), lens_k.tolist()):
        acc |= c << (64 - fill - l) if l else 0
        fill += l
        if fill >= 32:
            if owned:
                assert wi not in owner  # every word stored once
                image[wi], owner[wi] = acc >> 32, tid
            else:
                head = acc >> 32
            owned = True
            acc = (acc << 32) & M64
            fill -= 32
            wi += 1
    if fill:
        if owned:
            assert wi not in owner
            image[wi], owner[wi] = acc >> 32, tid
        else:
            head = acc >> 32
    return head


def _encode_model(x, lengths, codes, code_lens, capw: int, bits, seed: int = 0, p_inclusive: float = 0.5):
    """Kernel G's decomposition: (rows (B, 4 * capw) uint8, byte_lens, pads, totals, stats)."""
    B, S = x.shape
    tile, threads, per = K["TILE"], K["THREADS"], K["PER_THREAD"]
    rng = np.random.default_rng(seed)
    rows = np.zeros((B, capw), dtype=np.int64)
    byte_lens = np.zeros(B, dtype=np.int32)
    pads = np.zeros(B, dtype=np.int32)
    totals = np.zeros(B, dtype=np.int64)
    stats = {"windows": 0, "tiles": 0}
    for b in range(B):  # the ticket's block-major order
        n = min(max(int(lengths[b]), 0), S)
        last = (n - 1) // tile if n else 0  # tiles past it return at once
        length = np.clip(code_lens[b].astype(np.int64), 0, 32)
        code = (codes[b].astype(np.int64) & M32) & ((1 << length) - 1)
        pad = (8 - int(bits[b]) % 8) % 8
        status: list = []
        inclusive: list[int] = []
        row_owner: dict = {}
        row_ored: dict = {}
        for t in range(last + 1):
            stats["tiles"] += 1
            pairs = [_thread_codes(x[b], n, t * tile + k * per, code, length) for k in range(threads)]
            mine = np.array([int(l.sum()) for _, l in pairs], dtype=np.int64)
            first = np.cumsum(mine) - mine
            tile_bits = int(mine.sum())
            # the look-back on a snapshot: each earlier tile shows its aggregate or its inclusive prefix
            snap = [(INCLUSIVE, inclusive[i]) if i == 0 or rng.random() < p_inclusive else (AGGREGATE, status[i])
                    for i in range(t)]
            prefix = _look_back(snap, t, stats) if t else 0
            assert prefix == sum(status)
            status.append(tile_bits)
            inclusive.append(prefix + tile_bits)
            image: dict = {}  # no zeros: a word holds what its owner stored
            owner: dict = {}
            heads = [(tid, _build(c, l, int(first[tid]), image, owner, tid)) for tid, (c, l) in enumerate(pairs)
                     if mine[tid]]
            for tid, head in heads:  # after the CTA's barrier
                if first[tid] & 31:
                    w = int(first[tid]) >> 5
                    assert owner[w] < tid  # the word's owner, an earlier thread, has stored it
                    image[w] |= head
            used = (tile_bits + 31) >> 5
            assert sorted(owner) == list(range(used))  # every word of the tile's bits has its owner
            if tile_bits:
                start = pad + prefix
                s, g0 = start & 31, start >> 5
                words = (s + tile_bits + 31) >> 5
                open_end = (s + tile_bits) & 31 != 0
                for j in range(words):
                    if g0 + j >= capw:
                        break
                    lo = image[j] if j < used else 0
                    v = (((image[j - 1] << (32 - s)) & M32 if j else 0) | (lo >> s)) if s else lo
                    if (j == 0 and s) or (j == words - 1 and open_end):
                        rows[b, g0 + j] |= v
                        row_ored.setdefault(g0 + j, set()).add(t)
                    else:
                        assert g0 + j not in row_owner
                        rows[b, g0 + j] = v
                        row_owner[g0 + j] = t
            if t == last:
                total = prefix + tile_bits
                own = (8 - total % 8) % 8
                byte_lens[b], pads[b], totals[b] = (total + own) // 8, own, total
        assert not set(row_owner) & set(row_ored)  # a plainly stored row word is no other tile's
    out = rows.astype(">u4").view(np.uint8).reshape(B, 4 * capw)
    return out, byte_lens, pads, totals, stats


def _plain(x, lengths, codes, code_lens, capw: int):
    rows, bl, pads = huffman_rows.encode_rows(*(torch.from_numpy(np.ascontiguousarray(a)) for a in
                                                (x, lengths, codes, code_lens)), capw)
    return rows.numpy(), bl.numpy(), pads.numpy()


def _totals(x, lengths, code_lens) -> np.ndarray:
    return huffman_rows.bit_totals(torch.from_numpy(x), torch.from_numpy(lengths), torch.from_numpy(code_lens)).numpy()


# ---------------------------------------------------------------------------
# Cases


def _tree_case(blocks: list[bytes], S: int | None = None, capw: int | None = None):
    """Blocks coded with the container's tables: (x, lengths, codes, code_lens, capw, bits, blocks)."""
    S = S or max(map(len, blocks))
    x = np.zeros((len(blocks), S), dtype=np.uint8)
    for i, blk in enumerate(blocks):
        x[i, : len(blk)] = np.frombuffer(blk, np.uint8)
    lengths = np.array([len(blk) for blk in blocks], dtype=np.int32)
    counts = np.zeros((len(blocks), 256), dtype=np.int64)
    for i, blk in enumerate(blocks):
        counts[i] = np.bincount(np.frombuffer(blk, np.uint8), minlength=256)
    t = huffman_blocks.code_tables(counts)
    codes, code_lens = t.codes, t.code_lens
    assert not t.on_host.any()
    bits = (counts[:, :128] * code_lens).sum(1)
    capw = capw or max(1, int((bits.max() + 7) // 8 + 3) // 4)
    return x, lengths, codes.view(np.int32), code_lens, capw, bits, blocks


def _random_table(rng, B: int, max_len: int = 32):
    """Code tables that are no prefix code: random lengths 0..max_len, random codes with junk above them."""
    lens = rng.integers(0, max_len + 1, size=(B, 128)).astype(np.int32)
    lens[:, :4] = max_len  # some of the longest codes in every table
    codes = rng.integers(0, 2**32, size=(B, 128), dtype=np.uint64).astype(np.uint32).view(np.int32)
    return codes, lens


def _corpus(n: int, offset: int = 0) -> bytes:
    return bench.make_corpus(offset + n)[offset:]


def _case(name: str):
    """(x, lengths, codes, code_lens, capw, bits, blocks or None): the named input."""
    tile = K["TILE"]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "words cut":  # text over tiles: thread and tile boundaries inside words
        return _tree_case([_corpus(2 * tile + 777), _corpus(tile + 5, 999), _corpus(333, 77)])
    if name == "1-bit codes":
        return _tree_case([bytes(rng.choice(np.frombuffer(b"ab", np.uint8), 3 * tile + 11)), b"xy" * 50])
    if name == "21-bit codes":
        return _tree_case([_fibonacci_block(22)])
    if name == "B = 1 over many tiles":
        return _tree_case([_corpus(9 * tile + 1234)])
    if name == "single symbol":
        return _tree_case([b"q" * (tile + 100), _corpus(5000), b"z"])
    if name == "S % 16 != 0":  # rows that do not start on 16 bytes: byte loads
        blocks = [_corpus(int(rng.integers(1, 3000)), int(rng.integers(0, 9999))) for _ in range(5)]
        return _tree_case(blocks, S=3001)
    if name == "lengths < S":  # garbage past each block's length
        x, lengths, codes, code_lens, capw, bits, blocks = _tree_case(
            [_corpus(4000), _corpus(tile + 1, 5), _corpus(17, 9)], S=tile + 64)
        x = np.where(np.arange(x.shape[1])[None, :] < lengths[:, None], x,
                     rng.integers(0, 128, size=x.shape, dtype=np.uint8)).astype(np.uint8)
        return x, lengths, codes, code_lens, capw, bits, blocks
    if name == "capw cut":  # rows shorter than the payloads: cut, byte_lens full
        x, lengths, codes, code_lens, capw, bits, blocks = _tree_case([_corpus(tile + 999), _corpus(700, 3)])
        return x, lengths, codes, code_lens, 37, bits, blocks
    if name in ("32-bit codes", "bytes >= 128"):  # tables that no tree makes; random bytes, some >= 128
        B, S = 3, 2 * tile + 19
        top = 256 if name == "bytes >= 128" else 128
        x = rng.integers(0, top, size=(B, S), dtype=np.uint8)
        lengths = np.array([S, S - 100, tile // 2], dtype=np.int32)
        codes, code_lens = _random_table(rng, B, 32 if name == "32-bit codes" else 9)
        bits = _totals(x, lengths, code_lens)
        return x, lengths, codes, code_lens, int((bits.max() + 7) // 8 + 3) // 4, bits, None
    raise KeyError(name)


CASES = ["words cut", "1-bit codes", "21-bit codes", "32-bit codes", "bytes >= 128", "lengths < S", "S % 16 != 0",
         "B = 1 over many tiles", "single symbol", "capw cut"]


def _check_oracles(rows, bl, pads, blocks) -> None:
    """Each block's row equals the payload of the port's copy of the oracle and of huffman_ref."""
    for r, blk in enumerate(blocks):
        want = port_hf.compress(blk)
        assert want == huffman_ref.compress(blk)
        assert want.endswith(port_hf.SEPARATOR + bytes([pads[r]]) + rows[r, : bl[r]].tobytes()), r


# ---------------------------------------------------------------------------
# The model's tests


def test_model_reads_kernel_constants():
    assert K["TILE"] == K["THREADS"] * K["PER_THREAD"] == huffman_rows.TILE
    assert K["PER_THREAD"] % 16 == 0  # 16-byte loads
    assert K["IMAGE_WORDS"] >= K["TILE"]  # 32-bit codes at most
    assert huffman_rows.tiles(0) == 1 and huffman_rows.tiles(K["TILE"] + 1) == 2


@pytest.mark.parametrize("p_inclusive", [0.0, 0.1, 0.9])
def test_look_back_sums_any_snapshot(p_inclusive):
    """Over 300 tiles, whatever each earlier tile has published, the walk gives the exclusive prefix;
    with aggregates only it walks back to the block's first tile, 32 tiles a window."""
    rng = np.random.default_rng(3)
    agg = rng.integers(0, 1 << 20, size=300).tolist()
    incl = np.cumsum(agg).tolist()
    stats = {"windows": 0}
    for t in range(1, 300):
        snap = [(INCLUSIVE, incl[i]) if i == 0 or rng.random() < p_inclusive else (AGGREGATE, agg[i])
                for i in range(t)]
        assert _look_back(snap, t, stats) == incl[t - 1]
    if p_inclusive == 0.0:
        assert stats["windows"] == sum(-(-t // 32) for t in range(1, 300))


@pytest.mark.parametrize("name", CASES)
def test_model_matches_plain(name):
    x, lengths, codes, code_lens, capw, bits, blocks = _case(name)
    rows, bl, pads, totals, stats = _encode_model(x, lengths, codes, code_lens, capw, bits)
    want = _plain(x, lengths, codes, code_lens, capw)
    for g, w in zip((rows, bl, pads), want):
        assert np.array_equal(g, w)
    assert np.array_equal(totals, bits)
    if blocks is not None and name != "capw cut":
        _check_oracles(rows, bl, pads, blocks)
    if name == "capw cut":
        assert (4 * capw < bl).all()  # cut rows, full lengths
    if name == "single symbol":
        assert bl[0] == pads[0] == totals[0] == 0 and not rows[0].any()
    if name == "B = 1 over many tiles":
        assert stats["tiles"] == 10 and stats["windows"] >= 9


def test_model_matches_pallas_interpret():
    """The Pallas kernel's 128 blocks of <= 2 KiB (test_torch_huffman's case), one tile each."""
    blocks, ids, lengths, codes, _, (rows_j, bl_j, pads_j), _ = _interp_case()
    c, lens = (t.numpy() for t in split_packed_codes(torch.from_numpy(codes)))
    bits = _totals(ids, lengths, lens)
    rows, bl, pads, _, _ = _encode_model(ids, lengths, c, lens, 512, bits)
    assert np.array_equal(bl, bl_j) and np.array_equal(pads, pads_j)
    for r in range(len(blocks)):
        assert rows[r, : bl[r]].tobytes() == rows_j[r, : bl[r]].tobytes(), r
    _check_oracles(rows, bl, pads, blocks)


def test_wrapper_raises_on_bits_that_disagree():
    x, lengths, codes, code_lens, capw, bits, _ = _case("words cut")
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, lengths, codes, code_lens)]
    rows, bl, pads = huffman_rows.encode_rows(*args, capw, bits=torch.from_numpy(bits))
    assert np.array_equal(bl.numpy(), _plain(x, lengths, codes, code_lens, capw)[1])
    wrong = bits.copy()
    wrong[1] += 1
    with pytest.raises(RuntimeError, match="block 1 codes to"):
        huffman_rows.encode_rows(*args, capw, bits=torch.from_numpy(wrong))


# ---------------------------------------------------------------------------
# The kernel's own source on the host: huffman_encode.cu built with g++ over
# cuda_host/cuda_emu.h, held against the plain version and the JAX package.

HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {  // B S capw x_offset in out: x, lengths, codes, code_lens, bits -> rows, byte_lens, pads, totals
    const int B = atoi(argv[1]), S = atoi(argv[2]), capw = atoi(argv[3]), off = atoi(argv[4]);
    const size_t guard = 64;  // words after the rows that no store may touch
    std::vector<uint8_t> xbuf((size_t)B * S + 32);
    uint8_t* x = xbuf.data() + ((16 - ((uintptr_t)xbuf.data() & 15)) & 15) + off;  // 16-byte aligned, then off bytes
    std::vector<int32_t> lens(B), codes((size_t)B * 128), code_lens((size_t)B * 128), byte_lens(B, -1), pads(B, -1);
    std::vector<long long> bits(B), totals(B, -1);
    std::vector<uint32_t> rows((size_t)B * capw + guard, 0);
    for (size_t i = (size_t)B * capw; i < rows.size(); ++i) rows[i] = 0xA5A5A5A5u;
    FILE* f = fopen(argv[5], "rb");
    if (fread(x, 1, (size_t)B * S, f) + fread(lens.data(), 4, B, f) + fread(codes.data(), 4, codes.size(), f) +
            fread(code_lens.data(), 4, code_lens.size(), f) + fread(bits.data(), 8, B, f) !=
        (size_t)B * S + 2 * B + codes.size() + code_lens.size())
        return 1;
    fclose(f);
    const int tiles = S > 0 ? (S + TILE - 1) / TILE : 1;
    std::vector<unsigned long long> work((size_t)B * tiles + 1, 0);
    const int rc = rsn_huffman_encode(x, lens.data(), codes.data(), code_lens.data(), bits.data(), rows.data(),
                                      byte_lens.data(), pads.data(), totals.data(), work.data(), B, S, capw, nullptr);
    f = fopen(argv[6], "wb");
    fwrite(rows.data(), 4, (size_t)B * capw, f);
    fwrite(byte_lens.data(), 4, B, f);
    fwrite(pads.data(), 4, B, f);
    fwrite(totals.data(), 8, B, f);
    fwrite(&work.back(), 8, 1, f);
    fclose(f);
    for (size_t i = (size_t)B * capw; i < rows.size(); ++i)
        if (rows[i] != 0xA5A5A5A5u) return 3;  // a store past the last row
    return rc;
}
"""


def _host_build(tmp, name: str, main: str) -> Path:
    """``csrc/<name>.cu`` with its launches rewritten to emu_launch, built with g++ over the emulator."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip(f"no g++ to build {name}.cu for the host")
    cu = (CSRC / f"{name}.cu").read_text()
    # name<<<grid, block, smem, stream>>>(args) -> emu_launch(name, grid, block, args)
    cu = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\)?)",
                lambda m: f"emu_launch({m[1]}, {m[2]}, {m[3]}{')' if m[4] else ', '}", cu)
    src = tmp / f"{name}_host.cpp"
    src.write_text('#include "cuda_emu.h"\n' + cu + main)
    exe = tmp / f"{name}_host"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(HOST), "-I", str(CSRC), "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    return exe


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """A function running kernel G's source, built for the CPU, on numpy blocks."""
    tmp = tmp_path_factory.mktemp("huffman_encode_host")
    exe = _host_build(tmp, "huffman_encode", HOST_MAIN)

    def run(x, lengths, codes, code_lens, capw: int, bits, x_offset: int = 0):
        B, S = x.shape
        inp, out = tmp / "in.bin", tmp / "out.bin"
        inp.write_bytes(b"".join(np.ascontiguousarray(a, dt).tobytes() for a, dt in (
            (x, np.uint8), (lengths, np.int32), (codes, np.int32), (code_lens, np.int32), (bits, np.int64))))
        subprocess.run([str(exe), str(B), str(S), str(capw), str(x_offset), str(inp), str(out)], check=True)
        r = out.read_bytes()
        n = 4 * B * capw
        rows = np.frombuffer(r[:n], np.uint8).reshape(B, 4 * capw)
        bl, pads = np.frombuffer(r[n : n + 4 * B], np.int32), np.frombuffer(r[n + 4 * B : n + 8 * B], np.int32)
        totals, counts = np.frombuffer(r[n + 8 * B : n + 16 * B], np.int64), int.from_bytes(r[n + 16 * B :], "little")
        assert counts & M32 == B * huffman_rows.tiles(S)  # every tile took a ticket
        run.wrong = counts >> 32  # the blocks whose totals differ from bits, as the kernel counts them
        return rows, bl, pads, totals

    return run


@pytest.mark.parametrize("name", CASES)
def test_kernel_source_on_host_matches_plain(host_kernel, name):
    x, lengths, codes, code_lens, capw, bits, blocks = _case(name)
    rows, bl, pads, totals = host_kernel(x, lengths, codes, code_lens, capw, bits)
    want = _plain(x, lengths, codes, code_lens, capw)
    for g, w in zip((rows, bl, pads), want):
        assert np.array_equal(g, w)
    huffman_rows._check_totals(torch.from_numpy(totals.copy()), torch.from_numpy(bits))
    if blocks is not None and name != "capw cut":
        _check_oracles(rows, bl, pads, blocks)


@pytest.mark.parametrize("x_offset", [1, 8])
def test_kernel_source_on_host_takes_rows_off_16_bytes(host_kernel, x_offset):
    """Blocks whose bytes do not start on 16 bytes take byte loads and give the same rows."""
    x, lengths, codes, code_lens, capw, bits, blocks = _case("words cut")
    got = host_kernel(x, lengths, codes, code_lens, capw, bits, x_offset)
    for g, w in zip(got, _plain(x, lengths, codes, code_lens, capw)):
        assert np.array_equal(g, w)


def test_kernel_source_on_host_reports_the_totals_it_coded(host_kernel):
    """bits that disagree with the tables move the pad; the kernel's totals are its own and the check raises."""
    x, lengths, codes, code_lens, capw, bits, _ = _case("words cut")
    wrong = bits.copy()
    wrong[0] += 3
    host_kernel(x, lengths, codes, code_lens, capw, bits)
    assert host_kernel.wrong == 0
    _, bl, pads, totals = host_kernel(x, lengths, codes, code_lens, capw, wrong)
    assert host_kernel.wrong == 1 and np.array_equal(totals, bits)
    assert np.array_equal(bl, _plain(x, lengths, codes, code_lens, capw)[1])
    with pytest.raises(RuntimeError, match="block 0 codes to"):
        huffman_rows._check_totals(torch.from_numpy(totals.copy()), torch.from_numpy(wrong))


def test_kernel_source_on_host_matches_pallas_interpret(host_kernel):
    blocks, ids, lengths, codes, _, (rows_j, bl_j, pads_j), _ = _interp_case()
    c, lens = (t.numpy() for t in split_packed_codes(torch.from_numpy(codes)))
    rows, bl, pads, totals = host_kernel(ids, lengths, c, lens, 512, _totals(ids, lengths, lens))
    assert np.array_equal(bl, bl_j) and np.array_equal(pads, pads_j)
    for r in range(len(blocks)):
        assert rows[r, : bl[r]].tobytes() == rows_j[r, : bl[r]].tobytes(), r
    for g, w in zip((rows, bl, pads), _plain(ids, lengths, c, lens, 512)):
        assert np.array_equal(g, w)
