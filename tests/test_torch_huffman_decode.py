"""Kernel H (csrc/huffman_decode.cu) modelled on the CPU, against the plain
version and the JAX package.

Kernel H runs only on the card. It splits each row's payload bits into
subsequences of SUB_BITS bits, one thread each, SPAN_SUBS a CTA (a span),
and launches three kernels: the speculation (each subsequence walks its
codes from the first multiple of the block's code lattice at its first bit,
then the span repairs its entries from the exits before them, in rounds,
until none changes), the chain (over a block's spans in order: a span whose
first entry was wrong repeats the repair from the true exit, then a scan of
the counts gives the offsets, the count and ok) and the write (each thread
decodes its true codes again into its slice of the row). A step peeks
LUT_BITS bits and loads one entry of a table built from the child table.
``_decode_model`` mirrors those passes in numpy, vectorised over the
subsequences, with the constants read from the kernel's source, and counts
the repair rounds. It is held, exactly (tolerance 0: bytes and counts),
against the plain version ``huffman_rows._decode_rows_torch`` (the
wrapper's route for CPU tensors) and against the Pallas kernel
``raisin_tpu.ops.huffman_pallas.decode_rows_huffman`` in interpret mode. The
kernel's own source runs here too, built with g++ over
``tests/cuda_host/cuda_emu.h`` (a CTA's threads as threads, warps exchanging
through barriers), against the same references. Inputs are blocks of
seeded numpy bytes and of ``bench.make_corpus``, coded by
``huffman_blocks.encode_blocks`` on the CPU, and rows cut or garbled from
them.
"""

from __future__ import annotations

import functools
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from raisin_tpu_torch.formats import huffman as port_hf
from raisin_tpu_torch.ops import huffman_blocks, huffman_rows
from tests.test_torch_huffman import _fibonacci_block, _interp_case
from tests.go_heap import jax_heap_at_go_rule  # noqa: F401  (a fixture)

# the JAX oracle builds Go's Huffman tree here, as the port does (tests/go_heap.py)
pytestmark = pytest.mark.usefixtures("jax_heap_at_go_rule")

torch.set_num_threads(1)

CSRC = Path(huffman_rows.__file__).resolve().parent.parent / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"


@functools.cache
def _constants() -> dict[str, int]:
    """Kernel H's integer constants, read from its source (the model mirrors them)."""
    src = (CSRC / "huffman_decode.cu").read_text()
    out: dict[str, int] = {}
    for k, v in re.findall(r"constexpr int (\w+) = ([\w */+-]+);", src):  # integer arithmetic on earlier ones
        out[k] = eval(v.replace(" / ", " // "), {}, dict(out))
    return out


K = _constants()
DEAD = np.iinfo(np.int64).max


# ---------------------------------------------------------------------------
# The model


def _child(table: np.ndarray) -> np.ndarray:
    """A (64,) int32 packed child table -> its 256 child bytes, int64."""
    return np.ascontiguousarray(table, "<i4").view(np.uint8).astype(np.int64)


def _lut(child: np.ndarray) -> np.ndarray:
    """The LUT_BITS table: entry i is depth << 8 | symbol for a leaf within the bits of i, else
    the internal node that they reach."""
    bits = K["LUT_BITS"]
    idx = np.arange(1 << bits)
    node = np.zeros_like(idx)
    ent = np.full_like(idx, -1)
    for d in range(bits):
        ch = child[2 * node + ((idx >> (bits - 1 - d)) & 1)]
        leaf = (ent < 0) & (ch >= huffman_rows.NSYM)
        ent = np.where(leaf, (d + 1) << 8 | (ch - huffman_rows.NSYM), ent)
        node = np.where(ent < 0, ch, node)
    return np.where(ent < 0, node, ent)


def _lattice(child: np.ndarray) -> int:
    """The greatest common divisor of the depths of the leaves reached from the root (0: none)."""
    g, depth, level = 0, {0: 0}, [0]
    while level:
        nxt = []
        for node in level:
            for ch in child[2 * node : 2 * node + 2].tolist():
                if ch >= huffman_rows.NSYM:
                    g = math.gcd(g, depth[node] + 1)
                elif ch not in depth:
                    depth[ch] = depth[node] + 1
                    nxt.append(ch)
        level = nxt
    return g


def _on_lattice(p, lattice: int):
    return (p + lattice - 1) // lattice * lattice if lattice > 1 else p


class _Block:
    """One row's decoder: its bits (zeros past the row), table and tree."""

    def __init__(self, row: np.ndarray, pad: int, byte_len: int, table: np.ndarray):
        capb = row.size
        self.pad = int(pad)
        self.nbits = max(0, 8 * min(max(int(byte_len), 0), capb) - self.pad)
        self.bits = np.concatenate([np.unpackbits(row), np.zeros(64 + K["LUT_BITS"], np.uint8)]).astype(np.int64)
        n = 8 * capb + 64
        self.peek = np.zeros(n, np.int64)
        for i in range(K["LUT_BITS"]):
            self.peek = self.peek << 1 | self.bits[i : i + n]
        self.child = _child(table)
        self.lut = _lut(self.child)
        self.lattice = _lattice(self.child)

    def step(self, p: np.ndarray):
        """The codes at bits p (< nbits): the bits after them (DEAD: no leaf before nbits or
        within MAX_CODE bits) and their symbols."""
        e = self.lut[self.peek[self.pad + p]]
        ln = e >> 8
        q = np.where((ln > 0) & (p + ln <= self.nbits), p + ln, DEAD)
        sym = e & 0xFF
        long = np.nonzero(ln == 0)[0]
        if long.size:
            pl, node = p[long], e[long]
            walking = np.ones(long.size, bool)
            for d in range(K["LUT_BITS"], K["MAX_CODE"]):
                walking &= pl + d < self.nbits
                if not walking.any():
                    break
                ch = self.child[2 * node + self.bits[self.pad + np.where(walking, pl + d, 0)]]
                leaf = walking & (ch >= huffman_rows.NSYM)
                q[long[leaf]] = pl[leaf] + d + 1
                sym[long[leaf]] = ch[leaf] - huffman_rows.NSYM
                node = np.where(walking & ~leaf, ch, node)
                walking &= ~leaf
        return q, sym


def _walk(blk: _Block, p: np.ndarray, end: np.ndarray):
    """Each walk from p over the codes that start before end: (exit, count)."""
    p, n = p.copy(), np.zeros(p.size, np.int64)
    act = np.nonzero(p < end)[0]
    while act.size:
        q, _ = blk.step(p[act])
        n[act] += q != DEAD
        p[act] = q
        act = act[q < end[act]]
    return p, n


def _rewalk(blk: _Block, e_new, end, e, x, n):
    """The walks from e_new, in lockstep with the old walks (e, x, n) until they meet on a
    boundary or the new walk passes its end: the new (e, x, n)."""
    p, q = e_new.copy(), e.copy()
    cn, co = np.zeros_like(n), np.zeros_like(n)
    met = np.zeros(p.size, bool)
    live = np.nonzero(p < end)[0]
    while live.size:
        hit = p[live] == q[live]
        met[live[hit]] = True
        live = live[~hit]
        old = live[q[live] < p[live]]
        new = live[q[live] >= p[live]]
        if old.size:
            q[old] = blk.step(q[old])[0]
            co[old] += 1
        if new.size:
            nq = blk.step(p[new])[0]
            cn[new] += nq != DEAD
            p[new] = nq
        live = live[p[live] < end[live]]
    return e_new.copy(), np.where(met, x, p), np.where(met, n - co + cn, cn)


def _repair(blk: _Block, first: int, end, real, e, x, n) -> int:
    """A span's repair: each real entry from the exit before it (the first from ``first``),
    in rounds, until none changes. Updates (e, x, n) in place; returns the rounds that
    changed an entry."""
    rounds = 0
    while True:
        e_new = np.concatenate([[first], x[:-1]])
        ch = np.nonzero(real & (e_new != e))[0]
        if not ch.size:
            return rounds
        e[ch], x[ch], n[ch] = _rewalk(blk, e_new[ch], end[ch], e[ch], x[ch], n[ch])
        rounds += 1


def _decode_block(blk: _Block, cap_out: int, stats: dict):
    """Kernel H's three passes on one row: (row (cap_out,) uint8, count, ok)."""
    sub, span_subs = K["SUB_BITS"], K["SPAN_SUBS"]
    span_bits = sub * span_subs
    spans = -(-blk.nbits // span_bits)
    t = np.arange(span_subs)
    state = []
    # pass 1, every span at once in the kernel: the speculation and the span's repair
    for c in range(spans):
        lo = c * span_bits + t * sub
        end = np.minimum(lo + sub, blk.nbits)
        real = lo < blk.nbits
        e = np.where(real, _on_lattice(lo, blk.lattice), lo)
        x, n = _walk(blk, e, np.where(real, end, 0))
        x = np.where(real, x, e)
        stats["spec_rounds"].append(_repair(blk, _on_lattice(c * span_bits, blk.lattice), end, real, e, x, n))
        state.append((end, real, e, x, np.where(real, n, 0)))
    # pass 2: the spans in order from the true exits; the offsets, the count and ok
    true_exit, base, offsets = 0, 0, []
    for c, (end, real, e, x, n) in enumerate(state):
        if true_exit == DEAD:
            e[real], x[real], n[real] = DEAD, DEAD, 0
        elif true_exit != _on_lattice(c * span_bits, blk.lattice):
            stats["chain_rounds"].append(_repair(blk, true_exit, end, real, e, x, n))
        offsets.append(base + np.cumsum(n) - n)
        base += int(n.sum())
        true_exit = int(x[np.nonzero(real)[0][-1]])
    # pass 3: each subsequence's codes again, into the row
    row = np.zeros(cap_out, np.uint8)
    for (_, _, e, _, n), off in zip(state, offsets):
        p = e.copy()
        for i in range(int(n.max(initial=0))):
            act = np.nonzero((i < n) & (off + i < cap_out))[0]
            if not act.size:
                break
            p[act], sym = blk.step(p[act])
            row[off[act] + i] = sym
    return row, base, int(true_exit == blk.nbits)


def _decode_model(rows, pads, byte_lens, tables, cap_out: int):
    """(rows (B, cap_out) uint8, counts (B,), ok (B,), stats): the repair rounds of each span."""
    stats = {"spec_rounds": [], "chain_rounds": []}
    out = [_decode_block(_Block(rows[b], pads[b], byte_lens[b], tables[b]), cap_out, stats) for b in range(len(rows))]
    return (np.stack([o[0] for o in out]).reshape(len(rows), cap_out), np.array([o[1] for o in out], np.int32),
            np.array([o[2] for o in out], np.int32), stats)


# ---------------------------------------------------------------------------
# Inputs


def _plain(rows, pads, byte_lens, tables, cap_out: int):
    out = huffman_rows._decode_rows_torch(*(torch.from_numpy(np.array(a)) for a in (rows, pads, byte_lens, tables)),
                                          cap_out)
    return tuple(o.numpy() for o in out)


def _table(payload: bytes) -> np.ndarray:
    head = payload.split(port_hf.SEPARATOR, 1)[0]
    tree = port_hf.build_tree(port_hf.parse_header(head))
    return np.zeros(huffman_rows.NTAB, np.int32) if isinstance(tree, port_hf.Leaf) else huffman_blocks.packed_table(tree)


def _encoded(blocks: list[bytes]):
    """Blocks through huffman_blocks.encode_blocks on the CPU -> (rows (B, capb) uint8 with
    capb % 4 == 0, pads, byte_lens, tables (B, 64) int32), as decode_blocks lays them out."""
    m = np.zeros((len(blocks), max(map(len, blocks))), np.uint8)
    for i, b in enumerate(blocks):
        m[i, : len(b)] = np.frombuffer(b, np.uint8)
    flat, sizes = huffman_blocks.encode_blocks(torch.from_numpy(m), torch.tensor([len(b) for b in blocks], dtype=torch.int32))
    body = flat.numpy().tobytes()
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    payloads = [body[a : a + k] for a, k in zip(starts, sizes)]
    bodies = [p.split(port_hf.SEPARATOR, 1)[1] for p in payloads]
    capb = -(-max(len(b) - 1 for b in bodies) // 4) * 4
    rows = np.zeros((len(blocks), capb), np.uint8)
    for i, b in enumerate(bodies):
        rows[i, : len(b) - 1] = np.frombuffer(b[1:], np.uint8)
    pads = np.array([b[0] for b in bodies], np.int32)
    byte_lens = np.array([len(b) - 1 for b in bodies], np.int32)
    return rows, pads, byte_lens, np.stack([_table(p) for p in payloads])


def _uniform_ascii(n: int, seed: int = 3) -> bytes:
    return np.random.default_rng(seed).integers(0, 128, n, dtype=np.uint8).tobytes()


def _corpus(n: int, offset: int = 0) -> bytes:
    return bench.make_corpus(n + offset)[offset:]


def _random_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    syms = rng.choice(128, size=int(rng.integers(3, 90)), replace=False)
    return rng.choice(syms, size=n, p=rng.dirichlet(np.ones(syms.size) * 0.5)).astype(np.uint8).tobytes()


def _pad_blocks() -> list[bytes]:
    """Prefixes of a text whose pads cover 0..7."""
    text, found = _random_text(4000, seed=8), {}
    for n in range(300, 4000, 7):
        pad = _encoded([text[:n]])[1][0]
        found.setdefault(int(pad), text[:n])
        if len(found) == 8:
            return [found[p] for p in range(8)]
    raise AssertionError(f"pads found: {sorted(found)}")


@functools.cache
def _case(name: str):
    """A named input: (rows, pads, byte_lens, tables, cap_out)."""
    if name == "spans":  # B = 3 over two spans each: the chain's repair across spans
        blocks = [_corpus(70_000), _uniform_ascii(40_000), _fibonacci_block(24)]
    elif name == "stream":  # B = 1 over four spans, as the huffman stream decodes
        blocks = [_corpus(200_000, offset=5)]
    elif name == "two symbols":
        rng = np.random.default_rng(4)
        blocks = [rng.choice(np.frombuffer(b"ab", np.uint8), 37_001).tobytes(), b"ab" * 3, b"ba"]
    elif name == "pads":
        blocks = _pad_blocks()
    elif name == "dead spans":  # B = 2 over two spans each, rows garbled below
        blocks = [_corpus(80_000, offset=9), _uniform_ascii(45_000, seed=5), _uniform_ascii(100, seed=6)]
    elif name == "edges":
        blocks = [_random_text(3000, 11), _random_text(2500, 12), b"q" * 800, _random_text(1800, 13),
                  _random_text(2200, 14), _uniform_ascii(1500, 15)]
    else:
        raise KeyError(name)
    rows, pads, byte_lens, tables = _encoded(blocks)
    cap_out = -(-max(map(len, blocks)) // 4) * 4
    if name == "dead spans":
        # the zero table over garbage bits: no code ever ends, so every span after the first
        # starts from a dead walk; and a row cut one byte short, whose last code runs off
        rng = np.random.default_rng(18)
        rows[0] = rng.integers(0, 256, rows.shape[1], dtype=np.uint8)
        tables[0] = 0
        byte_lens[1] -= 1
        # a table with a cycle: bit 1 is the code of 'A', bit 0 enters a node that never ends;
        # random bits, then ones: the walk dies in the first span, while the second span's own
        # speculation decodes 'A's
        tables[2] = 0
        tables[2, 0] = 1 | (huffman_rows.NSYM + 65) << 8 | 1 << 16 | 1 << 24
        rows[2] = 0xFF
        rows[2, :1000] = rng.integers(0, 256, 1000, dtype=np.uint8)
        byte_lens[2] = rows.shape[1]
    if name == "edges":
        # an empty row, a row clamped to capb, a row cut inside its codes (what follows is
        # garbage to the kernel), a negative length, the zero table over garbage bits, and
        # a uniform-ASCII row cut one byte short
        rng = np.random.default_rng(16)
        byte_lens[1] = 0
        byte_lens[3] = rows.shape[1] + 999
        byte_lens[0] = byte_lens[0] * 2 // 3
        byte_lens[4] = -5
        rows[2] = rng.integers(0, 256, rows.shape[1], dtype=np.uint8)
        byte_lens[2] = rows.shape[1] - 3
        byte_lens[5] -= 1
    return rows, pads, byte_lens, tables, cap_out


CASES = ["spans", "stream", "two symbols", "pads", "dead spans", "edges"]


def test_model_reads_kernel_constants():
    assert (K["SUB_BITS"], K["SPAN_SUBS"]) == (huffman_rows.SUB_BITS, huffman_rows.SPAN_SUBS)
    assert K["SPAN_BITS"] == K["SUB_BITS"] * K["SPAN_SUBS"] and K["SPAN_SUBS"] % 32 == 0
    assert K["MAX_CODE"] == huffman_rows.NSYM and K["NSYM"] == huffman_rows.NSYM
    assert K["SUB_BITS"] >= K["MAX_CODE"] and 1 <= K["LUT_BITS"] <= 15  # depth << 8 | symbol in 16 bits
    # the staged words cover the span, the pad, a window past its end and a code across it
    assert K["STAGE_WORDS"] * 32 >= K["SPAN_BITS"] + 8 + 64 + K["MAX_CODE"]
    assert huffman_rows.workspace_bytes(3, 40_000) == 16 * 3 * 2 * K["SPAN_SUBS"]


def test_lattice_and_table_of_known_trees():
    for block, lattice, longest in ((_uniform_ascii(20_000), 7, 7), (b"ab" * 9, 1, 1), (_fibonacci_block(22), 1, 21)):
        table = _encoded([block])[3][0]
        child = _child(table)
        assert _lattice(child) == lattice
        lut = _lut(child)
        assert ((lut >> 8) <= min(longest, K["LUT_BITS"])).all()
        assert ((lut >> 8) == 0).any() == (longest > K["LUT_BITS"])
    assert _lattice(np.zeros(256, np.int64)) == 0 and (_lut(np.zeros(256, np.int64)) == 0).all()


@pytest.mark.parametrize("name", CASES)
def test_model_matches_plain(name):
    rows, pads, byte_lens, tables, cap_out = _case(name)
    got = _decode_model(rows, pads, byte_lens, tables, cap_out)
    want = _plain(rows, pads, byte_lens, tables, cap_out)
    for g, w in zip(got[:3], want):
        assert np.array_equal(g, w)
    stats = got[3]
    if name == "spans":
        nbits = 8 * byte_lens - pads
        assert (nbits > K["SPAN_BITS"]).all() and (nbits % K["SUB_BITS"] != 0).all() and want[2].all()
        # the chain repaired the second span of the corpus and Fibonacci rows: the speculation's
        # first bit is not a boundary; on uniform ASCII the 7-bit lattice left nothing to repair
        assert len(stats["chain_rounds"]) == 2 and max(stats["chain_rounds"]) <= 3
        assert max(stats["spec_rounds"]) <= 4
    if name == "stream":
        assert want[2].all() and len(stats["spec_rounds"]) == 4 and max(stats["chain_rounds"]) <= 3
    if name == "dead spans":
        assert (8 * byte_lens[[0, 2]] - pads[[0, 2]] > K["SPAN_BITS"]).all()
        assert want[1][0] == 0 and want[2][0] == 0 and want[1][1] > 40_000
        assert want[1][2] < 100 and want[2][2] == 0
    if name == "edges":
        assert want[1][1] == 0 and want[2][1] == 1  # empty: nothing decoded, ended on a boundary
        assert want[1][2] == 0 and want[2][2] == 0  # the zero table: no code ever ends
        assert want[1][4] == 0 and want[2][4] == 1
        assert want[2][0] == 0 or want[1][0] < 3000  # cut
        assert want[1][3] > 1800  # clamped to the row: its block, then codes of the zero bytes after it


def test_model_counts_past_cap_out():
    rows, pads, byte_lens, tables, _ = _case("spans")
    got = _decode_model(rows, pads, byte_lens, tables, 1000)
    want = _plain(rows, pads, byte_lens, tables, 1000)
    assert (want[1] > 1000).all()
    for g, w in zip(got[:3], want):
        assert np.array_equal(g, w)


def test_model_matches_pallas_interpret():
    """The Pallas kernel's 128 blocks of <= 2 KiB (test_torch_huffman's case): ASCII texts, a
    single symbol and a Fibonacci block, one span each."""
    _, _, _, _, tables, (rows_j, bl_j, pads_j), (out_j, cnt_j, ok_j) = _interp_case()
    rows, counts, ok, _ = _decode_model(rows_j, pads_j, bl_j, tables, 2048)
    assert np.array_equal(counts, cnt_j) and np.array_equal(ok, ok_j.astype(np.int32))
    for r in range(len(rows)):
        assert rows[r, : counts[r]].tobytes() == out_j[r, : counts[r]].tobytes()


# ---------------------------------------------------------------------------
# The kernel's own source on the host: huffman_decode.cu built with g++ over
# cuda_host/cuda_emu.h, held against the plain version and the JAX package.

HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {  // B capb cap in out: rows, pads, byte_lens, tables -> rows, counts, ok
    const int B = atoi(argv[1]), capb = atoi(argv[2]), cap = atoi(argv[3]);
    const size_t guard = 64;  // bytes after the rows that no store may touch
    std::vector<uint8_t> payload((size_t)B * capb), rows((size_t)B * cap + guard, 0);
    std::vector<int32_t> pads(B), lens(B), tables((size_t)B * 64), counts(B, -1), ok(B, -1);
    for (size_t i = (size_t)B * cap; i < rows.size(); ++i) rows[i] = 0xA5;
    FILE* f = fopen(argv[4], "rb");
    if (fread(payload.data(), 1, payload.size(), f) + fread(pads.data(), 4, B, f) + fread(lens.data(), 4, B, f) +
            fread(tables.data(), 4, tables.size(), f) != payload.size() + 2 * B + tables.size())
        return 1;
    fclose(f);
    const long long subs = (8LL * capb + SUB_BITS - 1) / SUB_BITS;
    const long long spans = std::max(1LL, (subs + SPAN_SUBS - 1) / SPAN_SUBS);
    std::vector<uint32_t> work(4 * (size_t)B * spans * SPAN_SUBS);
    const int rc = rsn_huffman_decode(payload.data(), pads.data(), lens.data(), tables.data(), rows.data(),
                                      counts.data(), ok.data(), work.data(), B, capb, cap, nullptr);
    f = fopen(argv[5], "wb");
    fwrite(rows.data(), 1, (size_t)B * cap, f);
    fwrite(counts.data(), 4, B, f);
    fwrite(ok.data(), 4, B, f);
    fclose(f);
    for (size_t i = (size_t)B * cap; i < rows.size(); ++i)
        if (rows[i] != 0xA5) return 3;  // a store past the last row
    return rc;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """A function running kernel H's source, built for the CPU, on numpy rows."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build kernel H's source for the host")
    tmp = tmp_path_factory.mktemp("huffman_decode_host")
    cu = (CSRC / "huffman_decode.cu").read_text()
    # name<<<grid, block, smem, stream>>>(args) -> emu_launch(name, grid, block, args)
    cu = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\)?)",
                lambda m: f"emu_launch({m[1]}, {m[2]}, {m[3]}{')' if m[4] else ', '}", cu)
    src = tmp / "huffman_decode_host.cpp"
    src.write_text('#include "cuda_emu.h"\n' + cu + HOST_MAIN)
    exe = tmp / "huffman_decode_host"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(HOST), "-I", str(CSRC), "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(rows, pads, byte_lens, tables, cap_out: int):
        B, capb = rows.shape
        inp, out = tmp / "in.bin", tmp / "out.bin"
        inp.write_bytes(b"".join(np.ascontiguousarray(a, dt).tobytes()
                                 for a, dt in ((rows, np.uint8), (pads, np.int32), (byte_lens, np.int32), (tables, np.int32))))
        subprocess.run([str(exe), str(B), str(capb), str(cap_out), str(inp), str(out)], check=True)
        r = out.read_bytes()
        n = B * cap_out
        return (np.frombuffer(r[:n], np.uint8).reshape(B, cap_out), np.frombuffer(r[n : n + 4 * B], np.int32),
                np.frombuffer(r[n + 4 * B :], np.int32))

    return run


@pytest.mark.parametrize("name", CASES)
def test_kernel_source_on_host_matches_plain(host_kernel, name):
    rows, pads, byte_lens, tables, cap_out = _case(name)
    got = host_kernel(rows, pads, byte_lens, tables, cap_out)
    want = _plain(rows, pads, byte_lens, tables, cap_out)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_kernel_source_on_host_counts_past_cap_out(host_kernel):
    rows, pads, byte_lens, tables, _ = _case("spans")
    got = host_kernel(rows, pads, byte_lens, tables, 1000)
    want = _plain(rows, pads, byte_lens, tables, 1000)
    assert (want[1] > 1000).all()
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_kernel_source_on_host_matches_pallas_interpret(host_kernel):
    _, _, _, _, tables, (rows_j, bl_j, pads_j), (out_j, cnt_j, ok_j) = _interp_case()
    rows, counts, ok = host_kernel(rows_j, pads_j, bl_j, tables, 2048)
    assert np.array_equal(counts, cnt_j) and np.array_equal(ok, ok_j.astype(np.int32))
    for r in range(len(rows)):
        assert rows[r, : counts[r]].tobytes() == out_j[r, : counts[r]].tobytes()
    want = _plain(rows_j, pads_j, bl_j, tables, 2048)
    for g, w in zip((rows, counts, ok), want):
        assert np.array_equal(g, w)
