"""Kernel C (csrc/arith_decode.cu) modelled on the CPU, against the plain
version, the JAX package and the host oracle.

Kernel C runs only on the card, so ``_decode_model`` mirrors it in numpy,
one warp per block, vectorised over blocks: the register-resident model
(lane l holds cum[l + 32 j] in register j), the search without a division
(cum[i] * d <= num) as per-lane folds of index-tagged entries and two warp
reductions (max, min), EOF's tag, the coder state (low, value - low, the
range d), the narrowing quotients as a multiply-high and a shift by a magic
number per total (``div_by_magic``), the closed-form renormalisation, and
the bit supply: a 64-bit window refilled 32 bits at a time from the warp's
two 128-byte buffers of the row, at any row pitch. Its constants are read
from the kernel's sources. The model is held, exactly (tolerance 0: the
outputs are bytes), against ``arithmetic_rows._decode_rows_torch`` (the
wrapper's route for CPU tensors), against ``raisin_tpu.ops.arithmetic_pallas``
in Pallas interpret mode and against ``raisin_tpu.formats.arithmetic_ref``,
and on garbage rows it asserts at every step the invariant that the 32-bit
arithmetic rests on: low <= value <= high. The kernel's own source runs
here too, built with g++ over ``tests/cuda_host/cuda_emu.h`` (a warp's
lanes as threads) and held against the plain version. Inputs come from
seeded numpy.

The two mirrors check different things. The built source cannot drift from
the kernel, but it checks outputs only, and it skips on a host without
g++. The model states the design lane by lane and asserts at every step
what the kernel cannot check itself: the invariant, the dividend below
2^30, the products below 2^32, no shift past 16 bits and no read past the
clamped length. It also counts the prepad, the refills and the buffer
switches, so the tests know which edges each input reached. A change to
the kernel's step changes the model with it.
"""

from __future__ import annotations

import functools
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raisin_tpu.formats import arithmetic_ref
from raisin_tpu.ops import arithmetic_pallas as ap
from raisin_tpu_torch.ops import arithmetic_rows as ar

torch.set_num_threads(1)

CSRC = Path(ar.__file__).resolve().parent.parent / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"


@functools.cache
def _constants() -> dict[str, int]:
    """Kernel C's integer constants, read from its sources (the model mirrors them)."""
    src = (CSRC / "arith_common.cuh").read_text() + (CSRC / "arith_decode.cu").read_text()
    found = re.findall(r"constexpr (?:int|uint32_t) (\w+) = (0x[0-9A-Fa-f]+|\d+)u?;", src)
    return {k: int(v, 0) for k, v in found}


K = _constants()
M32 = 0xFFFFFFFF


def _clz32(x: np.ndarray) -> np.ndarray:
    """__clz of 32-bit values held in int64 (32 for 0)."""
    _, e = np.frexp(x.astype(np.float64))  # exact below 2^53: x = f * 2^e, f in [0.5, 1)
    return np.where(x > 0, 32 - e, 32).astype(np.int64)


def magic(t: np.ndarray):
    """The decoder's table entry for a total t >= 2: (m, L) with L = floor(log2(t - 1)) and
    m = ceil(2^(32 + L) / t), as make_magic_table builds it."""
    L = 31 - _clz32(t - 1)
    return ((1 << (32 + L)) + t - 1) // t, L


def div_by_magic(x: np.ndarray, t: np.ndarray) -> np.ndarray:
    """floor(x / t) as the kernel takes it: umulhi(x, m) >> L, for x < 2^30."""
    assert (x >= 0).all() and (x < 1 << 30).all()
    m, L = magic(t)
    return ((x * m) >> 32) >> L


def _decode_model(flat: np.ndarray, pitch: int, byte_lens, out_lens, num_steps: int):
    """Kernel C on B rows of ``pitch`` bytes laid end to end in ``flat``.

    Returns (syms (B, num_steps) uint8, eof_ok (B,) int32, stats), where
    stats counts, per block, the prepad bits stripped, the window refills,
    the chunk switches of the bit supply, whether the model froze, and the
    largest byte offset read in the row (-1 for none).
    """
    B = len(byte_lens)
    assert flat.size == B * pitch
    R, PAD, CH = K["MODEL_REGS"], K["MODEL_PAD"], K["CHUNK_BYTES"]
    HALF, MAXC, MAXF, EOF = K["ONE_HALF"], K["MAX_CODE"], K["MAX_FREQ"], K["EOF_SYMBOL"]
    data = flat.astype(np.int64)
    lens = np.clip(np.asarray(byte_lens, np.int64), 0, pitch)
    n = np.asarray(out_lens, np.int64)
    rows = np.arange(B)
    lane = np.arange(32)
    last_read = np.full(B, -1, np.int64)

    def stream_words(base):
        """(B, 32) words: lane l's 4 bytes of the chunk at ``base``, as stream_word reads them."""
        i = base[:, None, None] + 4 * lane[None, :, None] + np.arange(4)[None, None, :]
        inside = i < lens[:, None, None]  # the only bytes it loads: inside the row
        byte = np.where(inside, data[np.where(inside, rows[:, None, None] * pitch + i, 0)],
                        np.where(i == lens[:, None, None], 0x80, 0))
        np.maximum.at(last_read, rows, np.where(inside, i, -1).max((1, 2)))
        return (byte[..., 0] << 24) | (byte[..., 1] << 16) | (byte[..., 2] << 8) | byte[..., 3]

    base = np.zeros(B, np.int64)
    cur, nxt = stream_words(base), stream_words(base + CH)
    win = (cur[:, 0].astype(np.uint64) << np.uint64(32)) | cur[:, 1].astype(np.uint64)
    avail = np.full(B, 64, np.int64)
    w = np.full(B, 2, np.int64)
    first = (win >> np.uint64(56)).astype(np.int64)
    prepad = np.where(first > 0, _clz32(first) - 23, 8)
    win = win << prepad.astype(np.uint64)
    value = (win >> np.uint64(48)).astype(np.int64)
    win = win << np.uint64(16)
    avail -= prepad + 16

    idx = lane[:, None] + 32 * np.arange(R)[None, :]  # (32, R): the entry each register holds
    c = np.broadcast_to(np.where(idx < K["NUM_CUM"], idx, PAD), (B, 32, R)).copy()
    keep = np.where(idx == EOF, 0xFFFF0000, M32)  # EOF's entry, as a lower bound, is tagged with value 0
    # the coder's state: low, value - low and the range d = high - low + 1
    low = np.zeros(B, np.int64)
    vrel = value
    d = np.full(B, MAXC + 1, np.int64)
    count = np.full(B, 257, np.int64)
    eof = np.zeros(B, np.int32)
    out = np.zeros((B, num_steps), np.uint8)
    steps = np.where(n < num_steps, n + 1, num_steps)
    refills = np.zeros(B, np.int64)
    switches = np.zeros(B, np.int64)

    for t in range(int(steps.max(initial=0))):
        act = t < steps
        # low <= value <= high, the invariant the 32-bit arithmetic rests on
        assert ((0 <= vrel) & (vrel < d) & (low + d - 1 <= MAXC))[act].all(), f"broken at step {t}"
        total = count
        num = vrel * total + total - 1
        assert ((num >= 0) & (num < 1 << 30))[act].all()
        # cum[i] <= floor(num / d) as cum[i] * d <= num, every product below 2^32; per lane the
        # tagged entries (i << 16 | cum[i]) that pass, their max, those that fail, their min;
        # then the warp's max and min
        x = c * d[:, None, None]
        assert (x < 1 << 32).all()
        inn = x <= num[:, None, None]
        tag = (idx[None] << 16) | c
        below = np.where(inn, tag & keep, 0).max(2).max(1)
        above = np.where(inn, M32, tag).min(2).min(1)
        sym, lower, upper = below >> 16, below & 0xFFFF, above & 0xFFFF
        inc = np.where(act & (total < MAXF), 1, 0)
        c += ((idx[None] < K["NUM_CUM"]) & (idx[None] > sym[:, None, None])) * inc[:, None, None]
        count = count + inc

        is_eof = sym == EOF
        eof = np.where(act & (t == n), is_eof, eof).astype(np.int32)
        # EOF's tag makes lower 0 and upper total: the same interval
        assert ((lower == 0) & (upper == total))[is_eof].all()
        q_hi = div_by_magic(d * upper, total)
        q_lo = div_by_magic(d * lower, total)
        nh = low + q_hi - 1
        nl = low + q_lo
        # closed-form renormalisation (nl, nh < 2^16; k + 17 <= 33, a funnel shift clamped at 32)
        k = _clz32(nl ^ nh) - 16
        e3 = np.where(k + 17 < 32, ((nl & ~nh & M32) << np.minimum(k + 17, 31)) & M32, 0)
        m = _clz32(~e3 & M32)
        s = k + m
        assert (s <= 16).all()
        assert (s[act & is_eof] == 0).all()  # EOF leaves a renormalised interval: no shift
        flip = np.where(m > 0, HALF, 0)
        bits = (win >> np.uint64(48)).astype(np.int64) >> (16 - s)
        low = np.where(act, ((nl << s) & MAXC) ^ flip, low)
        d = np.where(act, (q_hi - q_lo) << s, d)
        vrel = np.where(act, ((vrel - q_lo) << s) | bits, vrel)
        s = np.where(act, s, 0)
        win = win << s.astype(np.uint64)
        avail -= s
        # refill from the warp's buffer; past its last word, the next buffer and a new load
        ref = avail < 32
        word = cur[rows, np.minimum(w, 31)].astype(np.uint64)
        win = np.where(ref, win | (word << np.maximum(32 - avail, 0).astype(np.uint64)), win)
        avail = np.where(ref, avail + 32, avail)
        refills += ref
        w = np.where(ref, w + 1, w)
        sw = w == 32
        if sw.any():
            w = np.where(sw, 0, w)
            base = np.where(sw, base + CH, base)
            cur = np.where(sw[:, None], nxt, cur)
            nxt = np.where(sw[:, None], stream_words(base + CH), nxt)
            switches += sw
        out[:, t] = np.where(act & ~is_eof, sym, 0)
    stats = {"prepad": prepad, "refills": refills, "switches": switches,
             "frozen": count >= MAXF, "last_read": last_read}
    return out, eof, stats


def _plain(flat, pitch, byte_lens, out_lens, num_steps):
    B = len(byte_lens)
    syms, eof = ar.decode_rows(
        torch.from_numpy(flat.reshape(B, pitch).copy()),
        torch.from_numpy(np.asarray(byte_lens, np.int32)),
        torch.from_numpy(np.asarray(out_lens, np.int32)),
        num_steps,
    )
    return syms.numpy(), eof.numpy()


def _rows(payloads: list[bytes], pitch: int) -> np.ndarray:
    """Payloads at a row pitch, zero past each, laid end to end."""
    m = np.zeros((len(payloads), pitch), np.uint8)
    for i, p in enumerate(payloads):
        m[i, : len(p)] = np.frombuffer(p, np.uint8)
    return m.reshape(-1)


def _check(flat, pitch, byte_lens, out_lens, num_steps):
    """The model against the plain version; returns the model's output and stats."""
    syms, eof, stats = _decode_model(flat, pitch, byte_lens, out_lens, num_steps)
    syms_p, eof_p = _plain(flat, pitch, byte_lens, out_lens, num_steps)
    assert np.array_equal(eof, eof_p)
    assert np.array_equal(syms, syms_p)
    return syms, eof, stats


KINDS = ["random", "text", "runs", "zeros", "escape", "two_symbols"]


def _kind(kind: str, n: int) -> bytes:
    """tests/test_torch_arith_rows.py's six kinds of block."""
    rng = np.random.default_rng(KINDS.index(kind))
    return {
        "random": lambda: bytes(rng.integers(0, 256, size=n, dtype=np.uint8)),
        "text": lambda: bytes(rng.choice(np.frombuffer(b"etaoin shrdlu ", np.uint8), size=n)),
        "runs": lambda: b"".join(bytes([int(c)]) * int(r) for c, r in zip(
            rng.integers(0, 256, 40), rng.integers(1, 50, 40)))[:n],
        "zeros": lambda: b"\x00" * n,
        "escape": lambda: (b"<<\\\xff,>" * n)[:n],
        "two_symbols": lambda: bytes(rng.integers(0, 2, size=n, dtype=np.uint8)),
    }[kind]()


def _valid(blocks: list[bytes], pitch: int | None = None):
    """Blocks -> (flat rows, pitch, byte lens, out lens) of their oracle payloads; the
    container's pitch (the longest payload + 1) by default."""
    payloads = [arithmetic_ref.compress(b) for b in blocks]
    pitch = pitch or max(map(len, payloads)) + 1
    return _rows(payloads, pitch), pitch, [len(p) for p in payloads], [len(b) for b in blocks]


@pytest.mark.parametrize("kind", KINDS)
def test_model_kinds_match_plain_and_oracle(kind):
    data = _kind(kind, 1000)
    blocks = [data, data[: 1000 // 3], b""]
    flat, pitch, blens, olens = _valid(blocks)
    syms, eof, stats = _check(flat, pitch, blens, olens, 1001)
    assert eof.tolist() == [1, 1, 1]
    for i, b in enumerate(blocks):
        assert syms[i, : len(b)].tobytes() == b == arithmetic_ref.decompress(flat[i * pitch : i * pitch + blens[i]].tobytes())
        assert not syms[i, len(b) :].any()  # steps from EOF on stay 0
    assert (stats["last_read"] < np.array(blens)).all()


def test_model_matches_pallas_interpret():
    """128 blocks, as the Pallas kernel takes them: the six kinds at three lengths,
    early EOF (out_len past the payload), a late EOF (out_len short of it) and empties."""
    blocks = [_kind(k, n) for k in KINDS for n in (1000, 333, 64)]
    olens = [len(b) for b in blocks]
    blocks += [_kind("text", 500), _kind("random", 400)]
    olens += [700, 300]  # EOF decoded at 500 (step 700 is not EOF); step 300 is a byte
    blocks += [b""] * (128 - len(blocks))
    olens += [0] * (128 - len(olens))
    payloads = [arithmetic_ref.compress(b) for b in blocks]
    capb = (max(map(len, payloads)) + 127) // 128 * 128
    flat = _rows(payloads, capb)
    blens = [len(p) for p in payloads]
    steps = 1024
    syms, eof, _ = _check(flat, capb, blens, olens, steps)
    syms_j, eof_j = ap.decode_rows(
        jnp.asarray(flat.reshape(128, capb)), jnp.asarray(np.array(blens, np.int32)),
        jnp.asarray(np.array(olens, np.int32)), num_steps=steps, interpret=True,
    )
    assert np.array_equal(eof, np.asarray(eof_j))
    assert eof[:18].all() and eof[19] == 0
    syms_j = np.asarray(syms_j)
    for i, n in enumerate(olens):
        assert syms[i, :n].tobytes() == syms_j[i, :n].tobytes()
        m = min(n, len(blocks[i]))
        assert syms[i, :m].tobytes() == blocks[i][:m]
    # past an early EOF the interval stays and only cum[257] grows, so every later step decodes EOF
    assert eof[18] == 1 and not syms[18, 500:].any()


def test_model_freezes_on_long_block():
    """More than MAX_FREQ - 257 = 16,126 symbols: the model freezes and stays exact."""
    rng = np.random.default_rng(21)
    n = 16126 + 1500
    data = bytes(rng.choice(np.frombuffer(b"abcdefgh  \n", np.uint8), size=n))
    flat, pitch, blens, olens = _valid([data, data[:200]])
    syms, eof, stats = _check(flat, pitch, blens, olens, n + 1)
    assert stats["frozen"].tolist() == [True, False]
    assert eof.tolist() == [1, 1]
    assert syms[0, :n].tobytes() == data == arithmetic_ref.decompress(flat[: blens[0]].tobytes())
    assert stats["switches"][0] > 40  # the bit supply crossed many buffers


def test_model_out_len_at_or_past_num_steps():
    data = _kind("text", 600)
    flat, pitch, blens, _ = _valid([data, data, data])
    steps = 400
    syms, eof, _ = _check(flat, pitch, blens, [400, 600, 10**6], steps)
    assert eof.tolist() == [0, 0, 0]  # the decode ends at num_steps, without an EOF check
    assert (syms[:, :steps] == np.frombuffer(data[:steps], np.uint8)).all()


def test_model_byte_len_zero_negative_and_past_capb():
    """byte_len is clamped to [0, capb]: 0 decodes the tail alone, past capb reads only the row."""
    rng = np.random.default_rng(5)
    pitch = 301
    flat = rng.integers(0, 256, size=4 * pitch, dtype=np.uint8)
    blens = [0, -7, pitch + 50, pitch]
    _, _, stats = _check(flat, pitch, blens, [500, 500, 900, 900], 1000)
    assert stats["last_read"].tolist()[:2] == [-1, -1]
    assert (stats["last_read"] < pitch).all()
    _check(np.zeros(8, np.uint8), 8, [0], [0], 4)  # the tail alone


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
def test_model_row_pitch_mod_4(extra):
    """Row starts at every alignment: pitches of 0, 1, 2 and 3 mod 4."""
    blocks = [_kind(k, 700) for k in KINDS[:4]]
    payloads = [arithmetic_ref.compress(b) for b in blocks]
    pitch = (max(map(len, payloads)) + 4) // 4 * 4 + extra
    flat, _, blens, olens = _valid(blocks, pitch)
    syms, eof, _ = _check(flat, pitch, blens, olens, 701)
    assert eof.all()
    assert all(syms[i, : len(b)].tobytes() == b for i, b in enumerate(blocks))


def test_model_first_byte_zero_strips_eight_bits():
    """A first byte of 0 is a prepad of all 8 bits: value starts at bit 8."""
    rng = np.random.default_rng(8)
    pitch = 203
    flat = rng.integers(0, 256, size=6 * pitch, dtype=np.uint8)
    flat[::pitch] = [0, 0, 1, 0x80, 0x40, 0xFF]
    blens = [200, 1, 200, 200, 200, 200]
    _, _, stats = _check(flat, pitch, blens, [300] * 6, 320)
    assert stats["prepad"].tolist() == [8, 8, 8, 1, 2, 1]


def test_model_refill_boundaries():
    """Tails at, just before and just after the warp's 128-byte buffers, and long rows
    that cross several buffers, at an odd pitch."""
    rng = np.random.default_rng(13)
    pitch = 777
    blens = [127, 128, 129, 255, 256, 257, 383, 384, 385, 511, 512, 777]
    flat = rng.integers(0, 256, size=len(blens) * pitch, dtype=np.uint8)
    _, _, stats = _check(flat, pitch, blens, [3000] * len(blens), 3001)
    assert stats["switches"].max() >= 2
    assert (stats["last_read"] < np.array(blens)).all()
    # a valid stream of exactly 128 and 256 bytes, its tail the next buffer's first byte
    found = {}
    for kind in ("random", "text"):
        for n in range(20, 600):
            p = arithmetic_ref.compress(_kind(kind, n))
            if len(p) in (128, 256) and len(p) not in found:
                found[len(p)] = _kind(kind, n)
    assert set(found) == {128, 256}
    blocks = list(found.values())
    flat, pitch, blens, olens = _valid(blocks, 515)
    syms, eof, _ = _check(flat, pitch, blens, olens, 400)
    assert eof.all() and all(syms[i, : len(b)].tobytes() == b for i, b in enumerate(blocks))


@pytest.mark.parametrize("seed, pitch", [(0, 64), (1, 1001), (2, 4099)])
def test_model_garbage_rows(seed, pitch):
    """Random payload bytes, lengths and out_lens: the model equals the plain version
    and low <= value <= high holds at every step (asserted in the model)."""
    rng = np.random.default_rng(seed)
    B = 24
    flat = rng.integers(0, 256, size=B * pitch, dtype=np.uint8)
    blens = rng.integers(-3, pitch + 5, size=B)
    olens = rng.integers(-2, 2500, size=B)
    syms, _, stats = _check(flat, pitch, blens, olens, 2048)
    assert syms.any()
    assert (stats["refills"] > 0).any()


def test_div_by_magic_exact_over_the_totals():
    """The narrowing quotients floor(x / t), x = d * cum < 2^16 * 2^14 = 2^30: for every
    total t in [257, MAX_FREQ], L = floor(log2(t - 1)) and m = ceil(2^(32 + L) / t) give
    2^31 <= m < 2^32 and m * t = 2^(32 + L) + e with e * 2^30 <= 2^(32 + L), so
    x * m / 2^(32 + L) = x / t + x * e / (t * 2^(32 + L)) < x / t + 1 / t and the floor is
    floor(x / t) for every x < 2^30; checked on the dividends nearest every multiple."""
    t = np.arange(257, K["MAX_FREQ"] + 1, dtype=np.int64)
    m, L = magic(t)
    e = m * t - (1 << (32 + L))
    assert ((m >= 1 << 31) & (m < 1 << 32)).all()
    assert ((e >= 0) & (e * (1 << 30) <= 1 << (32 + L))).all()
    rng = np.random.default_rng(17)
    for _ in range(8):
        q = rng.integers(0, (1 << 30) // t)
        for off in (-1, 0, 1):
            x = np.clip(q * t + off, 0, (1 << 30) - 1)
            assert np.array_equal(div_by_magic(x, t), x // t)
        x = rng.integers(0, 1 << 30, size=t.size)
        assert np.array_equal(div_by_magic(x, t), x // t)
    top = np.full(t.size, (1 << 30) - 1)
    assert np.array_equal(div_by_magic(top, t), top // t)


def test_model_reads_kernel_constants():
    assert K["MODEL_REGS"] * 32 >= ar.NUM_CUM > (K["MODEL_REGS"] - 1) * 32
    # a pad never passes the search (num < total * d <= MAX_FREQ * d) and its product with d <= 2^16 fits
    assert K["MAX_FREQ"] < K["MODEL_PAD"] and K["MODEL_PAD"] << 16 < 1 << 32
    assert (K["MAX_CODE"], K["ONE_HALF"], K["MAX_FREQ"], K["EOF_SYMBOL"]) == (ar.MAX_CODE, ar.ONE_HALF, ar.MAX_FREQ, ar.EOF)
    assert K["CHUNK_BYTES"] == 128


# ---------------------------------------------------------------------------
# The kernel's own source on the host: arith_decode.cu built with g++ over
# cuda_host/cuda_emu.h (a warp's lanes as threads), held against the plain
# version. The model above checks the design; this checks the source.

HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {  // B capb num_steps in out: rows, byte_lens, out_lens -> syms, eof_ok
    if (argc == 2) {  // out: the division table, (m, L) per total
        FILE* f = fopen(argv[1], "wb");
        fwrite(magic_table.m, sizeof(uint2), MAX_FREQ + 1, f);
        fclose(f);
        return 0;
    }
    const int B = atoi(argv[1]), capb = atoi(argv[2]), S = atoi(argv[3]);
    std::vector<uint8_t> rows((size_t)B * capb), syms((size_t)B * S, 0);
    std::vector<int32_t> bl(B), ol(B), eof(B);
    FILE* f = fopen(argv[4], "rb");
    if (fread(rows.data(), 1, rows.size(), f) + fread(bl.data(), 4, B, f) + fread(ol.data(), 4, B, f) == 0) return 1;
    fclose(f);
    const int rc = rsn_arith_decode(rows.data(), bl.data(), ol.data(), syms.data(), eof.data(), B, capb, S, nullptr);
    f = fopen(argv[5], "wb");
    fwrite(syms.data(), 1, syms.size(), f);
    fwrite(eof.data(), 4, B, f);
    fclose(f);
    return rc;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """A function running kernel C's source, built for the CPU, on numpy rows."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build kernel C's source for the host")
    tmp = tmp_path_factory.mktemp("arith_decode_host")
    cu = (CSRC / "arith_decode.cu").read_text()
    # name<<<grid, block, smem, stream>>>(args) -> emu_launch(name, grid, block, args)
    cu = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\)?)",
                lambda m: f"emu_launch({m[1]}, {m[2]}, {m[3]}{')' if m[4] else ', '}", cu)
    src = tmp / "arith_decode_host.cpp"
    src.write_text('#include "cuda_emu.h"\n' + cu + HOST_MAIN)
    exe = tmp / "arith_decode_host"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(HOST), "-I", str(CSRC), "-o", str(exe),
                    str(src)], check=True, capture_output=True)

    def run(flat=None, pitch=0, byte_lens=(), out_lens=(), num_steps=0):
        """Decode the rows; with no arguments, return the division table as (MAX_FREQ + 1, 2) uint32."""
        if flat is None:
            out = tmp / "table.bin"
            subprocess.run([str(exe), str(out)], check=True)
            return np.frombuffer(out.read_bytes(), np.uint32).reshape(-1, 2)
        B = len(byte_lens)
        inp, out = tmp / "in.bin", tmp / "out.bin"
        inp.write_bytes(flat.tobytes() + np.asarray(byte_lens, np.int32).tobytes()
                        + np.asarray(out_lens, np.int32).tobytes())
        subprocess.run([str(exe), str(B), str(pitch), str(num_steps), str(inp), str(out)], check=True)
        raw = out.read_bytes()
        return (np.frombuffer(raw[: B * num_steps], np.uint8).reshape(B, num_steps),
                np.frombuffer(raw[B * num_steps :], np.int32))

    return run


@pytest.mark.parametrize("seed, pitch", [(3, 1001), (4, 64)])
def test_kernel_source_on_host_garbage_rows(host_kernel, seed, pitch):
    rng = np.random.default_rng(seed)
    B = 12
    flat = rng.integers(0, 256, size=B * pitch, dtype=np.uint8)
    blens, olens = rng.integers(-3, pitch + 6, size=B), rng.integers(-2, 2500, size=B)
    syms, eof = host_kernel(flat, pitch, blens, olens, 2048)
    syms_p, eof_p = _plain(flat, pitch, blens, olens, 2048)
    assert np.array_equal(eof, eof_p) and np.array_equal(syms, syms_p)


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
def test_kernel_source_on_host_kinds_at_every_pitch(host_kernel, extra):
    blocks = [_kind(k, 500) for k in KINDS] + [_kind("text", 200)]
    olens = [len(b) for b in blocks[:-1]] + [300]  # the last: EOF before step out_len
    payloads = [arithmetic_ref.compress(b) for b in blocks]
    pitch = (max(map(len, payloads)) + 4) // 4 * 4 + extra
    flat, blens = _rows(payloads, pitch), [len(p) for p in payloads]
    syms, eof = host_kernel(flat, pitch, blens, olens, 512)
    syms_p, eof_p = _plain(flat, pitch, blens, olens, 512)
    assert np.array_equal(eof, eof_p) and np.array_equal(syms, syms_p)
    assert eof[:-1].all() and all(syms[i, : len(b)].tobytes() == b for i, b in enumerate(blocks))


def test_kernel_source_on_host_freezes(host_kernel):
    rng = np.random.default_rng(22)
    data = bytes(rng.choice(np.frombuffer(b"abcdefgh  \n<>\xff\x00", np.uint8), size=K["MAX_FREQ"] + 2000))
    flat, pitch, blens, olens = _valid([data])
    syms, eof = host_kernel(flat, pitch, blens, olens, len(data) + 1)
    assert eof.tolist() == [1] and syms[0, : len(data)].tobytes() == data


def test_kernel_source_on_host_division_table(host_kernel):
    """The table that the compiler builds for the kernel holds magic(t) for every total."""
    table = host_kernel().astype(np.int64)
    t = np.arange(2, K["MAX_FREQ"] + 1, dtype=np.int64)
    m, L = magic(t)
    assert table.shape == (K["MAX_FREQ"] + 1, 2)
    assert np.array_equal(table[2:, 0], m) and np.array_equal(table[2:, 1], L)
