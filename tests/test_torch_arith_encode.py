"""Kernel A (csrc/arith_encode.cu) modelled on the CPU, against the plain
version, the JAX package and the host oracle.

Kernel A runs only on the card, so ``_encode_model`` mirrors it in numpy,
one warp per block, vectorised over blocks: the symbols 32 per load with
the next 32 loaded a chunk ahead, the register-resident model (lane l holds
cum[l + 32 j] in register j) read a step ahead by a select over the
registers and a shuffle from the owner lane (reg_model_bounds), the update
as register adds under the freeze, the coder state (low, the range d), the
two narrowing quotients as a multiply-high and a shift by a magic number
(encode_narrow32), the closed-form renormalisation (renorm_counts), and the
bit writer: one string of at most 32 bits a step into a 64-bit accumulator,
a word stored by lane 0 as it fills and dropped past the row, and the
long-run path for a pending run past 32 - k bits. Its constants are read
from the kernel's sources. The model is held, exactly (tolerance 0: the
outputs are bits), against ``arithmetic_rows._encode_bits_torch`` (the
wrapper's route for CPU tensors), and through kernel B's plain version
against ``raisin_tpu.formats.arithmetic_ref`` and
``raisin_tpu.ops.arithmetic_pallas.encode_rows`` in Pallas interpret mode;
at every step it asserts the coder's invariant. The kernel's own source
runs here too, built with g++ over ``tests/cuda_host/cuda_emu.h`` (a warp's
lanes as threads) and held against the same. Inputs come from seeded numpy.

The two mirrors check different things. The built source cannot drift from
the kernel, but it checks outputs only, and it skips on a host without
g++. The model states the design lane by lane and asserts at every step
what the kernel cannot check itself (the invariant, the dividends below
2^30, no string past 32 bits, the accumulator's headroom), and it counts
the edges each input reached: the long-run path, the longest pending run,
steps with low == high, the freeze, stores dropped past the row and a
stream that ends on a word boundary. A change to the kernel's step changes
the model with it.
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
from tests.test_torch_arith_decode import KINDS, _clz32, _kind, div_by_magic

torch.set_num_threads(1)

CSRC = Path(ar.__file__).resolve().parent.parent / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"


@functools.cache
def _constants() -> dict[str, int]:
    """Kernel A's integer constants, read from its sources (the model mirrors them)."""
    src = (CSRC / "arith_common.cuh").read_text() + (CSRC / "arith_encode.cu").read_text()
    found = re.findall(r"constexpr (?:int|uint32_t) (\w+) = (0x[0-9A-Fa-f]+|\d+|\w+ - \w+)u?;", src)
    out: dict[str, int] = {}
    for k, v in found:  # a literal, or the difference of two constants defined before it
        a, _, b = v.partition(" - ")
        out[k] = out[a] - out[b] if b else int(v, 0)
    return out


K = _constants()
M32 = 0xFFFFFFFF
U64 = np.uint64


def _encode_model(symbols: np.ndarray, lengths, capw: int):
    """Kernel A on symbols (B, S) with EOF at ``lengths[b]``.

    Returns (raw (B, capw) int32, bits (B,) int32, oflow (B,) int32, stats),
    where stats counts, per block, the steps that took the long-run path,
    the longest pending run released, the steps with nl == nh (k = 16), the
    words dropped past the row, whether the model froze and whether the
    stream ended on a word boundary.
    """
    B, S = symbols.shape
    R, PAD, NUM_CUM = K["MODEL_REGS"], K["MODEL_PAD"], K["NUM_CUM"]
    HALF, Q1, Q3 = K["ONE_HALF"], K["ONE_FOURTH"], K["THREE_FOURTHS"]
    MAXC, MAXF, T0 = K["MAX_CODE"], K["MAX_FREQ"], K["INIT_TOTAL"]
    sym = np.asarray(symbols, np.int64)
    steps = np.minimum(np.asarray(lengths, np.int64) + 1, S)
    rows = np.arange(B)
    lane = np.arange(32)

    def load(i: np.ndarray) -> np.ndarray:
        """Each lane's coalesced load of symbol i (B, 32), clamped into the row."""
        return sym[rows[:, None], np.clip(i, 0, S - 1)]

    # the chunk of 32 symbols that holds step t and the one after it (0 past the steps at first)
    chunk = np.where(lane[None] < steps[:, None], load(lane[None]), 0)
    nxt = np.where(32 + lane[None] < steps[:, None], load(32 + lane[None]), 0)
    s0, s1, s2 = chunk[:, 0], chunk[:, 1], chunk[:, 2]

    idx = lane[:, None] + 32 * np.arange(R)[None, :]  # (32, R): the entry each register holds
    c = np.broadcast_to(np.where(idx < NUM_CUM, idx, PAD), (B, 32, R)).copy()
    pairs = None  # the frozen model, cum[i] | cum[i + 1] << 16

    def select(regs: np.ndarray, j: np.ndarray) -> np.ndarray:
        """reg_select: the tree of selects on the bits of j, per lane (B, 32)."""
        pick = lambda a, b, bit: np.where((j & bit)[:, None] != 0, regs[:, :, b], a)  # noqa: E731
        lo = [pick(regs[:, :, 2 * q], 2 * q + 1, 1) for q in range(4)]
        mid = [np.where((j & 2)[:, None] != 0, lo[2 * q + 1], lo[2 * q]) for q in range(2)]
        top = np.where((j & 4)[:, None] != 0, mid[1], mid[0])
        return np.where((j & 8)[:, None] != 0, regs[:, :, 8], top)

    def bounds(s: np.ndarray):
        """reg_model_bounds before the freeze, reg_pairs_bounds after: select, then shuffle."""
        if pairs is None:
            return select(c, s >> 5)[rows, s & 31], select(c, (s + 1) >> 5)[rows, (s + 1) & 31]
        v = select(pairs, s >> 5)[rows, s & 31]
        return v & 0xFFFF, v >> 16

    magic_total = np.full(B, T0, np.int64)  # the total whose magic number the next quotients use
    lower, upper = bounds(s0)
    ahead_lo, ahead_hi = bounds(s1)
    low = np.zeros(B, np.int64)
    d = np.full(B, MAXC + 1, np.int64)
    pending = np.zeros(B, np.int64)

    def quotients(d, lower, upper, total):
        """encode_narrow32: the dividends stay below 2^30."""
        assert ((d * upper < 1 << 30) & (lower < upper) & (upper <= total))[act].all()
        return div_by_magic(d * lower, total), div_by_magic(d * upper, total)

    act = steps > 0
    q_lo, q_hi = quotients(d, lower, upper, magic_total)

    raw = np.zeros((B, capw), np.uint32)
    acc = np.zeros(B, U64)
    nb = np.zeros(B, np.int64)
    wp = np.zeros(B, np.int64)  # words completed; lane 0 stores those below capw
    stats = {k: np.zeros(B, np.int64) for k in ("long_runs", "longest_run", "equal", "dropped")}

    def put(v, ln, mask):
        """BitWriter.put where ``mask``: append the low ln bits of v at the bottom of acc,
        store the word that fills."""
        assert ((ln >= 0) & (ln <= 32) & (v >= 0) & ((v >> ln) == 0) & (nb < 32))[mask].all()
        acc[:] = np.where(mask, (acc << ln.astype(U64)) | v.astype(U64), acc)
        nb[:] = np.where(mask, nb + ln, nb)
        full = mask & (nb >= 32)
        st = full & (wp < capw)
        raw[rows[st], wp[st]] = ((acc[st] >> ((nb[st] - 32) & 31).astype(U64)) & U64(M32)).astype(np.uint32)
        stats["dropped"] += full & ~st
        wp[:] += full
        nb[:] = np.where(full, nb - 32, nb)

    for t in range(int(steps.max(initial=0))):
        act = t < steps
        updates = t < K["UPDATE_STEPS"]
        if t == K["UPDATE_STEPS"]:  # reg_pairs_from_model: each entry's successor from the next lane
            right = np.roll(c, -1, axis=1)
            right[:, 31, :-1] = c[:, 0, 1:]
            pairs = c | (right << 16)
            assert (c[:, :, :8] < 1 << 16).all() and (c[:, :2, 8] < 1 << 16).all()
        # step t: the quotients taken a step ahead, then the closed-form renormalisation
        nh = low + q_hi - 1
        nl = low + q_lo
        assert ((low <= nl) & (nl <= nh) & (nh <= low + d - 1))[act].all()
        k = _clz32(nl ^ nh) - 16
        e3 = np.where(k + 17 < 32, ((nl & ~nh & M32) << np.minimum(k + 17, 31)) & M32, 0)
        m = _clz32(~e3 & M32)
        sh = k + m
        assert (sh <= 16).all()
        stats["equal"] += act & (k == 16)
        new_low = ((nl << sh) & MAXC) ^ np.where(m > 0, HALF, 0)
        new_d = (nh - nl + 1) << sh
        # renormalised: low < 1/2 <= high <= MAX_CODE, and not inside [1/4, 3/4)
        high = new_low + new_d - 1
        assert ((new_low < HALF) & (HALF <= high) & (high <= MAXC) & ((new_low < Q1) | (high >= Q3)))[act].all()
        low, d = np.where(act, new_low, low), np.where(act, new_d, d)

        # step t + 1's quotients: its bounds, read before step t's update, brought past it
        upd = act & updates
        lower = ahead_lo + (upd & (s1 > s0))
        upper = ahead_hi + (upd & (s1 >= s0))
        magic_total = magic_total + upd
        q_lo, q_hi = quotients(d, lower, upper, magic_total)
        # step t's update, step t + 2's bounds, step t + 3's symbol from the chunk or the next
        su = np.where(upd, s0, NUM_CUM)
        c += ((idx[None] < NUM_CUM) & (idx[None] > su[:, None, None])).astype(np.int64)
        ahead_lo, ahead_hi = bounds(s2)
        s0, s1 = s1, s2
        s2 = (nxt if (t & 31) >= 29 else chunk)[:, (t + 3) & 31]
        if ((t + 1) & 31) == 0:  # the turn at the next step
            chunk, nxt = nxt, load(t + 33 + lane[None])

        # the step's output: b, pending copies of !b, the other k - 1 shared bits
        emit = act & (k > 0)
        h = (1 << k) >> 1
        pat = nl >> (16 - k)
        fast = act & ((k == 0) | (pending <= 32 - k))
        put(pat + (h << np.where(fast, pending & 31, 0)) - h, np.where(emit, k + pending, 0), fast)
        slow = act & ~fast
        if slow.any():
            bit = np.where(pat & h, 1, 0)
            put(bit, np.ones(B, np.int64), slow)
            left = np.where(slow, pending, 0)
            while (left > 0).any():
                take = np.minimum(left, 32)
                put(np.where(bit, 0, (1 << take) - 1), take, left > 0)
                left -= take
            put(pat & (h - 1), k - 1, slow)
            stats["long_runs"] += slow
        stats["longest_run"] = np.maximum(stats["longest_run"], np.where(emit, pending, 0))
        pending = np.where(act, np.where(k > 0, m, pending + m), pending)

    # trailing pending bits are dropped; lane 0 stores the last partial word
    total_bits = wp * 32 + nb
    tail = (nb > 0) & (wp < capw)
    raw[rows[tail], wp[tail]] = ((acc[tail] << (32 - nb[tail]).astype(U64)) & U64(M32)).astype(np.uint32)
    stats["frozen"] = steps > K["UPDATE_STEPS"] - 1
    stats["aligned"] = (nb == 0) & (total_bits > 0)
    oflow = (total_bits + 8 > 32 * capw).astype(np.int32)
    return raw.view(np.int32), total_bits.astype(np.int32), oflow, stats


def _symbols(blocks: list[bytes], S: int | None = None, past_eof: int = 0):
    """(symbols (B, S) int32 with EOF at each length, lengths); past EOF: random symbols
    from seed ``past_eof`` (the kernel must not read them) or EOF (0)."""
    S = S or max(map(len, blocks)) + 1
    rng = np.random.default_rng(past_eof)
    symbols = (rng.integers(0, 257, size=(len(blocks), S)) if past_eof else np.full((len(blocks), S), 256))
    symbols = symbols.astype(np.int32)
    for i, p in enumerate(blocks):
        symbols[i, : len(p)] = np.frombuffer(p, np.uint8)
        if len(p) < S:
            symbols[i, len(p)] = 256
    return symbols, np.array([len(p) for p in blocks], np.int32)


def _plain(symbols, lengths, capw):
    raw, bits, oflow = ar._encode_bits_torch(torch.from_numpy(symbols), torch.from_numpy(lengths), capw)
    return raw.numpy(), bits.numpy(), oflow.numpy()


def _payloads(raw, bits) -> list[bytes]:
    """Kernel B's plain version on the raw rows: each block's `.rsn` bytes."""
    rows, blens = ar._prepad_torch(torch.from_numpy(np.ascontiguousarray(raw)), torch.from_numpy(bits))
    return [rows[i, : int(n)].numpy().tobytes() for i, n in enumerate(blens)]


def _check(symbols, lengths, capw=None):
    """The model against the plain version; returns the model's outputs and stats."""
    capw = capw or ar.capw_bound(symbols.shape[1])
    raw, bits, oflow, stats = _encode_model(symbols, lengths, capw)
    raw_p, bits_p, oflow_p = _plain(symbols, lengths, capw)
    assert np.array_equal(bits, bits_p) and np.array_equal(oflow, oflow_p)
    assert np.array_equal(raw, raw_p)
    return raw, bits, oflow, stats


def _straddling(n: int, release: list[int], prefix: bytes = b"") -> bytes:
    """``prefix``, then n symbols, each chosen so that its interval straddles the half (no
    E1/E2 shift, the most E3 shifts): the pending run grows by ~8 bits a step. Then
    ``release``, whose first symbol ends the run. The reference coder, in Python."""
    cum = list(range(ar.NUM_CUM))
    low, high, out = 0, ar.MAX_CODE, []

    def narrow(s):
        d, total = high - low + 1, cum[-1]
        return low + d * cum[s] // total, low + d * cum[s + 1] // total - 1

    def code(s):
        nonlocal low, high
        low, high = narrow(s)
        while True:
            if high < 0x8000 or low >= 0x8000:
                low, high = (low << 1) & 0xFFFF, ((high << 1) | 1) & 0xFFFF
            elif low >= 0x4000 and high < 0xC000:
                low, high = (low - 0x4000) << 1, ((high - 0x4000) << 1) | 1
            else:
                break
        for i in range(s + 1, ar.NUM_CUM):
            cum[i] += 1
        out.append(s)

    for s in prefix:
        code(s)
    for _ in range(n):
        straddle = [s for s in range(256) if narrow(s)[0] < 0x8000 <= narrow(s)[1]]
        code(max(straddle, key=lambda s: narrow(s)[1] - narrow(s)[0]) if straddle else 0)
    for s in release:
        code(s)
    return bytes(out)


# ---------------------------------------------------------------------------
# The model


@pytest.mark.parametrize("kind", KINDS)
def test_model_kinds_match_plain_and_oracle(kind):
    data = _kind(kind, 1500)
    blocks = [data, data[:333], data[:1], b""]
    symbols, lengths = _symbols(blocks)
    raw, bits, _, _ = _check(symbols, lengths)
    assert _payloads(raw, bits) == [arithmetic_ref.compress(b) for b in blocks]


def test_model_matches_pallas_interpret():
    symbols, lengths, blocks = _pallas_input()
    raw, bits, oflow, _ = _check(symbols, lengths)
    _assert_pallas(raw, bits, oflow, blocks)


def test_model_freezes_on_long_block():
    """More than MAX_FREQ - 257 = 16,126 symbols: the model freezes at step 16,126."""
    rng = np.random.default_rng(21)
    data = bytes(rng.choice(np.frombuffer(b"abcdefgh  \n<>\xff\x00", np.uint8), size=K["MAX_FREQ"] + 700))
    edge = data[: K["MAX_FREQ"] - 257 - 1]  # its EOF is the update that takes count to MAX_FREQ
    # symbols of count 1 against the frozen total, between runs that narrow the range: nl == nh
    rare = b"a" * 16200 + b"".join(b"a" * (c % 13) + bytes([c]) for c in range(98, 256))
    blocks = [data, edge, data[: len(edge) - 1], rare]
    raw, bits, _, stats = _check(*_symbols(blocks))
    assert stats["frozen"].tolist() == [True, True, False, True]
    assert stats["equal"][3] > 0  # nl == nh: k = 16
    assert _payloads(raw, bits) == [arithmetic_ref.compress(b) for b in blocks]


def test_model_long_pending_runs():
    """Pending runs of 64 bits and more, released as 0 then 1s and as 1 then 0s: the
    long-run path, across several word boundaries."""
    blocks = [_straddling(12, [0, 7, 255]), _straddling(20, [255, 3]), _straddling(3, [0])]
    symbols, lengths = _symbols(blocks)
    raw, bits, _, stats = _check(symbols, lengths)
    assert (stats["longest_run"][:2] > 64).all() and (stats["long_runs"][:2] > 0).all()
    assert stats["long_runs"][2] == 0 and stats["longest_run"][2] > 16
    assert _payloads(raw, bits) == [arithmetic_ref.compress(b) for b in blocks]


def test_model_small_capw_flags_and_drops():
    """A row too small for the stream: oflow set, stores past the row dropped, bits the
    full count, the row holding the stream's first 32 * capw bits."""
    blocks = [_kind("random", 600), _kind("text", 600), _kind("zeros", 600), b""]
    symbols, lengths = _symbols(blocks)
    full_raw, full_bits, _, _ = _check(symbols, lengths)
    capw = (int(full_bits[2]) + 8 + 31) // 32  # the zeros' stream fits, the others' do not
    raw, bits, oflow, stats = _check(symbols, lengths, capw)
    assert np.array_equal(bits, full_bits)
    assert oflow.tolist() == [1, 1, 0, 0] and (stats["dropped"][:2] > 0).all()
    assert np.array_equal(raw[:2], full_raw[:2, :capw])


def test_model_batch_edges():
    """B not a multiple of the CTA's 4 warps, lengths 0 (EOF alone), S past lengths + 1 with
    random symbols past EOF, a block cut at S (no EOF), and a stream ending on a word."""
    blocks = [_kind(k, 900) for k in KINDS] + [b""]
    symbols, lengths = _symbols(blocks, S=1024, past_eof=9)
    lengths[1] = 1100  # past S: the block's first S symbols, no EOF
    raw, bits, _, _ = _check(symbols, lengths)
    assert len(blocks) % 4 == 3
    want = [arithmetic_ref.compress(b) for b in blocks]
    got = _payloads(raw, bits)
    assert got[:1] + got[2:] == want[:1] + want[2:]
    # streams whose bit count is a multiple of 32: the tail store is skipped
    texts = [_kind("text", n) for n in range(1, 200)]
    _, bits_t, _, stats = _check(*_symbols(texts))
    assert np.array_equal(stats["aligned"], bits_t % 32 == 0) and stats["aligned"].any()


def test_model_reads_kernel_constants():
    assert K["MODEL_REGS"] * 32 >= ar.NUM_CUM > (K["MODEL_REGS"] - 1) * 32
    assert (K["MAX_CODE"], K["ONE_HALF"], K["ONE_FOURTH"], K["MAX_FREQ"], K["EOF_SYMBOL"]) == (
        ar.MAX_CODE, ar.ONE_HALF, ar.ONE_FOURTH, ar.MAX_FREQ, ar.EOF)
    # the dividends d * cum < 2^16 * 2^14: div_by_total's range
    assert (K["MAX_CODE"] + 1) * K["MAX_FREQ"] < 1 << 30
    assert K["WARPS_PER_CTA"] == 4
    # the model updates in steps [0, UPDATE_STEPS): the total runs from 257 to MAX_FREQ
    assert K["INIT_TOTAL"] == ar.NUM_CUM - 1 and K["UPDATE_STEPS"] == ar.MAX_FREQ - (ar.NUM_CUM - 1)
    assert 32 % K["STEP_GROUP"] == 0  # a group never straddles a chunk's turn


# ---------------------------------------------------------------------------
# The JAX package's Pallas kernel in interpret mode (B % 128 == 0, S % 128 == 0)


@functools.cache
def _pallas_input():
    """128 blocks of S = 512: the six kinds at three lengths, a long pending run, empties."""
    blocks = [_kind(k, n) for k in KINDS for n in (511, 200, 31)]
    blocks += [_straddling(12, [0, 5]), _straddling(20, [255])]
    blocks += [b""] * (128 - len(blocks))
    symbols, lengths = _symbols(blocks, S=512)
    return symbols, lengths, blocks


@functools.cache
def _pallas_rows():
    symbols, lengths, _ = _pallas_input()
    rows, blens, oflow = ap.encode_rows(jnp.asarray(symbols), jnp.asarray(lengths), capw=1024, interpret=True)
    return np.asarray(rows), np.asarray(blens), np.asarray(oflow)


def _assert_pallas(raw, bits, oflow, blocks):
    rows_j, bl_j, of_j = _pallas_rows()
    assert not oflow.any()
    got = _payloads(raw, bits)
    assert of_j[18:20].all()  # the TPU kernel flags pending runs past its 31-bit carry; kernel A has none
    for i, b in enumerate(blocks):
        if not of_j[i]:
            assert len(got[i]) == bl_j[i] and got[i] == rows_j[i].tobytes()[: bl_j[i]], f"block {i} differs from Pallas"
        assert got[i] == arithmetic_ref.compress(b), f"block {i} differs from the oracle"


# ---------------------------------------------------------------------------
# The kernel's own source on the host: arith_encode.cu built with g++ over
# cuda_host/cuda_emu.h (a warp's lanes as threads), held against the plain
# version. The model above checks the design; this checks the source.

HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {  // B S capw in out: symbols, lengths -> raw, bits, oflow
    const int B = atoi(argv[1]), S = atoi(argv[2]), capw = atoi(argv[3]);
    std::vector<int32_t> sym((size_t)B * S), len(B), bits(B), oflow(B);
    const size_t guard = 64;  // words after the rows that no store may touch
    std::vector<uint32_t> raw((size_t)B * capw + guard, 0);
    for (size_t i = (size_t)B * capw; i < raw.size(); ++i) raw[i] = 0xA5A5A5A5u;
    FILE* f = fopen(argv[4], "rb");
    if (fread(sym.data(), 4, sym.size(), f) + fread(len.data(), 4, B, f) == 0) return 1;
    fclose(f);
    const int rc = rsn_arith_encode(sym.data(), len.data(), raw.data(), bits.data(), oflow.data(), B, S, capw, nullptr);
    f = fopen(argv[5], "wb");
    fwrite(raw.data(), 4, (size_t)B * capw, f);
    fwrite(bits.data(), 4, B, f);
    fwrite(oflow.data(), 4, B, f);
    fclose(f);
    for (size_t i = (size_t)B * capw; i < raw.size(); ++i)
        if (raw[i] != 0xA5A5A5A5u) return 3;  // a store past the last row
    return rc;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """A function running kernel A's source, built for the CPU, on numpy symbols."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build kernel A's source for the host")
    tmp = tmp_path_factory.mktemp("arith_encode_host")
    cu = (CSRC / "arith_encode.cu").read_text()
    # name<<<grid, block, smem, stream>>>(args) -> emu_launch(name, grid, block, args)
    cu = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\)?)",
                lambda m: f"emu_launch({m[1]}, {m[2]}, {m[3]}{')' if m[4] else ', '}", cu)
    src = tmp / "arith_encode_host.cpp"
    src.write_text('#include "cuda_emu.h"\n' + cu + HOST_MAIN)
    exe = tmp / "arith_encode_host"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(HOST), "-I", str(CSRC), "-o", str(exe),
                    str(src)], check=True, capture_output=True)

    def run(symbols: np.ndarray, lengths, capw: int):
        B, S = symbols.shape
        inp, out = tmp / "in.bin", tmp / "out.bin"
        inp.write_bytes(np.ascontiguousarray(symbols, np.int32).tobytes() + np.asarray(lengths, np.int32).tobytes())
        subprocess.run([str(exe), str(B), str(S), str(capw), str(inp), str(out)], check=True)
        r = np.frombuffer(out.read_bytes(), np.int32).copy()
        return r[: B * capw].reshape(B, capw), r[B * capw : B * capw + B], r[B * capw + B :]

    return run


def _check_host(host_kernel, symbols, lengths, capw=None):
    capw = capw or ar.capw_bound(symbols.shape[1])
    raw, bits, oflow = host_kernel(symbols, lengths, capw)
    raw_p, bits_p, oflow_p = _plain(symbols, lengths, capw)
    assert np.array_equal(bits, bits_p) and np.array_equal(oflow, oflow_p) and np.array_equal(raw, raw_p)
    return raw, bits, oflow


def test_kernel_source_on_host_kinds_and_edges(host_kernel):
    """The six kinds, lengths 0 and past S, random symbols past EOF, B % 4 == 3."""
    blocks = [_kind(k, 700) for k in KINDS] + [b""]
    symbols, lengths = _symbols(blocks, S=768, past_eof=4)
    lengths[2] = 900
    raw, bits, _ = _check_host(host_kernel, symbols, lengths)
    got, want = _payloads(raw, bits), [arithmetic_ref.compress(b) for b in blocks]
    assert got[:2] + got[3:] == want[:2] + want[3:]


def test_kernel_source_on_host_matches_pallas_interpret(host_kernel):
    symbols, lengths, blocks = _pallas_input()
    _assert_pallas(*_check_host(host_kernel, symbols, lengths), blocks)


def test_kernel_source_on_host_freezes(host_kernel):
    rng = np.random.default_rng(22)
    data = bytes(rng.choice(np.frombuffer(b"abcdefgh  \n<>\xff\x00", np.uint8), size=K["MAX_FREQ"] + 2000))
    raw, bits, _ = _check_host(host_kernel, *_symbols([data]))
    assert _payloads(raw, bits) == [arithmetic_ref.compress(data)]


def test_kernel_source_on_host_long_runs_and_small_capw(host_kernel):
    blocks = [b"", _straddling(12, [0, 7, 255]), _straddling(20, [255, 3]), _kind("random", 400)]
    symbols, lengths = _symbols(blocks)
    raw, bits, _ = _check_host(host_kernel, symbols, lengths)
    assert _payloads(raw, bits) == [arithmetic_ref.compress(b) for b in blocks]
    # the last row overflows too: the harness fails on a store past it
    _, _, oflow = _check_host(host_kernel, symbols, lengths, capw=3)
    assert oflow.tolist() == [0, 1, 1, 1]
