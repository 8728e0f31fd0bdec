"""Kernel I (csrc/arith_events.cu) modelled on the CPU, against the plain
version and the JAX package.

Kernel I runs only on the card, in three passes: the model (every step's
bounds, lower | upper << 16, from tiles of MODEL_TILE steps before the
freeze that start from the counts of the tiles before them, and from the
frozen model after it), the coder's chain (nl | k << 16 and slot0 a step)
and the records (the 16 slot bytes from nl and k). ``_model_pass``,
``_chain_pass`` and ``_records_pass`` mirror them in numpy, vectorised over
blocks (and, in pass 1, over tiles), with the constants read from the
kernel's sources. They are held, exactly (tolerance 0: the outputs are
bytes and counts), against the plain version's pieces: pass 1 against
``arithmetic_rows._model_tables``, pass 2's (nl, k, m) against its coder
loop ``_coder_shifts``, and the records against ``_encode_events_torch``
(the wrapper's route for CPU tensors); pass 2 asserts the coder's invariant
at every step. The kernel's own source runs here too, built with g++ over
``tests/cuda_host/cuda_emu.h`` (a CTA's threads as threads, warps
exchanging through barriers), and is held against the plain version, the
Pallas kernel ``raisin_tpu.ops.arithmetic_pallas.encode_blocks_events`` in
interpret mode and the XLA scan ``raisin_tpu.ops.arithmetic_scan._events_xla``;
its pass 1 also alone, against ``_model_tables``. Inputs come from seeded
numpy and ``bench.make_corpus``.
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

import bench
from raisin_tpu.ops import arithmetic_pallas as ap
from raisin_tpu.ops import arithmetic_scan as jax_scan
from raisin_tpu_torch.ops import arithmetic_rows as ar
from tests.test_torch_arith_decode import KINDS, _clz32, _kind, div_by_magic
from tests.test_torch_arith_encode import _straddling, _symbols

torch.set_num_threads(1)

CSRC = Path(ar.__file__).resolve().parent.parent / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"


@functools.cache
def _constants() -> dict[str, int]:
    """Kernel I's integer constants, read from its sources (the model mirrors them)."""
    src = (CSRC / "arith_common.cuh").read_text() + (CSRC / "arith_events.cu").read_text()
    found = re.findall(r"constexpr (?:int|uint32_t) (\w+) = (0x[0-9A-Fa-f]+|\d+u? << \d+|\d+|\w+ - \w+)u?;", src)
    out: dict[str, int] = {}
    for k, v in found:  # a literal, a shifted literal, or the difference of two constants defined before it
        a, _, b = v.partition(" - ")
        x, _, sh = v.partition(" << ")
        out[k] = out[a] - out[b] if b else int(x.rstrip("u"), 0) << int(sh) if sh else int(v, 0)
    return out


K = _constants()
M32 = 0xFFFFFFFF


def _cum_from_counts(counts: np.ndarray) -> np.ndarray:
    """reg_model_from_counts: cum[i] = i + the counts of the symbols below i, (..., 257) -> (..., 258)."""
    below = np.concatenate([np.zeros(counts.shape[:-1] + (1,), np.int64), np.cumsum(counts, -1)], -1)
    return np.arange(K["NUM_CUM"]) + below


def _model_pass(symbols: np.ndarray, lengths) -> np.ndarray:
    """Pass 1 on symbols (B, S): every step's bounds word lower | upper << 16, (B, S) int64.

    Warp w walks the steps [w * MODEL_TILE, (w + 1) * MODEL_TILE) before the
    freeze from the model that the counts of the tiles before it give; all
    tiles step together here, as on the card. Every later step looks up the
    frozen model, the one after all tiles.
    """
    B, S = symbols.shape
    tile, warps, frozen_at = K["MODEL_TILE"], K["MODEL_WARPS"], K["UPDATE_STEPS"]
    assert warps * tile >= frozen_at
    sym = np.asarray(symbols, np.int64)
    steps = np.minimum(np.asarray(lengths, np.int64) + 1, S)
    updates = np.minimum(steps, frozen_at)  # the steps that update the model
    rows = np.arange(B)
    P = min(S, frozen_at)
    t = np.arange(P)
    counts = np.zeros((B, warps, K["EOF_SYMBOL"] + 1), np.int64)
    np.add.at(counts, (rows[:, None], (t // tile)[None], sym[:, :P]), (t[None] < updates[:, None]).astype(np.int64))
    cum = _cum_from_counts(np.cumsum(counts, 1) - counts)  # (B, warps, 258): each tile's first model
    words = np.full((B, S), K["PAST_EOF"], np.int64)
    idx = np.arange(K["NUM_CUM"])
    for j in range(tile):
        tt = np.arange(warps) * tile + j
        live = tt < P
        tt = tt[live]
        s = sym[:, tt]
        act = tt[None] < updates[:, None]
        c = cum[:, live]
        lower = np.take_along_axis(c, np.where(act, s, 0)[..., None], 2)[..., 0]
        upper = np.take_along_axis(c, np.where(act, s + 1, 1)[..., None], 2)[..., 0]
        words[:, tt] = np.where(act, lower | upper << 16, K["PAST_EOF"])
        cum[:, live] += (idx > s[..., None]) & act[..., None]
    if S > frozen_at:
        frozen = _cum_from_counts(counts.sum(1))  # (B, 258)
        s = np.where(np.arange(frozen_at, S)[None] < steps[:, None], sym[:, frozen_at:], -1)
        f = lambda i: np.take_along_axis(frozen, np.maximum(i, 0), 1)  # noqa: E731
        words[:, frozen_at:] = np.where(s >= 0, f(s) | f(s + 1) << 16, K["PAST_EOF"])
    assert (cum[..., -1] <= K["MAX_FREQ"]).all()
    return words


def _chain_pass(words: np.ndarray, lengths):
    """Pass 2 on the bound words (B, S): the coder's chain.

    Returns (nl, k, m, slot0), (B, S) int64 each, 0 past EOF. The
    quotients by the step's total
    min(INIT_TOTAL + t, MAX_FREQ) are a multiply-high and a shift by its
    magic number (encode_narrow32), the shifts closed-form (renorm_counts);
    the pending count rides beside the chain.
    """
    B, S = words.shape
    HALF, Q1, Q3, MAXC = K["ONE_HALF"], K["ONE_FOURTH"], K["THREE_FOURTHS"], K["MAX_CODE"]
    steps = np.minimum(np.asarray(lengths, np.int64) + 1, S)
    low = np.zeros(B, np.int64)
    d = np.full(B, MAXC + 1, np.int64)
    pending = np.zeros(B, np.int64)
    out = np.zeros((4, B, S), np.int64)  # nl, k, m, slot0
    for t in range(int(steps.max(initial=0))):
        act = t < steps
        lower, upper = words[:, t] & 0xFFFF, words[:, t] >> 16
        total = np.full(B, min(K["INIT_TOTAL"] + t, K["MAX_FREQ"]))
        assert ((lower < upper) & (upper <= total) & (d * upper < 1 << 30))[act].all()
        nl = low + div_by_magic(d * lower, total)
        nh = low + div_by_magic(d * upper, total) - 1
        assert ((low <= nl) & (nl <= nh) & (nh <= low + d - 1) & (nh <= MAXC))[act].all()
        k = _clz32(nl ^ nh) - 16
        e3 = np.where(k + 17 < 32, ((nl & ~nh & M32) << np.minimum(k + 17, 31)) & M32, 0)
        m = _clz32(~e3 & M32)
        sh = k + m
        new_low = ((nl << sh) & MAXC) ^ np.where(m > 0, HALF, 0)
        new_d = (nh - nl + 1) << sh
        high = new_low + new_d - 1  # renormalised: low < 1/2 <= high, and not inside [1/4, 3/4)
        assert ((sh <= 16) & (new_low < HALF) & (HALF <= high) & (high <= MAXC) & ((new_low < Q1) | (high >= Q3)))[act].all()
        out[:, :, t] = np.where(act, [nl, k, m, np.where(k > 0, pending, 0)], 0)
        pending = np.where(act, np.where(k > 0, m, pending + m), pending)
        low, d = np.where(act, new_low, low), np.where(act, new_d, d)
    return out[0], out[1], out[2], out[3]


def _records_pass(nl: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Pass 3: slots (B, S, 16) uint8; slot j < k is 0x80 | (bit 15 - j of nl) << 6 | (j == 0) << 5."""
    j = np.arange(ar.EVENT_SLOTS)
    slot = 0x80 | ((nl[..., None] >> (15 - j)) & 1) << 6 | np.where(j == 0, 0x20, 0)
    return np.where(j < k[..., None], slot, 0).astype(np.uint8)


def _plain(symbols, lengths):
    slots, slot0 = ar._encode_events_torch(torch.from_numpy(symbols), torch.from_numpy(lengths))
    return slots.numpy(), slot0.numpy()


def _tables(symbols, lengths):
    """The plain version's model, (lower, upper, total) (B, S) each, as numpy."""
    return [v.numpy() for v in ar._model_tables(torch.from_numpy(symbols), torch.from_numpy(lengths))]


def _check_model(symbols, lengths):
    """The three passes against the plain version's pieces; returns (slots, slot0)."""
    lower, upper, total = _tables(symbols, lengths)
    words = _model_pass(symbols, lengths)
    assert np.array_equal(words, lower | upper << 16)
    nl, k, m, slot0 = _chain_pass(words, lengths)
    S = symbols.shape[1]
    act = np.arange(S)[None] < np.minimum(lengths + 1, S)[:, None]
    assert np.array_equal(total[act], np.minimum(K["INIT_TOTAL"] + np.nonzero(act)[1], K["MAX_FREQ"]))
    k_p, m_p, nl_p = ar._coder_shifts(torch.stack([torch.from_numpy(v) for v in (lower, upper, total)])).numpy()
    assert np.array_equal(np.where(act, k_p, 0), k) and np.array_equal(np.where(act, m_p, 0), m)
    assert np.array_equal(np.where(act, nl_p, 0), nl)
    slots = _records_pass(nl, k)
    slots_p, slot0_p = _plain(symbols, lengths)
    assert np.array_equal(slots, slots_p) and np.array_equal(slot0, slot0_p)
    return slots, slot0


def _corpus(n: int, offset: int = 0) -> bytes:
    return bench.make_corpus(n + offset)[offset:]


def _kinds_batch():
    """B = 5: the corpus, random bytes, zeros, an empty block (EOF alone) and a pending run
    longer than 255 across chunks of 32 steps and pass 3's CTAs of 256; S not a multiple of
    32, random symbols past EOF."""
    rng = np.random.default_rng(31)
    run = _straddling(40, [0, 9, 255], prefix=_kind("text", 235))
    blocks = [_corpus(900), bytes(rng.integers(0, 256, 700, dtype=np.uint8)), bytes(600), b"", run]
    return blocks, *_symbols(blocks, S=909, past_eof=32)


def _freeze_batch():
    """B = 3 around the freeze at step UPDATE_STEPS (16,126, not a multiple of 32): past it at an
    odd offset, its EOF the last update, its EOF the first frozen step; S = 16,200."""
    u = K["UPDATE_STEPS"]
    data = _corpus(u + 37, offset=1000)
    blocks = [data, data[: u - 1], data[:u]]
    return blocks, *_symbols(blocks, S=16_200, past_eof=33)


# ---------------------------------------------------------------------------
# The model


def test_model_kinds_match_plain():
    _, symbols, lengths = _kinds_batch()
    slots, slot0 = _check_model(symbols, lengths)
    assert slot0[4].max() > 255  # the long run's carried count
    run_end = int(np.argmax(slot0[4]))
    assert run_end - 40 < 256 <= run_end  # the run crossed chunks of 32 steps and pass 3's first CTA
    assert not slots[3, 1:].any() and not slot0[:, 901:].any()


def test_model_freeze_matches_plain():
    _, symbols, lengths = _freeze_batch()
    assert K["UPDATE_STEPS"] % 32 != 0 and lengths.tolist() == [K["UPDATE_STEPS"] + 37, K["UPDATE_STEPS"] - 1, K["UPDATE_STEPS"]]
    _check_model(symbols, lengths)


def test_model_single_stream():
    """B = 1, as on the stream path: the corpus past the freeze, S = length + 1."""
    data = _corpus(K["UPDATE_STEPS"] + 1500)
    symbols, lengths = _symbols([data])
    _check_model(symbols, lengths)


def test_model_reads_kernel_constants():
    assert (K["MAX_CODE"], K["ONE_HALF"], K["ONE_FOURTH"], K["MAX_FREQ"], K["EOF_SYMBOL"], K["NUM_CUM"]) == (
        ar.MAX_CODE, ar.ONE_HALF, ar.ONE_FOURTH, ar.MAX_FREQ, ar.EOF, ar.NUM_CUM)
    assert K["INIT_TOTAL"] == ar.NUM_CUM - 1 and K["UPDATE_STEPS"] == ar.MAX_FREQ - (ar.NUM_CUM - 1)
    assert K["MODEL_WARPS"] * K["MODEL_TILE"] >= K["UPDATE_STEPS"] and K["MODEL_WARPS"] <= 32
    assert K["COUNT_STRIDE"] > K["EOF_SYMBOL"] and K["PAST_EOF"] == 1 << 16
    assert 32 % K["STEP_GROUP"] == 0  # a group never straddles a chunk's turn
    # the dividends d * cum < 2^16 * 2^14: div_by_total's range
    assert (K["MAX_CODE"] + 1) * K["MAX_FREQ"] < 1 << 30


# ---------------------------------------------------------------------------
# The JAX package: the Pallas kernel in interpret mode (B % 128 == 0, S % 128 == 0)
# and the XLA scan


@functools.cache
def _pallas_input():
    """128 blocks of S = 256: the kinds batch cut to fit, the six kinds, empties; garbage past EOF."""
    blocks = [b[:255] for b in _kinds_batch()[0]]
    blocks += [_kind(k, n) for k in KINDS for n in (255, 100, 7)]
    blocks += [_straddling(30, [0], prefix=b"ab" * 50)]
    blocks += [b""] * (128 - len(blocks))
    return _symbols(blocks, S=256, past_eof=34)


@functools.cache
def _pallas_events():
    symbols, lengths = _pallas_input()
    slots, slot0 = ap.encode_blocks_events(symbols, lengths, interpret=True)
    return np.asarray(slots), np.asarray(slot0)


def test_model_matches_pallas_interpret():
    slots, slot0 = _check_model(*_pallas_input())
    want_slots, want_slot0 = _pallas_events()
    assert np.array_equal(slots, want_slots) and np.array_equal(slot0, want_slot0)


# ---------------------------------------------------------------------------
# The kernel's own source on the host: arith_events.cu built with g++ over
# cuda_host/cuda_emu.h, held against the plain version and the JAX package.
# The model above checks the design; this checks the source.

HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {  // mode B S in out: symbols, lengths -> slots, slot0, words
    const bool model_only = argv[1][0] == 'm';  // pass 1 alone
    const int B = atoi(argv[2]), S = atoi(argv[3]);
    const size_t n = (size_t)B * S, guard = 64;  // elements after the outputs that no store may touch
    std::vector<int32_t> sym(n), len(B);
    std::vector<uint4> slots(n + guard, uint4{0xA5A5A5A5u, 0xA5A5A5A5u, 0xA5A5A5A5u, 0xA5A5A5A5u});
    std::vector<int32_t> slot0(n + guard, (int32_t)0xA5A5A5A5u);
    std::vector<uint32_t> words(n + guard, 0xA5A5A5A5u);
    FILE* f = fopen(argv[4], "rb");
    if (fread(sym.data(), 4, n, f) + fread(len.data(), 4, B, f) != n + B) return 1;
    fclose(f);
    int rc = 0;
    if (model_only) {
        emu_launch(arith_events_kernel_model, (unsigned)B, (unsigned)(MODEL_WARPS * 32), (const int32_t*)sym.data(),
                   (const int32_t*)len.data(), words.data(), S);
    } else {
        rc = rsn_arith_events(sym.data(), len.data(), slots.data(), slot0.data(), words.data(), B, S, nullptr);
    }
    f = fopen(argv[5], "wb");
    fwrite(slots.data(), 16, n, f);
    fwrite(slot0.data(), 4, n, f);
    fwrite(words.data(), 4, n, f);
    fclose(f);
    for (size_t i = n; i < n + guard; ++i)
        if (slots[i].x != 0xA5A5A5A5u || slots[i].w != 0xA5A5A5A5u || slot0[i] != (int32_t)0xA5A5A5A5u ||
            words[i] != 0xA5A5A5A5u)
            return 3;  // a store past the last row
    return rc;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """A function running kernel I's source, built for the CPU, on numpy symbols."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build kernel I's source for the host")
    tmp = tmp_path_factory.mktemp("arith_events_host")
    cu = (CSRC / "arith_events.cu").read_text()
    # name<<<grid, block, smem, stream>>>(args) -> emu_launch(name, grid, block, args)
    cu = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),[^>]*>>>\((\)?)",
                lambda m: f"emu_launch({m[1]}, {m[2]}, {m[3]}{')' if m[4] else ', '}", cu)
    src = tmp / "arith_events_host.cpp"
    src.write_text('#include "cuda_emu.h"\n' + cu + HOST_MAIN)
    exe = tmp / "arith_events_host"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(HOST), "-I", str(CSRC), "-o", str(exe),
                    str(src)], check=True, capture_output=True)

    def run(symbols: np.ndarray, lengths, model_only: bool = False):
        """(slots (B, S, 16) uint8, slot0 (B, S) int32, words (B, S) int64) after the call
        (after pass 1 alone with ``model_only``)."""
        B, S = symbols.shape
        inp, out = tmp / "in.bin", tmp / "out.bin"
        inp.write_bytes(np.ascontiguousarray(symbols, np.int32).tobytes() + np.asarray(lengths, np.int32).tobytes())
        subprocess.run([str(exe), "model" if model_only else "all", str(B), str(S), str(inp), str(out)], check=True)
        r = out.read_bytes()
        n = B * S
        slots = np.frombuffer(r[: 16 * n], np.uint8).reshape(B, S, 16)
        slot0 = np.frombuffer(r[16 * n : 20 * n], np.int32).reshape(B, S)
        words = np.frombuffer(r[20 * n :], np.uint32).reshape(B, S).astype(np.int64)
        return slots, slot0, words

    return run


def _check_host(host_kernel, symbols, lengths):
    """The source's pass 1 alone against _model_tables, then its records against the plain version."""
    lower, upper, _ = _tables(symbols, lengths)
    _, _, words = host_kernel(symbols, lengths, model_only=True)
    assert np.array_equal(words, lower | upper << 16)
    slots, slot0, _ = host_kernel(symbols, lengths)
    slots_p, slot0_p = _plain(symbols, lengths)
    assert np.array_equal(slots, slots_p) and np.array_equal(slot0, slot0_p)
    return slots, slot0


def test_kernel_source_on_host_kinds(host_kernel):
    _, symbols, lengths = _kinds_batch()
    _, slot0 = _check_host(host_kernel, symbols, lengths)
    assert slot0[4].max() > 255


def test_kernel_source_on_host_batch_of_three_around_the_freeze(host_kernel):
    _, symbols, lengths = _freeze_batch()
    slots, slot0 = _check_host(host_kernel, symbols, lengths)
    want_slots, want_slot0 = jax_scan._events_xla(jnp.asarray(symbols), jnp.asarray(lengths), symbols.shape[1])
    assert np.array_equal(slots, np.asarray(want_slots).astype(np.uint8))
    assert np.array_equal(slot0, np.asarray(want_slot0))


def test_kernel_source_on_host_single_stream(host_kernel):
    """B = 1, S = length + 1, past the freeze: the stream path's shape."""
    symbols, lengths = _symbols([_corpus(K["UPDATE_STEPS"] + 1500)])
    _check_host(host_kernel, symbols, lengths)


def test_kernel_source_on_host_matches_pallas_interpret(host_kernel):
    """The Pallas kernel's batch without its trailing empty blocks (each block is coded on its
    own; the emulation runs a CTA of pass 1 at ~0.1 s)."""
    symbols, lengths = _pallas_input()
    used = int(np.nonzero(lengths)[0].max()) + 2  # and one empty block
    assert used < 32
    slots, slot0, _ = host_kernel(symbols[:used], lengths[:used])
    want_slots, want_slot0 = _pallas_events()
    assert np.array_equal(slots, want_slots[:used]) and np.array_equal(slot0, want_slot0[:used])
    slots_p, slot0_p = _plain(symbols[:used], lengths[:used])
    assert np.array_equal(slots, slots_p) and np.array_equal(slot0, slot0_p)
