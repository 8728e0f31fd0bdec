"""The port's LZSS layers against the JAX package and the host oracle.

``raisin_tpu_torch.ops`` on CPU tensors runs the plain PyTorch versions of
kernels D (``lzss_match.find_matches``), E (``lzss_commit.commit_tokens``)
and F (``lzss_decode.walk_tokens``) and the escape layer
(``escape``). They are held against ``raisin_tpu.ops.lzss_jax`` (the XLA
scan on CPU JAX), ``lzss_commit_pallas`` and ``lzss_decode_pallas`` in
Pallas interpret mode, as tests/test_ops_pallas.py runs them, and against
``raisin_tpu.formats.lzss_ref``. Outputs are bytes and integers, so every
comparison is exact (tolerance 0). Inputs come from seeded numpy.

Kernel D's search (tiles, the 2-gram chain walk with its step budget, the
byte rule for L = 1, the sweep path started ``window`` positions above a
tile) runs only on the card, so ``_kernel_model`` mirrors it in Python and
numpy, with the kernel's constants read from its source, and is held
against the XLA scan and the oracle here.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raisin_tpu.formats import arithmetic_ref, lzss_ref
from raisin_tpu.ops import lzss_commit_pallas as cp
from raisin_tpu.ops import lzss_decode_pallas as dp
from raisin_tpu.ops import lzss_jax
from raisin_tpu_torch.ops import escape, lzss_commit, lzss_decode, lzss_match
from tests.fixtures import VERSE

torch.set_num_threads(1)

S_MATCH = 2048


def _kind(kind: str, n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return {
        "text": lambda: (VERSE * (n // len(VERSE) + 1))[int(rng.integers(0, 64)) :][:n],
        "random": lambda: bytes(rng.integers(0, 256, size=n, dtype=np.uint8)),
        "runs": lambda: b"".join(
            bytes([int(c)]) * int(r) for c, r in zip(rng.integers(0, 4, 200), rng.integers(1, 90, 200))
        )[:n],
        "escape_heavy": lambda: bytes(
            rng.choice(np.frombuffer(b"<\\\xff,>ab", np.uint8), size=n)
        ),
    }[kind]()


KINDS = ["text", "random", "runs", "escape_heavy"]
# escaped lengths stay within S_MATCH
BLOCKS = {k: _kind(k, 900, i) for i, k in enumerate(KINDS)}
BLOCKS["zeros"] = b"\x00" * 1500


def _matrix(encs: list[bytes], S: int, fill: int):
    x = np.full((len(encs), S), fill, dtype=np.int32)
    for i, e in enumerate(encs):
        x[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
    return x, np.array([len(e) for e in encs], dtype=np.int32)


@functools.cache
def _matches(window: int):
    """(names, escaped blocks, XLA (L, D), port (L, D)) at one window."""
    names = list(BLOCKS)
    encs = [lzss_ref.encode_opening_symbols(BLOCKS[k]) for k in names]
    x, lengths = _matrix(encs, S_MATCH, -1)
    Lj, Dj = lzss_jax.find_matches_blocks(x, lengths, window, S_MATCH // lzss_jax.TILE)
    xt = torch.from_numpy(np.where(x >= 0, x, 0).astype(np.uint8))
    Lt, Dt = lzss_match.find_matches(xt, torch.from_numpy(lengths), window)
    return names, encs, (np.asarray(Lj), np.asarray(Dj)), (Lt.numpy(), Dt.numpy())


@pytest.mark.parametrize("window", [16, 256, 4096])
@pytest.mark.parametrize("kind", [*KINDS, "zeros"])
def test_find_matches_plain_equals_xla_scan_and_oracle(kind, window):
    names, encs, (Lj, Dj), (Lt, Dt) = _matches(window)
    i = names.index(kind)
    e = encs[i]
    assert np.array_equal(Lt[i], Lj[i]) and np.array_equal(Dt[i], Dj[i])
    if kind != "zeros":  # the oracle's search is quadratic on long runs
        want = lzss_ref.find_matches(e, window)
        assert list(zip(Dt[i, : len(e)].tolist(), Lt[i, : len(e)].tolist())) == want
    assert not Lt[i, len(e) :].any() and not Dt[i, len(e) :].any()
    assert (Lt[i] <= np.maximum(Dt[i], 0)).all() and (Dt[i] <= window).all()


def _kernel_constants() -> dict[str, int]:
    """Kernel D's integer constants, read from its source (the model mirrors them)."""
    src = (Path(lzss_match.__file__).resolve().parent.parent / "csrc" / "lzss_match.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


KD = _kernel_constants()


def _hash2(a: int, b: int) -> int:
    return (((a | (b << 8)) * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - KD["HASH_BITS"])


def _model_run(x: bytes, i: int, j: int, lim: int) -> tuple[int, int]:
    """(run of positions i and j up to lim, words compared): four bytes a step, as the kernel."""
    run = words = 0
    while run < lim:
        words += 1
        a, b = x[i + run : i + run + 4], x[j + run : j + run + 4]
        k = next((t for t in range(len(a)) if a[t] != b[t]), len(a))
        run += k
        if k < 4:
            break
    return min(run, lim), words


def _model_chain_tile(x: bytes, window: int, p: int, pe: int, budget: int, d_lo: int = 0):
    """Kernel D's chain path on positions [p, pe) and distances (d_lo, window]:
    (L, D) lists, or None past the budget."""
    n = len(x)
    s0 = max(0, p - window)
    prev, head = {}, {}
    for j in range(s0, min(pe, n - 1)):  # positions with a 2-gram, linked in order
        h = _hash2(x[j], x[j + 1])
        prev[j] = head.get(h)
        head[h] = j
    Ls, Ds = [], []
    for i in range(p, pe):
        maxd, room = min(window, i), n - i
        best, best_d, steps = 1, 0, 0  # runs of 2 or more count here
        chain = []  # the candidates in the window, nearest first
        j = prev.get(i)
        while j is not None and i - j <= maxd:
            chain.append(j)
            j = prev[j]
        off, tie = 0, None
        for j in chain:
            steps += 1
            d = i - j
            if d <= d_lo:  # outside the range: passed over, a step all the same
                continue
            # from best = 4 on, a candidate whose bytes 2, 3 differ is passed over; then
            # bytes off .. best - 1 equal: a tie is possible; byte best too: a longer run is
            if (best < 4 or x[j + 2 : j + 4] == x[i + 2 : i + 4]) and (
                x[i + off : i + best] == x[j + off : j + best] and d >= best
            ):
                if d > best and room > best and x[i + best] == x[j + best]:
                    run, words = _model_run(x, i, j, min(d, room))
                    steps += words
                    if run > best:
                        best, best_d, tie, off = run, d, None, max(run - 3, 0)
                elif best >= 2:
                    tie = j  # checked at the end, the farthest only
            if steps > budget:
                return None
        if tie is not None:
            run, words = _model_run(x, i, tie, min(i - tie, room))
            steps += words
            if run >= best:
                best_d = i - tie
            else:  # not a tie: walk again, measuring every possible tie past best_d
                for j in chain:
                    if steps > budget:
                        break
                    steps += 1
                    d = i - j
                    if (d > best_d and d >= best and (best < 4 or x[j + 2 : j + 4] == x[i + 2 : i + 4])
                            and x[i + off : i + best] == x[j + off : j + best]):
                        run, words = _model_run(x, i, j, min(d, room))
                        steps += words
                        if run >= best:
                            best_d = d
        if steps > budget:
            return None
        if best < 2:  # no 2-gram match: the earliest occurrence of the byte in the range
            k = x.find(x[i : i + 1], i - maxd, i - d_lo) if maxd > d_lo else -1
            best, best_d = (1, i - k) if k >= 0 else (0, 0)
        Ls.append(best)
        Ds.append(best_d)
    return Ls, Ds


def _model_sweep_tile(x: bytes, window: int, p: int, pe: int, tile: int, d_lo: int = 0):
    """Kernel D's sweep path: the capped-run recurrence over the distances
    (d_lo, window], walked down from min(n, p + tile + window), keys kept for [p, pe)."""
    a = np.frombuffer(x, np.uint8).astype(np.int64)
    s0 = max(0, p - window)
    e = min(len(x), p + tile + window)
    maxd = min(window, pe - 1)
    Ls, Ds = np.zeros(pe - p, np.int64), np.zeros(pe - p, np.int64)
    if maxd <= d_lo:
        return Ls, Ds
    d = np.arange(d_lo + 1, maxd + 1)
    c = np.zeros(maxd - d_lo, np.int64)
    for i in range(e - 1, p - 1, -1):
        j = i - d
        eq = (j >= s0) & (a[np.maximum(j, 0)] == a[i])
        c = np.where(eq, np.minimum(c + 1, d), 0)
        if i < pe:
            key = np.where(c > 0, (c << 16) | d, 0).max()
            Ls[i - p], Ds[i - p] = key >> 16, key & 0xFFFF
    return Ls, Ds


def _kernel_model(x: bytes, window: int, tile: int, budget: int = KD["BUDGET"], d_lo: int = 0):
    """A CPU model of kernel D on one escaped block at a window <= CHAIN_MAX_WINDOW:
    tiles of ``tile`` positions, each on the chain path unless a position
    passes ``budget`` steps, then on the sweep path. With ``d_lo``, the
    distances (d_lo, window] only (the kernel's d_lo, d_hi = window).
    Returns (L, D, tiles by path)."""
    assert window <= KD["CHAIN_MAX_WINDOW"]
    n = len(x)
    L, D = np.zeros(n, np.int64), np.zeros(n, np.int64)
    paths = {"chain": 0, "sweep": 0}
    for p in range(0, n, tile):
        pe = min(p + tile, n)
        got = _model_chain_tile(x, window, p, pe, budget, d_lo)
        paths["chain" if got else "sweep"] += 1
        L[p:pe], D[p:pe] = got or _model_sweep_tile(x, window, p, pe, tile, d_lo)
    return L, D, paths


@pytest.mark.parametrize("tile", [64, 4096])  # shorter than most windows, and as long as the largest
@pytest.mark.parametrize("window", [16, 256, 4096])
@pytest.mark.parametrize("kind", [*KINDS, "zeros"])
def test_kernel_model_equals_the_xla_scan_and_oracle(kind, window, tile):
    names, encs, (Lj, Dj), _ = _matches(window)
    i = names.index(kind)
    e = encs[i]
    L, D, paths = _kernel_model(e, window, tile)
    assert np.array_equal(L, Lj[i, : len(e)]) and np.array_equal(D, Dj[i, : len(e)])
    if kind != "zeros":  # the oracle's search is quadratic on long runs
        assert list(zip(D.tolist(), L.tolist())) == lzss_ref.find_matches(e, window)
    assert sum(paths.values()) == -(-len(e) // tile)


# which paths a block's tiles take at a budget of 48 steps (window 256, tiles of 64)
SMALL_BUDGET_PATHS = {"text": {"chain", "sweep"}, "random": {"chain"}, "runs": {"sweep"},
                      "escape_heavy": {"chain", "sweep"}, "zeros": {"sweep"}}


@pytest.mark.parametrize("kind", [*KINDS, "zeros"])
def test_kernel_model_takes_both_paths(kind):
    window, tile = 256, 64
    names, encs, (Lj, Dj), _ = _matches(window)
    i = names.index(kind)
    e = encs[i]
    L, D, paths = _kernel_model(e, window, tile, budget=48)
    assert np.array_equal(L, Lj[i, : len(e)]) and np.array_equal(D, Dj[i, : len(e)])
    assert {path for path, count in paths.items() if count} == SMALL_BUDGET_PATHS[kind]


@pytest.mark.parametrize("window", [1, 2, 16])
def test_kernel_model_on_blocks_of_length_0_to_3(window):
    blocks = [b"", b"a", b"aa", b"ab", b"aaa", b"aba", b"abb"]
    x, lengths = _matrix(blocks, 4, 0)
    Lp, Dp = lzss_match.find_matches(torch.from_numpy(x.astype(np.uint8)), torch.from_numpy(lengths), window)
    for k, b in enumerate(blocks):
        L, D, paths = _kernel_model(b, window, 2)
        assert L.tolist() == Lp[k, : len(b)].tolist() and D.tolist() == Dp[k, : len(b)].tolist(), b
        assert list(zip(D.tolist(), L.tolist())) == lzss_ref.find_matches(b, window), b
        assert paths == {"chain": -(-len(b) // 2), "sweep": 0}


@functools.cache
def _range_scan(window: int, d_lo: int, d_hi: int):
    """The XLA scan's (L, D) over the distances (d_lo, d_hi] on every block of BLOCKS."""
    names = list(BLOCKS)
    encs = [lzss_ref.encode_opening_symbols(BLOCKS[k]) for k in names]
    x, lengths = _matrix(encs, S_MATCH, -1)
    out = [lzss_jax._match_scan(jnp.asarray(x[i]), int(lengths[i]), window, d_hi - d_lo, jnp.int32(d_lo))
           for i in range(len(names))]
    return names, encs, [(np.asarray(L), np.asarray(D)) for L, D, _ in out]


@pytest.mark.parametrize("budget", [KD["BUDGET"], 48])  # the kernel's, and one that sends tiles to the sweep
@pytest.mark.parametrize("window, d_lo, d_hi", [(16, 8, 16), (256, 0, 128), (256, 128, 256), (256, 3, 251)])
def test_kernel_model_on_a_distance_range_equals_the_xla_scan(window, d_lo, d_hi, budget):
    """Kernel D over (d_lo, d_hi] (the sharded step's search) as the model runs it, tiles of 64."""
    names, encs, want = _range_scan(window, d_lo, d_hi)
    paths = {"chain": 0, "sweep": 0}
    for i, e in enumerate(encs):
        L, D, got = _kernel_model(e, d_hi, 64, budget, d_lo)
        Lj, Dj = want[i]
        assert np.array_equal(L, Lj[: len(e)]) and np.array_equal(D, Dj[: len(e)]), names[i]
        assert (D[L > 0] > d_lo).all() and (D <= d_hi).all()
        paths = {k: paths[k] + got[k] for k in paths}
    assert paths["chain"]
    if budget < KD["BUDGET"] and d_hi - d_lo >= 128:  # the zeros pass 48 steps in a range this wide
        assert paths["sweep"]


def test_kernel_model_takes_the_chain_path_on_the_corpus():
    import bench

    data = bench.make_corpus(16384)
    L, D, paths = _kernel_model(data, 4096, 4096)
    assert paths == {"chain": 4, "sweep": 0}
    assert list(zip(D.tolist(), L.tolist())) == lzss_ref.find_matches(data, 4096)


def test_commit_plain_equals_pallas_interpret_and_oracle():
    S = 2048
    names, encs, (Lj, Dj), _ = _matches(4096)
    x, lengths = _matrix(encs, S, -1)
    tok_j, tl_j = cp.commit_emit_blocks(
        jnp.asarray(x), jnp.asarray(Lj), jnp.asarray(Dj), jnp.asarray(lengths), interpret=True
    )
    tok_j, tl_j = np.asarray(tok_j), np.asarray(tl_j)
    xt = torch.from_numpy(np.where(x >= 0, x, 0).astype(np.uint8))
    tok_t, tl_t = lzss_commit.commit_tokens(
        xt, torch.from_numpy(Lj.copy()), torch.from_numpy(Dj.copy()), torch.from_numpy(lengths)
    )
    tok_t, tl_t = tok_t.numpy(), tl_t.numpy()
    assert np.array_equal(tl_t, tl_j)
    for i, name in enumerate(names):
        got = tok_t[i, : tl_t[i]].tobytes()
        assert got == tok_j[i, : tl_j[i]].astype(np.uint8).tobytes(), name
        assert got == lzss_ref.compress(BLOCKS[name], 4096), name
        assert not tok_t[i, tl_t[i] :].any()


def test_commit_five_digit_tokens_equal_the_oracle():
    # zeros at window 16384 commit <16384,3616> at position 16384
    block = b"\x00" * 20000
    x = torch.from_numpy(np.frombuffer(block, np.uint8).copy())[None]
    n = torch.tensor([len(block)], dtype=torch.int32)
    L, D = lzss_match.find_matches(x, n, 16384)
    tok, tl = lzss_commit.commit_tokens(x, L, D, n)
    got = tok[0, : tl[0]].numpy().tobytes()
    assert b"<16384,3616>" in got
    assert got == lzss_ref.compress(block, 16384)


DECODE_BLOCKS = [
    b"hello world, hello world, hello world!",
    b"a" * 900,
    (b"ab" * 300)[:577],
    _kind("escape_heavy", 700, 9),
    VERSE * 3,
    b"x",
    b"",
    _kind("random", 600, 10),
]


def test_walk_plain_equals_pallas_interpret_and_oracle():
    encs = [lzss_ref.encode_opening_symbols(p) for p in DECODE_BLOCKS]
    toks = [lzss_ref.commit_tokens(e, lzss_ref.find_matches(e, 4096)) for e in encs]
    tok, tlens = _matrix(toks, 2048, 0)
    rows_j, olen_j = dp.lzss_decode_blocks(jnp.asarray(tok), jnp.asarray(tlens), cap_out=8192, interpret=True)
    rows_j, olen_j = np.asarray(rows_j), np.asarray(olen_j)
    rows_t, olen_t, err = lzss_decode.walk_tokens(
        torch.from_numpy(tok.astype(np.uint8)), torch.from_numpy(tlens), 8192
    )
    rows_t, olen_t = rows_t.numpy(), olen_t.numpy()
    assert not err.any()
    assert np.array_equal(olen_t, olen_j)
    for i, e in enumerate(encs):
        got = rows_t[i, : olen_t[i]].tobytes()
        assert got == rows_j[i].tobytes()[: olen_j[i]] == e, i
        assert lzss_ref.decode_opening_symbols(got) == lzss_ref.decompress(toks[i]) == DECODE_BLOCKS[i]
        assert not rows_t[i, olen_t[i] :].any()


def _raw_oracle(stream: bytes):
    """lzss_ref.decompress before its escape pass: (escaped output, 0) or (None, 1)."""
    try:
        out = lzss_ref.decompress(stream)
    except ValueError:
        return None, lzss_decode.ERR_REFERENCE
    return lzss_ref.encode_opening_symbols(out), 0


# streams no encoder writes, held against the oracle's state machine
ODD_STREAMS = [
    b"ab<3,2>cd",  # a reference before the output
    b"abcd<2,3>",  # L > D
    b"x<,>y",  # empty numbers count as 0
    b"xy<1,1",  # the stream ends inside a token
    b"xy<1",
    b"q<a,1>z",  # a number that is not all digits counts as 0
    b"qq<1,b>z",
    b"qqq<2,2>,>,<<1,1>",  # ',' and '>' outside a token are literals
    b"abc<0003,0002>",  # leading zeros
    b"abc<99999999999999999,0>",  # saturates, then lies outside the output
    b"ab,>c",
]


@pytest.mark.parametrize("stream", ODD_STREAMS)
def test_walk_follows_the_reference_state_machine(stream):
    want, want_err = _raw_oracle(stream)
    tok = torch.from_numpy(np.frombuffer(stream, np.uint8).copy())[None]
    rows, olen, err = lzss_decode.walk_tokens(tok, torch.tensor([len(stream)], dtype=torch.int32), 64)
    assert int(err[0]) == want_err
    if want_err:
        assert int(olen[0]) == 0 and not rows.any()
        with pytest.raises(ValueError, match="reference outside decoded window"):
            lzss_decode.decode_tokens(tok, torch.tensor([len(stream)], dtype=torch.int32), 64)
    else:
        assert rows[0, : olen[0]].numpy().tobytes() == want


def test_walk_flags_output_past_its_capacity():
    tok = torch.from_numpy(np.frombuffer(b"abcdefgh<8,8>", np.uint8).copy())[None]
    lens = torch.tensor([13], dtype=torch.int32)
    assert lzss_decode.walk_tokens(tok, lens, 16)[1].tolist() == [16]
    for cap in (15, 7):
        rows, olen, err = lzss_decode.walk_tokens(tok, lens, cap)
        assert err.tolist() == [lzss_decode.ERR_CAPACITY] and olen.tolist() == [0]
    with pytest.raises(ValueError, match="past its capacity"):
        lzss_decode.decode_tokens(tok, lens, 15)


ESCAPE_INPUTS = {
    "dense": lambda rng: bytes(rng.choice(np.frombuffer(b"<\\\xff", np.uint8), size=700)),
    "odd_runs": lambda rng: b"\\\\\\\xff\\\\<\\\xff\xff\\" * 40,
    "random": lambda rng: bytes(rng.integers(0, 256, size=900, dtype=np.uint8)),
    "clean": lambda rng: b"<<a<b>>" * 50,
    "empty": lambda rng: b"",
}


@pytest.mark.parametrize("name", list(ESCAPE_INPUTS))
def test_escape_layer_equals_the_oracle(name):
    rng = np.random.default_rng(len(name))
    blocks = [ESCAPE_INPUTS[name](rng), b"\\", b"plain", b""]
    x, lengths = _matrix(blocks, max(1, max(map(len, blocks))), 0)
    xe, elen = escape.escape_blocks(torch.from_numpy(x.astype(np.uint8)), torch.from_numpy(lengths))
    encs = [lzss_ref.encode_opening_symbols(b) for b in blocks]
    assert elen.tolist() == [len(e) for e in encs]
    assert xe.shape[1] == max(x.shape[1], max(map(len, encs)))
    for i, e in enumerate(encs):
        assert xe[i, : len(e)].numpy().tobytes() == e
        assert not xe[i, len(e) :].any()
    flat, dec_lens = escape.unescape_rows(xe, elen)
    assert flat.numpy().tobytes() == b"".join(lzss_ref.decode_opening_symbols_np(e) for e in encs)
    assert flat.numpy().tobytes() == b"".join(blocks)
    assert dec_lens.tolist() == [len(b) for b in blocks]


def test_unescape_takes_any_stream_like_the_oracle():
    # not every escaped stream comes from the encoder: a trailing odd 0x5C run
    rng = np.random.default_rng(12)
    rows = [bytes(rng.choice(np.frombuffer(b"\\\xffa", np.uint8), size=n)) for n in (1, 5, 64, 333)]
    m, lengths = _matrix(rows, 400, 0)
    flat, dec_lens = escape.unescape_rows(torch.from_numpy(m.astype(np.uint8)), torch.from_numpy(lengths))
    want = [lzss_ref.decode_opening_symbols_np(r) for r in rows]
    assert flat.numpy().tobytes() == b"".join(want)
    assert dec_lens.tolist() == [len(w) for w in want]


def test_cpu_wrappers_launch_no_kernel():
    for fn in (lzss_match.find_matches, lzss_commit.commit_tokens, lzss_decode.walk_tokens):
        fn.launches = 0
    x = torch.from_numpy(np.frombuffer(b"abcabcabcabc", np.uint8).copy())[None]
    n = torch.tensor([12], dtype=torch.int32)
    L, D = lzss_match.find_matches(x, n, 16)
    tok, tl = lzss_commit.commit_tokens(x, L, D, n)
    rows, olen = lzss_decode.decode_tokens(tok, tl, 32)
    assert rows[0, : olen[0]].numpy().tobytes() == b"abcabcabcabc"
    assert [f.launches for f in (lzss_match.find_matches, lzss_commit.commit_tokens, lzss_decode.walk_tokens)] == [0] * 3
    assert lzss_match.find_matches.chain_tiles == lzss_match.find_matches.sweep_tiles == 0


@pytest.mark.parametrize("window", [0, 65536])
def test_find_matches_rejects_windows_outside_the_card_range(window):
    x = torch.zeros((1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 16"):
        lzss_match.find_matches(x, torch.tensor([8], dtype=torch.int32), window)


def test_chip_smoke_lzss_oracle_blocks_are_the_oracles():
    import bench
    import chip_smoke

    data = bench.make_corpus(chip_smoke.MAIN_BYTES)
    bs = chip_smoke.BLOCK_SIZE
    payloads = [b""] * (len(data) // bs)
    tok_lens = [0] * len(payloads)
    for i in chip_smoke.ORACLE_BLOCKS_LZSS:
        tokens = lzss_ref.compress(data[i * bs : (i + 1) * bs], chip_smoke.WINDOW)
        payloads[i] = arithmetic_ref.compress(tokens)
        tok_lens[i] = len(tokens)
    chip_smoke.check_oracle_blocks_lzss(data, payloads, tok_lens)


def test_chip_smoke_match_inputs_have_the_main_paths_shapes():
    import bench
    import chip_smoke

    data = bench.make_corpus(chip_smoke.STREAM_BYTES)
    blocks = {name: chip_smoke.match_blocks(name, data) for name in ("stream", "zeros", "random")}
    assert blocks["stream"] == [data]
    per = chip_smoke.MAIN_BYTES // chip_smoke.BLOCK_SIZE
    for name in ("zeros", "random"):
        assert len(blocks[name]) == per and {len(b) for b in blocks[name]} == {chip_smoke.BLOCK_SIZE}
    assert not any(any(b) for b in blocks["zeros"])
    assert len(set(b"".join(blocks["random"][:4]))) == 256
