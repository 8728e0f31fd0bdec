"""Arithmetic coder rows: the port of raisin_tpu/ops/arithmetic_pallas.py.

Public functions keep the JAX package's (B, S) layout:

- :func:`encode_rows` (JAX ``encode_rows``): symbols (B, S) int32 with EOF
  (256) at ``lengths[b]`` -> ``(rows, byte_lens, oflow)``, where ``rows`` is
  uint8 (B, 4 * capw) holding each block's `.rsn` bytes. It is kernel A
  (:func:`encode_bits`, csrc/arith_encode.cu) followed by kernel B
  (:func:`prepad_rows`, csrc/arith_prepad.cu).
- :func:`decode_rows` (JAX ``decode_rows``): `.rsn` payload rows -> decoded
  symbols (B, num_steps) uint8 and ``eof_ok`` (B,) int32; kernel C
  (csrc/arith_decode.cu).
- :func:`encode_events` (JAX ``encode_blocks_events``): the same coder,
  writing the per-step event record that ops/arithmetic_scan.py expands
  into a single `.rsn` stream; kernel I (csrc/arith_events.cu).

Each kernel wrapper dispatches on the device of the tensor it is given: a
CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
PyTorch version beside it (``_encode_bits_torch``, ``_prepad_torch``,
``_decode_rows_torch``, ``_encode_events_torch``). Each wrapper counts its
kernel launches in ``<wrapper>.launches``.

The plain versions work on int64 tensors, vectorised over blocks and looping
over steps. Where the kernels loop over renormalisation shifts, the plain
versions compute the shifts in closed form: after an interval update the
shifts are first ``k`` E1/E2 shifts, one per leading bit that ``low`` and
``high`` share, then ``m`` E3 shifts, one per following bit where ``low``
has 1 and ``high`` 0 (an E3 shift leaves the interval straddling the half,
so E1/E2 cannot follow it). The two formulations check each other.
"""

from __future__ import annotations

import functools

import torch

from raisin_tpu_torch.ops import _build

MAX_CODE = 0xFFFF
ONE_FOURTH = 0x4000
ONE_HALF = 0x8000
MAX_FREQ = 16383
EOF = 256
NUM_CUM = 258
# A shift emits at most one bit and a step makes at most 16 shifts, so a
# block coded in S steps emits at most 16 * S bits; the prepad adds <= 8.
BITS_PER_STEP = 16
PREPAD_MAX = 8
EVENT_SLOTS = 16  # one event slot per renormalisation shift of a step


def capw_bound(steps: int) -> int:
    """Row words that always hold the `.rsn` stream of ``steps`` coder steps."""
    return (BITS_PER_STEP * steps + PREPAD_MAX + 31) // 32


@functools.cache
def _bitlen_table(device: torch.device) -> torch.Tensor:
    """bit_length(x) for x in [0, 65536), int64."""
    x = torch.arange(1 << 16, dtype=torch.int64, device=device)
    return sum(((x >> i) > 0).to(torch.int64) for i in range(16))


def _renorm_shifts(nl: torch.Tensor, nh: torch.Tensor, bitlen: torch.Tensor):
    """E1/E2 count k, E3 count m and the renormalised (low, high)."""
    k = 16 - bitlen[nl ^ nh]
    lk = (nl << k) & MAX_CODE
    hk = ((nh << k) | ((1 << k) - 1)) & MAX_CODE
    z = lk & ~hk & 0x7FFF
    m = 15 - bitlen[~z & 0x7FFF]
    keep = (1 << (15 - m)) - 1
    low = (lk & keep) << m
    high = ONE_HALF | ((hk & keep) << m) | ((1 << m) - 1)
    return k, m, low, high


def _model_step(cum, frozen, sym, upd, idx):
    """(lower, upper, total) for ``sym``, then the model update where ``upd``."""
    lower = cum.gather(1, sym[:, None])[:, 0]
    upper = cum.gather(1, sym[:, None] + 1)[:, 0]
    total = cum[:, NUM_CUM - 1].clone()
    upd = upd & ~frozen
    cum += ((idx[None, :] > sym[:, None]) & upd[:, None]).to(torch.int64)
    frozen |= cum[:, NUM_CUM - 1] >= MAX_FREQ
    return lower, upper, total


def _words_to_int32(w: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> the same bits as int32."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


# ---------------------------------------------------------------------------
# Encode


def _encode_bits_torch(symbols: torch.Tensor, lengths: torch.Tensor, capw: int):
    """Plain version of kernel A: (raw (B, capw) int32, bits (B,), oflow (B,)).

    ``raw`` holds each block's MSB-first bit stream (bit 31 of word 0 first),
    zero past ``bits``; ``oflow`` flags streams whose prepadded form would
    not fit ``capw`` words (their rows hold the first 32 * capw bits).
    """
    dev = symbols.device
    B, S = symbols.shape
    sym_all = symbols.to(torch.int64)
    n = lengths.to(torch.int64)
    bitlen = _bitlen_table(dev)
    idx = torch.arange(NUM_CUM, dtype=torch.int64, device=dev)
    cum = idx.repeat(B, 1)
    frozen = torch.zeros(B, dtype=torch.bool, device=dev)
    low = torch.zeros(B, dtype=torch.int64, device=dev)
    high = torch.full((B,), MAX_CODE, dtype=torch.int64, device=dev)
    pending = torch.zeros_like(low)
    pos = torch.zeros_like(low)  # bits emitted so far
    cap = BITS_PER_STEP * S + 48
    # bits written one by one, and the runs of 1s that released pending
    # bits make (a difference array: +1 at the run's start, -1 past its end)
    bitm = torch.zeros((B, cap), dtype=torch.uint8, device=dev)
    runs = torch.zeros((B, cap + 1), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    j15 = torch.arange(15, dtype=torch.int64, device=dev)

    for t in range(S):
        active = t <= n
        s = sym_all[:, t]
        lower, upper, total = _model_step(cum, frozen, s, active, idx)
        diff = high - low + 1
        nh = torch.where(active, low + diff * upper // total - 1, high)
        nl = torch.where(active, low + diff * lower // total, low)
        k, m, low, high = _renorm_shifts(nl, nh, bitlen)

        # emitted: the first shared bit, the pending bits (its complement),
        # then the other k - 1 shared bits
        emit = k > 0
        pattern = nl >> (16 - k)
        rest_w = (k - 1).clamp(min=0)
        b0 = (pattern >> rest_w) & 1
        c = torch.where(emit, pending, 0)
        bitm[rows, pos] = torch.where(emit, b0, 0).to(torch.uint8)
        run = (emit & (b0 == 0) & (c > 0)).to(torch.int32)
        runs.index_put_((rows, pos + 1), run, accumulate=True)
        runs.index_put_((rows, pos + 1 + c), -run, accumulate=True)
        # slots past the k - 1 rest bits get 0: they lie past the new end
        rb = (pattern[:, None] >> (rest_w[:, None] - 1 - j15).clamp(min=0)) & 1
        rb = torch.where(j15[None, :] < rest_w[:, None], rb, 0)
        bitm.scatter_(1, pos[:, None] + 1 + c[:, None] + j15[None, :], rb.to(torch.uint8))
        pos = pos + torch.where(emit, k + c, 0)
        pending = torch.where(emit, m, pending + m)

    bits = bitm | (runs.cumsum(1, dtype=torch.int32)[:, :cap] > 0).to(torch.uint8)
    del bitm, runs
    nbits = 32 * capw
    if cap < nbits:
        bits = torch.nn.functional.pad(bits, (0, nbits - cap))
    # MSB-first bytes, then big-endian words
    w8 = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=dev)
    by = (bits[:, :nbits].reshape(B, capw, 4, 8).to(torch.int32) * w8).sum(-1).to(torch.int64)
    words = (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]
    oflow = (pos + PREPAD_MAX > nbits).to(torch.int32)
    return _words_to_int32(words), pos.to(torch.int32), oflow


def encode_bits(symbols: torch.Tensor, lengths: torch.Tensor, capw: int):
    """Kernel A (csrc/arith_encode.cu) or, for CPU tensors, its plain version.

    symbols (B, S) int32 in [0, 256], EOF at ``lengths[b]``; lengths (B,)
    int32. Returns (raw (B, capw) int32, bits (B,) int32, oflow (B,) int32).
    """
    if symbols.device.type == "cpu":
        return _encode_bits_torch(symbols, lengths, capw)
    B, S = _check_cuda("encode_bits", symbols, torch.int32, 2)
    _check_cuda("encode_bits", lengths, torch.int32, 1, (B,), symbols.device)
    dev = symbols.device
    raw = torch.zeros((B, capw), dtype=torch.int32, device=dev)
    bits = torch.empty(B, dtype=torch.int32, device=dev)
    oflow = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return raw, bits, oflow
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.count(encode_bits)
        rc = lib.rsn_arith_encode(
            symbols.data_ptr(), lengths.data_ptr(), raw.data_ptr(), bits.data_ptr(),
            oflow.data_ptr(), B, S, capw, _build.stream_handle(dev),
        )
    _build.check("rsn_arith_encode", rc)
    return raw, bits, oflow


encode_bits.launches = 0


def _prepad_torch(raw: torch.Tensor, bits: torch.Tensor):
    """Plain version of kernel B: (rows (B, 4 * capw) uint8, byte_lens (B,))."""
    B, capw = raw.shape
    dev = raw.device
    T = bits.to(torch.int64)
    u = raw.to(torch.int64) & 0xFFFFFFFF
    keep = (T[:, None] - 32 * torch.arange(capw, dtype=torch.int64, device=dev)).clamp(0, 32)
    mask = (((1 << keep) - 1) << (32 - keep)) & 0xFFFFFFFF
    cur = u & mask
    prev = torch.cat([torch.ones((B, 1), dtype=torch.int64, device=dev), cur[:, :-1]], dim=1)
    pad = (8 - T % 8)[:, None]
    v = ((prev << (32 - pad)) | (cur >> pad)) & 0xFFFFFFFF
    be = torch.stack([(v >> sh) & 0xFF for sh in (24, 16, 8, 0)], dim=-1)
    byte_lens = (T + pad[:, 0]) // 8
    return be.reshape(B, 4 * capw).to(torch.uint8), byte_lens.to(torch.int32)


def prepad_rows(raw: torch.Tensor, bits: torch.Tensor):
    """Kernel B (csrc/arith_prepad.cu) or, for CPU tensors, its plain version."""
    if raw.device.type == "cpu":
        return _prepad_torch(raw, bits)
    B, capw = _check_cuda("prepad_rows", raw, torch.int32, 2)
    _check_cuda("prepad_rows", bits, torch.int32, 1, (B,), raw.device)
    dev = raw.device
    rows = torch.empty((B, 4 * capw), dtype=torch.uint8, device=dev)
    byte_lens = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0 or capw == 0:
        return rows, byte_lens
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.count(prepad_rows)
        rc = lib.rsn_arith_prepad(
            raw.data_ptr(), bits.data_ptr(), rows.data_ptr(), byte_lens.data_ptr(),
            B, capw, _build.stream_handle(dev),
        )
    _build.check("rsn_arith_prepad", rc)
    return rows, byte_lens


prepad_rows.launches = 0


def encode_rows(symbols: torch.Tensor, lengths: torch.Tensor, capw: int | None = None):
    """Adaptive arithmetic encode of B blocks into `.rsn` byte rows.

    Args:
      symbols: (B, S) int32 in [0, 256], EOF (256) at position ``lengths[b]``.
      lengths: (B,) int32 payload lengths (< S).
      capw: row capacity in 32-bit words; default :func:`capw_bound` (S),
        which always fits, so ``oflow`` stays 0.

    Returns:
      rows: (B, 4 * capw) uint8, each row's first ``byte_lens[b]`` bytes are
        the block's `.rsn` stream.
      byte_lens: (B,) int32.
      oflow: (B,) int32, 1 where the stream did not fit ``capw`` words.
    """
    B, S = symbols.shape
    if capw is None:
        capw = capw_bound(S)
    if symbols.numel():
        lo, hi = torch.aminmax(symbols)
        if int(lo) < 0 or int(hi) > EOF:
            raise ValueError("encode_rows: symbols must lie in [0, 256]")
    raw, bits, oflow = encode_bits(symbols, lengths, capw)
    rows, byte_lens = prepad_rows(raw, bits)
    return rows, byte_lens, oflow


# ---------------------------------------------------------------------------
# Decode


def _decode_rows_torch(
    payload_rows: torch.Tensor, byte_lens: torch.Tensor, out_lens: torch.Tensor, num_steps: int
):
    """Plain version of kernel C: (syms (B, num_steps) uint8, eof_ok (B,) int32)."""
    dev = payload_rows.device
    B, capb = payload_rows.shape
    lens = byte_lens.to(torch.int64).clamp(0, capb)
    n = out_lens.to(torch.int64)
    # the byte stream the decoder reads: payload, the tail byte 0x80 (bits
    # [1, 0, ...]) right after it, zeros past that; wide enough for the
    # prepad, 16 bits of value and 16 shifts per step
    nbytes = capb + 1 + (8 + 16 + BITS_PER_STEP * num_steps + 16) // 8 + 1
    j = torch.arange(nbytes, dtype=torch.int64, device=dev)
    data = torch.zeros((B, nbytes), dtype=torch.uint8, device=dev)
    data[:, :capb] = payload_rows
    tail = torch.where(j[None] == lens[:, None], 0x80, 0).to(torch.uint8)
    stream = torch.where(j[None] < lens[:, None], data, tail)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    bits = ((stream[:, :, None] >> shifts) & 1).reshape(B, nbytes * 8)
    w16 = torch.arange(16, dtype=torch.int64, device=dev)
    weights = torch.ones(16, dtype=torch.int64, device=dev) << (15 - w16)

    def window(p):
        return (bits.gather(1, p[:, None] + w16[None]).to(torch.int64) * weights).sum(1)

    first = bits[:, :8].to(torch.int64)  # the prepad: up to 8 zeros, then the sentinel 1
    pos = torch.where(first.bool().any(1), first.argmax(1) + 1, 8)
    value = window(pos)
    pos = pos + 16

    bitlen = _bitlen_table(dev)
    idx = torch.arange(NUM_CUM, dtype=torch.int64, device=dev)
    cum = idx.repeat(B, 1)
    frozen = torch.zeros(B, dtype=torch.bool, device=dev)
    low = torch.zeros(B, dtype=torch.int64, device=dev)
    high = torch.full((B,), MAX_CODE, dtype=torch.int64, device=dev)
    eof = torch.zeros(B, dtype=torch.int32, device=dev)
    out = torch.zeros((B, num_steps), dtype=torch.uint8, device=dev)

    for t in range(num_steps):
        active = t <= n
        diff = high - low + 1
        scaled = ((value - low + 1) * cum[:, NUM_CUM - 1] - 1) // diff
        sym = (cum[:, 1:] <= scaled[:, None]).sum(1).clamp(max=EOF)
        lower, upper, total = _model_step(cum, frozen, sym, active, idx)
        is_eof = sym == EOF
        eof = torch.where(active & (n == t), is_eof.to(torch.int32), eof)
        act = active & ~is_eof
        nh = torch.where(act, low + diff * upper // total - 1, high)
        nl = torch.where(act, low + diff * lower // total, low)
        k, m, nlow, nhigh = _renorm_shifts(nl, nh, bitlen)
        # each E1/E2 shift subtracts low's top bit (HALF) from value, each
        # E3 shift subtracts ONE_FOURTH; the next k + m stream bits shift in
        win = window(pos)
        b1 = win >> (16 - k)
        b2 = (win >> (16 - k - m)) & ((1 << m) - 1)
        top = MAX_CODE ^ ((1 << (16 - k)) - 1)
        v = ((value - (nl & top)) << k) + b1
        v = (v << m) - ONE_FOURTH * ((2 << m) - 2) + b2
        value = torch.where(act, v, value)
        low = torch.where(act, nlow, low)
        high = torch.where(act, nhigh, high)
        pos = pos + torch.where(act, k + m, 0)
        out[:, t] = torch.where(act, sym, 0).to(torch.uint8)
    return out, eof


def decode_rows(
    payload_rows: torch.Tensor, byte_lens: torch.Tensor, out_lens: torch.Tensor, num_steps: int
):
    """Adaptive arithmetic decode of B `.rsn` payload rows (kernel C).

    Args:
      payload_rows: (B, capb) uint8; row b's first ``byte_lens[b]`` bytes are
        the block's `.rsn` stream.
      byte_lens: (B,) int32.
      out_lens: (B,) int32 known decoded lengths.
      num_steps: decode steps (> max(out_lens) for every EOF to be checked).

    Returns (syms (B, num_steps) uint8, eof_ok (B,) int32): ``syms[b, :n]``
    are the decoded bytes and ``eof_ok[b]`` is 1 when step n decoded EOF.
    """
    if payload_rows.device.type == "cpu":
        return _decode_rows_torch(payload_rows, byte_lens, out_lens, num_steps)
    B, capb = _check_cuda("decode_rows", payload_rows, torch.uint8, 2)
    for t in (byte_lens, out_lens):
        _check_cuda("decode_rows", t, torch.int32, 1, (B,), payload_rows.device)
    dev = payload_rows.device
    syms = torch.zeros((B, num_steps), dtype=torch.uint8, device=dev)
    eof_ok = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0 or num_steps == 0:
        return syms, eof_ok
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.count(decode_rows)
        rc = lib.rsn_arith_decode(
            payload_rows.data_ptr(), byte_lens.data_ptr(), out_lens.data_ptr(),
            syms.data_ptr(), eof_ok.data_ptr(), B, capb, num_steps, _build.stream_handle(dev),
        )
    _build.check("rsn_arith_decode", rc)
    return syms, eof_ok


decode_rows.launches = 0


# ---------------------------------------------------------------------------
# Event record


MODEL_CELLS = 1 << 22  # (block, step, entry) cells of the model that _model_tables holds at once
STEP_CHUNK = 4096  # coder steps whose per-step tensors _encode_events_torch holds at once


def _model_tables(symbols: torch.Tensor, lengths: torch.Tensor):
    """Every step's (lower, upper, total) in the adaptive model, (B, S) int64 each.

    The model does not depend on the coder's state: before step t it has
    taken the update of every earlier step up to the freeze, so the steps
    are vectorised in chunks, each step's table being the chunk's first
    plus an exclusive cumulative sum of the chunk's updates. Past a block's
    EOF a step gets (0, 1, 1), which leaves the coder's interval as it is.
    """
    dev = symbols.device
    B, S = symbols.shape
    sym = symbols.to(torch.int64)
    n = lengths.to(torch.int64)
    idx = torch.arange(NUM_CUM, dtype=torch.int64, device=dev)
    cum = idx.repeat(B, 1)  # the model before the chunk
    updates = MAX_FREQ - (NUM_CUM - 1)  # the model freezes after this many
    lower = torch.empty((B, S), dtype=torch.int64, device=dev)
    upper = torch.empty_like(lower)
    total = torch.empty_like(lower)
    chunk = max(1, MODEL_CELLS // (max(B, 1) * NUM_CUM))
    for a in range(0, S, chunk):
        s = sym[:, a : a + chunk]
        t = torch.arange(a, a + s.shape[1], device=dev)
        upd = (t[None, :] <= n[:, None]) & (t[None, :] < updates)
        if a < updates:
            inc = ((idx > s[..., None]) & upd[..., None]).to(torch.int32)
            before = cum[:, None, :] + (inc.cumsum(1, dtype=torch.int32) - inc)
            cum = cum + inc.sum(1)
        else:
            before = cum[:, None, :].expand(-1, s.shape[1], -1)
        lower[:, a : a + chunk] = before.gather(2, s[..., None])[..., 0]
        upper[:, a : a + chunk] = before.gather(2, s[..., None] + 1)[..., 0]
        total[:, a : a + chunk] = before[..., NUM_CUM - 1]
    active = torch.arange(S, device=dev)[None, :] <= n[:, None]
    return torch.where(active, lower, 0), torch.where(active, upper, 1), torch.where(active, total, 1)


@functools.cache
def _renorm_tables(device: torch.device):
    """(16 - bit_length(x) for x < 2^16, the E3 count of a straddle mask z < 2^15, 2^s - 1 for s < 32)."""
    bitlen = _bitlen_table(device)
    z = torch.arange(1 << 15, dtype=torch.int64, device=device)
    fill = (1 << torch.arange(32, dtype=torch.int64, device=device)) - 1
    return 16 - bitlen, 15 - bitlen[~z & 0x7FFF], fill


@torch.inference_mode()  # the loop makes a few tensor operations a step: no autograd bookkeeping
def _encode_events_torch(symbols: torch.Tensor, lengths: torch.Tensor):
    """Plain version of kernel I: (slots (B, S, 16) uint8, slot0 (B, S) int32).

    The model's intervals come first, for all steps (:func:`_model_tables`);
    then a loop over steps narrows the coder's interval and renormalises it
    in closed form, as :func:`_renorm_shifts` does: ``k`` E1/E2 shifts, one
    per leading bit that low and high share, then ``m`` E3 shifts. Only
    ``k``, ``m`` and the narrowed low are kept, and the records are built
    from them after the loop: the ``k`` E1/E2 shifts emit bits 15, 14, ...
    of the narrowed low, the first of them flushing the carried pending
    count (``slot0``), which sums the E3 shifts since the last emitting
    step. No emission follows an E3 shift within a step, so the in-step
    pending field of every slot is 0.
    """
    dev = symbols.device
    B, S = symbols.shape
    if S == 0:
        return torch.zeros((B, 0, EVENT_SLOTS), dtype=torch.uint8, device=dev), torch.zeros((B, 0), dtype=torch.int32, device=dev)
    ks, ms, lows = _coder_shifts(torch.stack(_model_tables(symbols, lengths)))

    j = torch.arange(EVENT_SLOTS, dtype=torch.int64, device=dev)
    bit = (lows[..., None] >> (15 - j)) & 1
    first = (j == 0).to(torch.int64) << 5
    slots = torch.where(j < ks[..., None], 0x80 | (bit << 6) | first, 0).to(torch.uint8)
    # the pending count a step carries: the E3 shifts from the last emitting step before it on
    emit = ks > 0
    steps = torch.arange(S, dtype=torch.int64, device=dev)
    e3_before = ms.cumsum(1) - ms
    last = torch.where(emit, steps, 0).cummax(1).values
    last = torch.nn.functional.pad(last[:, :-1], (1, 0))  # the last emitting step before t, 0 if none
    carried = e3_before - e3_before.gather(1, last)
    slot0 = torch.where(emit, carried, 0).to(torch.int32)
    return slots, slot0


@torch.inference_mode()
def _coder_shifts(model: torch.Tensor) -> torch.Tensor:
    """The plain version's loop over the coder's steps, on the model's (lower,
    upper, total) (3, B, S): (E1/E2 shifts k, E3 shifts m, narrowed low) (3, B, S) int64."""
    dev = model.device
    _, B, S = model.shape
    k16, e3, fill = _renorm_tables(dev)
    low = torch.zeros(B, dtype=torch.int64, device=dev)
    high = torch.full((B,), MAX_CODE, dtype=torch.int64, device=dev)
    kml = torch.empty((3, B, S), dtype=torch.int64, device=dev)  # E1/E2 shifts, E3 shifts, narrowed low
    for a in range(0, S, STEP_CHUNK):
        ks, ms, lows = [], [], []
        for lo_t, up_t, tot_t in model[:, :, a : a + STEP_CHUNK].permute(2, 0, 1).unbind(0):
            diff = high - low + 1
            nh = low + diff * up_t // tot_t - 1
            nl = low + diff * lo_t // tot_t
            k = k16[nl ^ nh]
            lk = (nl << k) & MAX_CODE
            hk = (nh << k) & MAX_CODE
            m = e3[lk & (hk ^ 0x7FFF)]  # the leading bits where low has 1 and high 0
            shift = k + m
            low = (nl << shift) & 0x7FFF
            high = ((nh << shift) | fill[shift]) & 0x7FFF | ONE_HALF
            ks.append(k)
            ms.append(m)
            lows.append(nl)
        kml[:, :, a : a + STEP_CHUNK] = torch.stack([torch.stack(v, 1) for v in (ks, ms, lows)])
    return kml


def encode_events(symbols: torch.Tensor, lengths: torch.Tensor):
    """Adaptive arithmetic encode of B blocks into per-step event records (kernel I).

    Args:
      symbols: (B, S) int32 in [0, 256], EOF (256) at position ``lengths[b]``.
      lengths: (B,) int32 payload lengths (< S).

    Returns (slots (B, S, 16) uint8, slot0 (B, S) int32), the record of
    raisin_tpu/ops/arithmetic_pallas.py:encode_blocks_events: byte j of
    ``slots[b, t]`` is the j-th renormalisation shift of step t, ``0x80 |
    bit << 6 | first << 5 | in_pend`` where it emitted and 0 where not;
    ``slot0[b, t]`` is the carried pending count that the step's first
    emission flushes. Every step past a block's EOF gives zeros.

    On the card one call launches the kernel's three passes (the model, the
    coder's chain, the records) over a workspace of B * S int32 words.
    """
    if symbols.device.type == "cpu":
        return _encode_events_torch(symbols, lengths)
    B, S = _check_cuda("encode_events", symbols, torch.int32, 2)
    _check_cuda("encode_events", lengths, torch.int32, 1, (B,), symbols.device)
    dev = symbols.device
    slots = torch.empty((B, S, EVENT_SLOTS), dtype=torch.uint8, device=dev)
    slot0 = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B == 0 or S == 0:
        return slots, slot0
    words = torch.empty((B, S), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.count(encode_events)
        rc = lib.rsn_arith_events(
            symbols.data_ptr(), lengths.data_ptr(), slots.data_ptr(), slot0.data_ptr(), words.data_ptr(),
            B, S, _build.stream_handle(dev),
        )
    _build.check("rsn_arith_events", rc)
    return slots, slot0


encode_events.launches = 0

KERNEL_WRAPPERS = (encode_bits, prepad_rows, decode_rows, encode_events)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def _check_cuda(name, t, dtype, ndim, shape=None, device=None):
    """Validate a tensor handed to a kernel; returns its shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: tensors on {t.device} and {device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got {t.dtype} {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if max(t.shape, default=0) >= 2**31:
        raise ValueError(f"{name}: dimension too large for the kernel")
    return tuple(t.shape)
