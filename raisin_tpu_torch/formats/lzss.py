"""LZSS codec, exact `.rsn` wire format: the port's copy of the host oracle.

A copy of raisin_tpu/formats/lzss_ref.py, messages included (the port
imports nothing of the JAX package). It is the ``host`` backend of ``lzss``
and decodes raw LZSS streams, as the JAX package does
(raisin_tpu/ops/lzss_jax.py:338-342).

Format (reference compressor/lz/lzss.go):

- Escape pre-pass over the plaintext (lzss.go:369): ``<`` (0x3C) -> 0xFF;
  0xFF -> 0x5C 0xFF; 0x5C -> 0x5C 0x5C. (The reference's ``foundEscape``
  branch is dead code — 0x5C is always caught by the second branch.)
- Token stream: literal bytes interleaved with ASCII references ``<D,L>``
  where D = distance back from the current position and L = match length,
  both decimal (lzss.go:318). A reference is emitted only when its ASCII
  encoding is strictly shorter than the matched bytes (lzss.go:143).
- Match search (parity with CompressAsync, the variant the engine uses,
  lzss.go:109): per position i the window is the trailing ``window_size``
  bytes of the escaped stream before i. L is the largest k such that
  ``enc[i:i+k]`` occurs inside the window as a contiguous substring (whole
  match inside the prefix, so L <= D), and D = i - s where s is the LEFTMOST
  occurrence start of that longest string (bytes.Index semantics,
  lzss.go:418). Matches are computed INDEPENDENTLY per position against the
  original escaped stream — the commit pass then walks positions in order,
  consuming L positions per accepted reference (lzss.go:134-151); when the
  ASCII token is not shorter, the L raw matched bytes are emitted and the
  same L positions are still consumed.
- Decoder: byte state machine scanning ``< … , … >`` (lzss.go:332), copying
  ``searchBuffer[len-D : len-D+L]`` from the decoded (still escaped) stream,
  then the escape decode pass (lzss.go:391).
"""

from __future__ import annotations

OPENING = 0x3C  # '<'
CLOSING = 0x3E  # '>'
SEP = 0x2C  # ','
ENCODED_OPENING = 0xFF
ESCAPE = 0x5C
DEFAULT_WINDOW_SIZE = 4096


def encode_opening_symbols(data: bytes) -> bytes:
    """Escape pre-pass (lzss.go:369), vectorized.

    '<' -> 0xFF;  0xFF -> 0x5C 0xFF;  0x5C -> 0x5C 0x5C.
    """
    import numpy as np

    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size == 0:
        return b""
    needs_escape = (arr == ENCODED_OPENING) | (arr == ESCAPE)
    if not needs_escape.any():
        out = arr.copy()
        out[out == OPENING] = ENCODED_OPENING
        return out.tobytes()
    # output start offset of each input byte
    starts = np.arange(arr.size) + np.cumsum(needs_escape) - needs_escape
    out = np.empty(arr.size + int(needs_escape.sum()), dtype=np.uint8)
    payload = np.where(arr == OPENING, np.uint8(ENCODED_OPENING), arr)
    out[starts + needs_escape] = payload
    out[starts[needs_escape]] = ESCAPE
    return out.tobytes()


def decode_opening_symbols_np(data: bytes) -> bytes:
    """Escape decode pass (lzss.go:391), vectorized.

    A byte is "escaped" iff it is preceded by an ODD run of 0x5C bytes that
    are themselves unescaped — equivalently, iff the run of consecutive
    0x5C immediately before it has odd length (escape pairs cancel).
    """
    import numpy as np

    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size == 0:
        return b""
    is_esc_byte = arr == ESCAPE
    idx = np.arange(arr.size)
    last_non = np.maximum.accumulate(np.where(~is_esc_byte, idx, -1))
    # run of 0x5C immediately before position i
    run_before = idx - 1 - np.where(idx > 0, last_non[np.maximum(idx - 1, 0)], -1)
    run_before[0] = 0
    escaped = (run_before % 2) == 1
    keep = ~(is_esc_byte & ~escaped)
    out = np.where((arr == ENCODED_OPENING) & ~escaped, np.uint8(OPENING), arr)
    return out[keep].tobytes()


def decode_opening_symbols(data: bytes) -> bytes:
    """Escape decode pass (lzss.go:391)."""
    out = bytearray()
    escaped = False
    for b in data:
        if b == ENCODED_OPENING and not escaped:
            out.append(OPENING)
        elif b == ESCAPE and not escaped:
            escaped = True
        else:
            escaped = False
            out.append(b)
    return bytes(out)


def token_bytes(distance: int, length: int) -> bytes:
    """ASCII reference token (lzss.go:318)."""
    return b"<%d,%d>" % (distance, length)


def find_matches(enc: bytes, window_size: int) -> list[tuple[int, int]]:
    """Per-position (distance, length); (0, 0) when no match.

    Oracle semantics of the per-position goroutine (lzss.go:119-130 +
    compressorWorker lzss.go:166): longest k with enc[i:i+k] a substring of
    the trailing window, D from the leftmost occurrence of that longest
    string.
    """
    n = len(enc)
    refs: list[tuple[int, int]] = [(0, 0)] * n
    for i in range(n):
        start = max(0, i - window_size) if window_size > 0 else 0
        window = enc[start:i]
        if not window:
            continue
        k = 1
        idx = window.find(enc[i : i + 1])
        if idx < 0:
            continue
        best_idx = idx
        while i + k < n:
            nxt = window.find(enc[i : i + k + 1])
            if nxt < 0:
                break
            k += 1
            best_idx = nxt
        refs[i] = (len(window) - best_idx, k)
    return refs


def commit_tokens(enc: bytes, refs: list[tuple[int, int]]) -> bytes:
    """Sequential commit pass (lzss.go:134-151)."""
    out = bytearray()
    ignore = 0
    for i, b in enumerate(enc):
        if ignore > 0:
            ignore -= 1
            continue
        dist, length = refs[i]
        if length > 0:
            ignore = length - 1
            tok = token_bytes(dist, length)
            if len(tok) < length:
                out += tok
            else:
                out += enc[i : i + length]
        else:
            out.append(b)
    return bytes(out)


def _match_at(enc: bytes, i: int, window_size: int) -> tuple[int, int]:
    """(distance, length) of the greedy match at one position (the body of
    find_matches, reused by the fused compress loop)."""
    n = len(enc)
    start = max(0, i - window_size) if window_size > 0 else 0
    window = enc[start:i]
    if not window:
        return (0, 0)
    k = 1
    idx = window.find(enc[i : i + 1])
    if idx < 0:
        return (0, 0)
    best_idx = idx
    while i + k < n:
        nxt = window.find(enc[i : i + k + 1])
        if nxt < 0:
            break
        k += 1
        best_idx = nxt
    return (len(window) - best_idx, k)


def compress(data: bytes, window_size: int = DEFAULT_WINDOW_SIZE) -> bytes:
    """Parity with reference lz.CompressAsync (lzss.go:109).

    Search and commit run fused: the greedy commit consumes ``length``
    positions per match and never reads their (D, L), so the oracle skips
    the window search there — on long uniform runs (where every position's
    search extends across the whole window) this drops the worst case from
    O(n * window * len) to O(commits * window * len), same bytes out.
    """
    enc = encode_opening_symbols(data)
    out = bytearray()
    i = 0
    n = len(enc)
    while i < n:
        dist, length = _match_at(enc, i, window_size)
        if length > 0:
            tok = token_bytes(dist, length)
            if len(tok) < length:
                out += tok
            else:
                out += enc[i : i + length]
            i += length
        else:
            out.append(enc[i])
            i += 1
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Parity with reference lz.Decompress (lzss.go:323)."""
    search = bytearray()
    out = bytearray()
    state = 0  # 0: looking for '<', 1: looking for ',', 2: looking for '>'
    num_a = bytearray()
    num_b = bytearray()
    pointer = 0
    for b in data:
        if state == 0 and b == OPENING:
            state = 1
        elif state == 1:
            if b == SEP:
                state = 2
                pointer = _go_atoi(num_a)
                num_a.clear()
            else:
                num_a.append(b)
        elif state == 2:
            if b == CLOSING:
                state = 0
                offset = _go_atoi(num_b)
                num_b.clear()
                abs_ptr = len(search) - pointer
                if abs_ptr < 0 or abs_ptr + offset > len(search):
                    raise ValueError("lzss: reference outside decoded window")
                chunk = search[abs_ptr : abs_ptr + offset]
                out += chunk
                search += chunk
            else:
                num_b.append(b)
        else:
            out.append(b)
            search.append(b)
    return decode_opening_symbols(bytes(out))


def _go_atoi(digits: bytearray) -> int:
    """strconv.Atoi with the reference's ignored error -> 0 fallback."""
    try:
        return int(bytes(digits))
    except ValueError:
        return 0
