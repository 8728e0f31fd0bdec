"""Plain adaptive arithmetic encoder of the `.rsn` wire format (compressor/arithmetic/arithmetic.go, bits.go).

The benchmark's own reference: NumPy for the model, plain Python for the
coder. It imports nothing of the program and nothing of the JAX package.

- Order-0 model over 257 symbols (bytes and EOF = 256), ``cum[i] = i`` at
  the start; after each coded symbol every higher cumulative count grows
  by one, until ``cum[257]`` reaches ``max_freq`` (16383, arithmetic.go:42),
  after which the model is frozen. So step t codes with
  ``cum[s] = s + #{j < min(t, F) : sym[j] < s}`` and the count
  ``257 + min(t, F)``, F = max_freq - 257: the model is worked out for
  every step at once, before the coder runs.
- 16-bit coder (arithmetic.go:115-163): after the range update, the top
  bits that low and high share are emitted (the first followed by the
  pending bits, inverted); then each E3 step (low 01..., high 10...) adds
  a pending bit. The two loops run as one count each. EOF ends the
  stream, with no flush.
- Bits are packed MSB first after a ``0...01`` prepad of 1..8 bits
  (bits.go:48).

``max_freq`` is the precision of the model's counts; the benchmark's
control codes with one bit less (8191).
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os

import numpy as np

MAX_FREQ = 16383
CONTROL_MAX_FREQ = 8191  # the control's model: its counts one bit narrower
EOF = 256
NUM_CUM = 258
POOL_BYTES = 1 << 20  # inputs in all past which the coding runs in worker processes
MAX_WORKERS = 8
# leading zeros of a 16-bit value (16 for 0)
_CLZ16 = [16] + [16 - v.bit_length() for v in range(1, 1 << 16)]


def model_steps(symbols: np.ndarray, max_freq: int = MAX_FREQ) -> tuple[list[int], list[int], list[int]]:
    """(lower, upper, count) of every step for ``symbols`` (EOF included), as lists."""
    T = symbols.size
    adaptive = min(T, max_freq - (NUM_CUM - 1))
    s = symbols.astype(np.int64)
    lower = np.empty(T, dtype=np.int64)
    upper = np.empty(T, dtype=np.int64)
    # seen[t, v]: symbols <= v among the first t (t < adaptive), exclusive of step t
    onehot = np.zeros((adaptive + 1, NUM_CUM - 1), dtype=np.int16)
    onehot[np.arange(1, adaptive + 1), s[:adaptive]] = 1
    seen = onehot.cumsum(0, dtype=np.int16).cumsum(1, dtype=np.int16)
    t = np.arange(adaptive)
    below = np.where(s[:adaptive] > 0, seen[t, np.maximum(s[:adaptive] - 1, 0)], 0)
    lower[:adaptive] = s[:adaptive] + below
    upper[:adaptive] = s[:adaptive] + 1 + seen[t, s[:adaptive]]
    frozen = np.arange(NUM_CUM, dtype=np.int64)
    frozen[1:] += seen[adaptive].astype(np.int64)
    lower[adaptive:] = frozen[s[adaptive:]]
    upper[adaptive:] = frozen[s[adaptive:] + 1]
    count = np.minimum(np.arange(T), adaptive) + (NUM_CUM - 1)
    return lower.tolist(), upper.tolist(), count.tolist()


def encode_bits(data: bytes, max_freq: int = MAX_FREQ) -> str:
    """The coder's bits for ``data`` and EOF, as a string of '0' and '1'."""
    symbols = np.concatenate([np.frombuffer(data, dtype=np.uint8).astype(np.int64), [EOF]])
    lower, upper, count = model_steps(symbols, max_freq)
    clz = _CLZ16
    low, high, pending = 0, 0xFFFF, 0
    pieces = []
    for lo, up, c in zip(lower, upper, count):
        diff = high - low + 1
        high = low + diff * up // c - 1
        low = low + diff * lo // c
        k1 = clz[low ^ high]
        if k1:
            shared = format(low >> (16 - k1), "016b")[16 - k1 :]
            if pending:
                shared = shared[0] + ("0" if shared[0] == "1" else "1") * pending + shared[1:]
                pending = 0
            pieces.append(shared)
            low = (low << k1) & 0xFFFF
            high = ((high << k1) | ((1 << k1) - 1)) & 0xFFFF
        k3 = clz[~(low & ~high) & 0x7FFF] - 1  # E3: low 01..., high 10...
        if k3:
            pending += k3
            low = (low << k3) & 0x7FFF
            high = ((high << k3) | ((1 << k3) - 1)) & 0x7FFF | 0x8000
    return "".join(pieces)


def pack(bits: str) -> bytes:
    """The ``0...01`` prepad, then the bits MSB first (bits.go:48)."""
    pad = 8 - len(bits) % 8
    arr = np.frombuffer(("0" * (pad - 1) + "1" + bits).encode("ascii"), dtype=np.uint8) - ord("0")
    return np.packbits(arr).tobytes()


def compress(data: bytes, max_freq: int = MAX_FREQ) -> bytes:
    """The `.rsn` arithmetic stream of ``data``."""
    return pack(encode_bits(data, max_freq))


def compress_many(inputs: list[bytes], window: int, device, max_freq: int = MAX_FREQ) -> list[bytes]:
    """The arithmetic stream of each input (``window`` and ``device`` are the pipeline's, unused).

    Past POOL_BYTES in all, the inputs are coded in worker processes, the
    longest first; the workers have ended when this returns.
    """
    workers = min(len(inputs), os.cpu_count() or 1, MAX_WORKERS)
    if workers < 2 or sum(len(b) for b in inputs) < POOL_BYTES:
        return [compress(b, max_freq) for b in inputs]
    order = sorted(range(len(inputs)), key=lambda k: -len(inputs[k]))
    context = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=context) as pool:
        done = list(pool.map(compress, [inputs[k] for k in order], [max_freq] * len(order)))
    out = [b""] * len(inputs)
    for k, stream in zip(order, done):
        out[k] = stream
    return out
