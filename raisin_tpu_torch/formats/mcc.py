"""MCC ("Markov chain compressor") — `.rsn` wire format: the port's copy of the host oracle.

A copy of raisin_tpu/formats/mcc_ref.py, messages included (the port
imports nothing of the JAX package). It is the ``host`` backend of ``mcc``.

Format (reference compressor/mcc/mcc.go): an adaptive state machine over
byte-labelled states, each state carrying token children (one Read token plus
power-of-two Up tokens 1,2,4,…,256; mcc.go:163-185). The wire format is the
ASCII comma-separated transition indices, a ``\\`` separator (0x5C), then the
literal bytes in first-occurrence order (mcc.go:389-392). Per-state Huffman
codes exist in the reference only to print a theoretical bit length — they
are never serialized.

Divergence note: the reference re-sorts transitions with Go's UNSTABLE
``sort.Slice`` (mcc.go:80); we sort stably. Encoder and decoder perform the
same sorts in the same order, so round-trips are lossless either way, but
transition indices may differ from reference-produced files when frequency
ties occur.
"""

from __future__ import annotations

SEPARATOR = 0x5C  # '\'
HIGHEST_ORDER_FOR_UP = 8  # 2^8 = 256 (mcc.go:161)
READ = 0


class State:
    __slots__ = ("is_root", "token", "is_tok", "symbol", "freq", "transitions", "parent")

    def __init__(
        self,
        *,
        is_root: bool = False,
        token: int = 0,
        is_tok: bool = False,
        symbol: int = 0,
        freq: int = 0,
        parent: "State | None" = None,
    ) -> None:
        self.is_root = is_root
        self.token = token
        self.is_tok = is_tok
        self.symbol = symbol
        self.freq = freq
        self.transitions: list[State] = []
        self.parent = parent

    # --- reference State methods (mcc.go:45-159) ---

    def has_symbol(self, symbol: int) -> bool:
        return not self.is_tok and symbol == self.symbol

    def parent_with_symbol(self, symbol: int) -> int:
        state = self
        dist = 0
        while True:
            if not state.is_tok and not state.is_root and symbol == state.symbol:
                return dist
            if state.parent is None:
                return -1
            state = state.parent
            dist += 1

    def get_parent(self, up: int) -> "State":
        state = self
        for _ in range(up):
            state = state.parent  # type: ignore[assignment]
        return state

    def tok_state(self, tok: int) -> "State":
        for child in self.transitions:
            if child.is_tok and child.token == tok:
                return child
        raise ValueError("mcc: token state not found")

    def sort_by_frequency(self) -> None:
        self.transitions.sort(key=lambda s: -s.freq)  # stable (see module doc)

    def index_in_parent(self) -> int:
        assert self.parent is not None
        return self.parent.transitions.index(self)


def _generate_state_tokens(state: State) -> list[State]:
    """Token children with the reference's quirky frequency ramp (mcc.go:172).

    Read=900, Up1=800, Up2=-100, Up4=-200, … Up256=-800.
    """
    tokens = [READ] + [2**i for i in range(HIGHEST_ORDER_FOR_UP + 1)]
    states = []
    freq = 1000
    for i, tok in enumerate(tokens):
        if i == 2:
            freq = 0
        freq -= 100
        states.append(State(token=tok, is_tok=True, parent=state, freq=freq))
    return states


def _create_state(symbol: int, parent: State) -> State:
    state = State(symbol=symbol, parent=parent, freq=1)
    state.transitions = _generate_state_tokens(state)
    parent.transitions.append(state)
    return state


def _create_root() -> State:
    root = State(is_root=True)
    root.transitions = _generate_state_tokens(root)
    return root


def encode_bytes(data: bytes) -> tuple[list[int], bytes]:
    """Transition-index stream + literals (parity with mcc.go:212)."""
    stream: list[int] = []
    literals = bytearray()
    state = _create_root()

    for b in data:
        state_with_symbol = None
        for child in state.transitions:
            if child.has_symbol(b):
                state_with_symbol = child  # last match wins, as in the Go loop

        if state_with_symbol is not None:
            state = state_with_symbol
            stream.append(state.index_in_parent())
            state.freq += 1
            state.parent.sort_by_frequency()
            continue

        up = state.parent_with_symbol(b)
        if up == -1:
            new_state = _create_state(b, state)
            stream.append(state.tok_state(READ).index_in_parent())
            literals.append(b)
            state = new_state
        else:
            orig = state
            state = state.get_parent(up)
            state.freq += 1
            state.parent.sort_by_frequency()
            up += 1
            encoded = False
            for i in range(HIGHEST_ORDER_FOR_UP, -1, -1):
                magnitude = 2**i
                if up - magnitude >= 0:
                    divisible = up // magnitude
                    for _ in range(divisible):
                        stream.append(orig.tok_state(magnitude).index_in_parent())
                        up -= magnitude
                        if encoded:
                            orig = orig.get_parent(magnitude)
                        else:
                            # first "up" enters the current state, so one less
                            orig = orig.get_parent(magnitude - 1)
                            encoded = True
            stream.append(state.tok_state(READ).index_in_parent())

    return stream, bytes(literals)


def decode_bytes(stream: list[int], literals: bytes) -> bytes:
    """Parity with mcc.go:321."""
    state = _create_root()
    out = bytearray()
    lit_pos = 0
    moving_up = False

    for idx in stream:
        if idx < 0 or idx >= len(state.transitions):
            raise ValueError("mcc: transition index out of range")
        child = state.transitions[idx]
        if child.is_tok:
            if child.token == READ:
                if moving_up:
                    out.append(state.symbol)
                    moving_up = False
                    state.freq += 1
                    state.parent.sort_by_frequency()
                else:
                    if lit_pos >= len(literals):
                        raise ValueError("mcc: literal stream exhausted")
                    symbol = literals[lit_pos]
                    lit_pos += 1
                    out.append(symbol)
                    state = _create_state(symbol, child.parent)
            else:
                move_up = child.token
                if not moving_up:
                    moving_up = True
                    move_up -= 1
                for _ in range(move_up):
                    if state.parent is None:
                        raise ValueError("mcc: trying to go up past root node")
                    state = state.parent
        else:
            state = child
            out.append(state.symbol)
            state.freq += 1
            state.parent.sort_by_frequency()
    return bytes(out)


def compress(data: bytes) -> bytes:
    """Parity with mcc.Compress (mcc.go:410)."""
    stream, literals = encode_bytes(data)
    return ",".join(str(i) for i in stream).encode("ascii") + bytes([SEPARATOR]) + literals


def decompress(data: bytes) -> bytes:
    """Parity with mcc.Decompress (mcc.go:428)."""
    sep = data.find(SEPARATOR)
    if sep < 0:
        raise ValueError("mcc: missing separator")
    head = data[:sep].decode("ascii")
    literals = data[sep + 1 :]
    # reference: Atoi on each piece panics on empty/garbage (mcc.go:401)
    stream = [int(piece) for piece in head.split(",")]
    return decode_bytes(stream, literals)
