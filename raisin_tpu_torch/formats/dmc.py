"""DMC ("dynamic Markov chain") — compress-only codec: the port's copy of the host oracle.

A copy of raisin_tpu/formats/dmc_ref.py, ``DmcError`` and the decode stub
included (the port imports nothing of the JAX package). It is the ``host``
backend of ``dmc``, and the native loader raises its ``DmcError``.

Format (reference compressor/dmc/dmc.go): builds a Markov tree with MoveUp
links over the input (dmc.go:32), sorts nodes by occurrences (dmc.go:196),
then re-walks the input emitting one little-endian int8 per non-implicit
transition, with a ``[-2, count]`` end marker (dmc.go:79-83,148).

The reference's file decoder is a stub returning ``b"Hello!"`` (dmc.go:274),
so the codec is NOT round-trippable from a file — the engine's benchmark
lists it as lossy (cmd/cli_test.go:13-14). We replicate the stub for parity
and additionally expose :func:`decode_with_chain`, the honest in-memory
decoder the reference keeps commented out (GetOutputFromBits, dmc.go:151).

Behavioral notes replicated faithfully:

- The root node's ``Value`` is 0, so a NUL input byte whose only stack match
  is the root empties the stack and the reference panics (dmc.go:43-51); we
  raise ``DmcError``.
- ``SortNodesByOccurrences`` uses Go's unstable sort; we sort stably
  (divergence is unobservable through the stub decoder, and the in-memory
  decoder shares the encoder's chain).
- Transition values are truncated to int8 on the wire (dmc.go:81).
"""

from __future__ import annotations


class DmcError(Exception):
    pass


class Chain:
    __slots__ = ("value", "nodes", "occurrences", "move_up")

    def __init__(self, value: int = 0, occurrences: int = 1, move_up: int = 0) -> None:
        self.value = value
        self.nodes: list[Chain] = []
        self.occurrences = occurrences
        self.move_up = move_up


def _find_value_up_stack(look_for: int, stack: list[Chain]) -> int:
    for i in range(len(stack) - 1, -1, -1):
        if stack[i].value == look_for:
            return i
    return -1


def _index_of_value(look_for: int, nodes: list[Chain]) -> int:
    for i, node in enumerate(nodes):
        if node.value == look_for:
            return i
    return -1


def _index_of_move_up(move_up: int, nodes: list[Chain]) -> int:
    for i, node in enumerate(nodes):
        if node.move_up == move_up:
            return i
    return -1


def build_chain(data: bytes) -> Chain:
    """Markov tree construction (parity with dmc.go:36-67)."""
    chain = Chain(occurrences=0)  # Go zero-value root: Occurrences 0, Value 0
    stack = [chain]
    for b in data:
        up_idx = _find_value_up_stack(b, stack)
        if up_idx != -1:
            top = stack[-1]
            move_idx = _index_of_move_up(len(stack) - up_idx, top.nodes)
            if move_idx == -1:
                top.nodes.append(Chain(occurrences=1, move_up=len(stack) - up_idx))
            else:
                top.nodes[move_idx].occurrences += 1
            stack = stack[:up_idx]
            if not stack:
                raise DmcError("dmc: stack emptied (NUL byte matched root; reference panics)")
        node = stack[-1]
        idx = _index_of_value(b, node.nodes)
        if idx == -1:
            new_node = Chain(value=b)
            node.nodes.append(new_node)
            stack.append(new_node)
        else:
            node.nodes[idx].occurrences += 1
            stack.append(node.nodes[idx])
    return chain


def _sort_nodes(chain: Chain) -> None:
    """Parity with SortNodesByOccurrences (dmc.go:196), stable variant."""
    chain.nodes.sort(key=lambda n: -n.occurrences)
    for node in chain.nodes:
        if node.nodes:
            _sort_nodes(node)


def chain_to_transitions(chain: Chain, data: bytes) -> list[int]:
    """Iterative port of GetBitsFromChain (dmc.go:100-149).

    Emits one transition index per input byte unless the node has exactly one
    child (implicit transition, encoded as nothing); ends with ``[-2, count]``
    where count grows for each trailing implicit transition, and -2 becomes
    -1 when a non-implicit transition precedes it.
    """
    out: list[int] = []
    trailing_implicit = 0  # increments on implicit transitions after last emit
    node = chain
    stack: list[Chain] = []
    for pos, val in enumerate(data):
        new_stack = stack + [node]
        transition = None
        look_in: Chain | None = None

        idx = _index_of_value(val, node.nodes)
        if idx == -1:
            for i, child in enumerate(node.nodes):
                if child.move_up > 0 and new_stack[len(new_stack) - child.move_up].value == val:
                    look_in = new_stack[len(new_stack) - child.move_up]
                    new_stack = new_stack[: len(new_stack) - child.move_up + 1]
                    transition = -1 if len(node.nodes) == 1 else i
                    break
            new_stack = new_stack[:-1]
            if look_in is None:
                raise DmcError("dmc: no transition found for byte")
        else:
            look_in = node.nodes[idx]
            transition = -1 if len(node.nodes) == 1 else idx

        if transition == -1:
            trailing_implicit += 1
        else:
            out.append(transition)
            trailing_implicit = 0
        node = look_in
        stack = new_stack

    # End marker semantics from the recursive reference: the final [-2, n]
    # counts trailing implicit transitions; a preceding explicit transition
    # turns -2 into -1.
    marker = -1 if out else -2
    return out + [marker, trailing_implicit]


def compress(data: bytes) -> bytes:
    """Parity with dmc.Compress (dmc.go:32): int8 little-endian transitions."""
    chain = build_chain(data)
    _sort_nodes(chain)
    transitions = chain_to_transitions(chain, data)
    return bytes((t + 256) % 256 if t < 0 else t % 256 for t in transitions)


def decompress(data: bytes) -> bytes:
    """Reference stub: always returns b"Hello!" (dmc.go:274-276)."""
    return b"Hello!"


def decode_with_chain(transitions: list[int], chain: Chain) -> bytes:
    """Honest in-memory decoder (port of GetOutputFromBits, dmc.go:151)."""
    out = bytearray()
    node = chain
    stack: list[Chain] = []
    i = 0
    while True:
        stack = stack + [node]
        if len(node.nodes) == 1 and transitions[i] >= 0:
            node = node.nodes[0]
            if node.move_up != 0:
                move_up = node.move_up
                node = stack[len(stack) - move_up]
                stack = stack[: len(stack) - move_up]
            out.append(node.value)
            continue
        path = transitions[i]
        if path in (-1, -2):
            count = transitions[i + 1]
            for _ in range(count):
                node = node.nodes[0]
                if node.move_up != 0:
                    move_up = node.move_up
                    node = stack[len(stack) - move_up]
                    stack = stack[: len(stack) - move_up + 1]
                else:
                    stack.append(node)
                out.append(node.value)
            return bytes(out)
        node = node.nodes[path]
        if node.move_up != 0:
            move_up = node.move_up
            node = stack[len(stack) - move_up]
            stack = stack[: len(stack) - move_up]
        out.append(node.value)
        i += 1
