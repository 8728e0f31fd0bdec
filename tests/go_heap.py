"""Go's ``container/heap`` sift-up for the JAX package's Huffman oracle, put in at run time by the tests.

The oracle's ``_GoTreeHeap._up`` (raisin_tpu/formats/huffman_ref.py) takes
the root's parent as ``(0 - 1) // 2 == -1`` and may swap the root with the
last item. Go's ``up`` computes ``(j - 1) / 2``, which truncates toward
zero: the root is its own parent and the climb stops there. The port builds
Go's tree; with :func:`go_up` in the oracle's place (no file of the JAX
package changes), the JAX package still checks every byte of the port's
Huffman streams and containers. A test module takes the fixture
:func:`jax_heap_at_go_rule` by importing it by name.
"""

from __future__ import annotations

import pytest


def go_up(self, j: int) -> None:
    """Go's ``up(h, j)`` on the oracle's heap."""
    while True:
        i = (j - 1) // 2 if j > 0 else 0
        if i == j or not self._less(j, i):
            break
        self.h[i], self.h[j] = self.h[j], self.h[i]
        j = i


@pytest.fixture
def jax_heap_at_go_rule(monkeypatch):
    """The JAX package's Huffman oracle with its heap's sift-up held to Go's rule, for this test only.
    ``test_torch_huffman_go.py`` pins the unpatched divergence."""
    from raisin_tpu.formats import huffman_ref

    monkeypatch.setattr(huffman_ref._GoTreeHeap, "_up", go_up)


def apply() -> None:
    """Put :func:`go_up` in the oracle's place for the rest of the process (a subprocess's
    ``sitecustomize``; tests in this process use the ``jax_heap_at_go_rule`` fixture)."""
    from raisin_tpu.formats import huffman_ref

    huffman_ref._GoTreeHeap._up = go_up


def sitecustomize(directory, repo) -> str:
    """Write a ``sitecustomize.py`` into ``directory`` that applies :func:`go_up` when a Python process
    starts; -> the ``PYTHONPATH`` that makes a subprocess load it (``directory``, ``repo``, then this
    process's own)."""
    import os
    from pathlib import Path

    Path(directory, "sitecustomize.py").write_text(
        f"import runpy\n\nrunpy.run_path({str(Path(__file__).resolve())!r})['apply']()\n")
    return os.pathsep.join([str(directory), str(repo), *filter(None, [os.environ.get("PYTHONPATH")])])
