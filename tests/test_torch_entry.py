"""The port's entry points (raisin_tpu_torch.entry) against __graft_entry__.py.

``entry()``'s forward (kernels D, E and I through their plain versions on
the CPU) gives the JAX entry's bits on the same x, after packing them to
bytes; ``dryrun_multichip(2)`` runs the container and the sharded step on
two gloo CPU processes and holds every payload and block against the
oracle copies.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from raisin_tpu_torch import entry as port_entry


def _pack(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8), axis=1)


def test_entry_forward_equals_the_jax_entry():
    forward, (x, lengths) = port_entry.entry(device="cpu")
    jax_forward, (xj, lj) = graft.entry()
    assert x.dtype == torch.uint8 and tuple(x.shape) == xj.shape == (4, 1024)
    assert np.array_equal(x.numpy(), xj) and np.array_equal(lengths.numpy(), lj)
    bits, bit_len = forward(x, lengths)
    want_bits, want_len = (np.asarray(a) for a in jax.jit(jax_forward)(xj, lj))
    assert np.array_equal(bit_len.numpy(), want_len)
    assert bits.shape == want_bits.shape
    assert np.array_equal(_pack(bits.numpy()), _pack(want_bits))


def test_dryrun_multichip_on_two_gloo_processes(capsys):
    port_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: 2 ranks on cpu (gloo)" in out
    assert "{'data': 1, 'model': 2} step 2/2 blocks" in out


def test_dryrun_multichip_runs_on_the_cards_by_default(monkeypatch):
    """Without ``device`` the ranks go to the cards, a card each: none raises, and more ranks than
    cards name both numbers; one card for every rank needs gloo. No process starts in any case."""
    monkeypatch.setattr(port_entry, "run_ranks", lambda *a, **k: pytest.fail("a rank was started"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="devices=2: more than the 1 visible card$"):
        port_entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="devices=2: more than the 1 visible card$"):
        port_entry.dryrun_multichip(2, device="cuda")
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one card"):
        port_entry.dryrun_multichip(2, device="cuda:0")


def test_dryrun_multichip_gives_each_rank_its_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    seen = {}

    def fake_run_ranks(argv_of, n, env):
        seen["argv"] = [argv_of(r) for r in range(n)]
        return ["dryrun_multichip OK\n"] * n

    monkeypatch.setattr(port_entry, "run_ranks", fake_run_ranks)
    port_entry.dryrun_multichip(4)
    devices = [a[a.index("--device") + 1] for a in seen["argv"]]
    assert devices == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert all("--backend" not in a for a in seen["argv"])  # NCCL, initialize's rule for a card
    assert all(a[a.index("--init") + 1].startswith("file://") for a in seen["argv"])
    port_entry.dryrun_multichip(2, backend="gloo", device="cuda:1")
    assert [a[a.index("--device") + 1] for a in seen["argv"]] == ["cuda:1", "cuda:1"]
