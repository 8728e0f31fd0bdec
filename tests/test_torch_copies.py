"""The host's copy into ``bytes`` (``ops/device.to_bytes``): the same bytes as ``tobytes()`` at every
length around the split, the piece rule and its counter, one ``copy.bytes`` range a copy, many
threads at once, and a pinned source on a card; and ``ops/device.put``, which fills the host buffer
that the copy reads.

The card test is marked ``card`` and skips without one. On a machine with a card (this file
imports no JAX; the directory's conftest.py does, so it is left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_copies.py -m card
"""

from __future__ import annotations

import sys
import threading

import pytest
import torch

from raisin_tpu_torch.ops import device

MIB = 1 << 20
SPLIT = 2 * device.PIECE_MIN  # the least length that splits, on a host of four cores or more


def _tensor(n: int, seed: int = 0) -> torch.Tensor:
    return torch.randint(0, 256, (n,), dtype=torch.uint8, generator=torch.Generator().manual_seed(seed))


@pytest.fixture
def eight_cores(monkeypatch):
    """The piece rule as on an eight-core host, whatever this one has."""
    monkeypatch.setattr(device.os, "cpu_count", lambda: 8)
    device.reset_copy_counts()
    yield
    device.reset_copy_counts()


@pytest.mark.parametrize("n, pieces", [
    (0, 1), (1, 1), (SPLIT - 1, 1), (SPLIT, 2), (SPLIT + 1, 2),
    (3 * device.PIECE_MIN + 1, 3),  # three pieces that do not divide it
    (64 * MIB + 3, 4),
])
def test_to_bytes_equals_tobytes(eight_cores, n, pieces):
    t = _tensor(n, seed=n)
    got = device.to_bytes(t)
    assert type(got) is bytes and got == t.numpy().tobytes()
    assert device.copy_pieces(n) == pieces


@pytest.mark.parametrize("n", [5, SPLIT + 7])
def test_the_result_is_bytes_of_its_own(eight_cores, n):
    t = _tensor(n, seed=1)
    want = t.numpy().tobytes()
    got = device.to_bytes(t)
    t.fill_(0)
    assert type(got) is bytes and got == want
    assert hash(got) == hash(want)


def test_the_counter_reads_whole_then_split(eight_cores):
    device.to_bytes(_tensor(1000))
    assert device.copies == {"whole": 1, "split": 0, "pieces": 0}
    device.to_bytes(_tensor(64 * MIB + 3))
    assert device.copies == {"whole": 1, "split": 1, "pieces": 4}
    device.reset_copy_counts()
    assert device.copies == {"whole": 0, "split": 0, "pieces": 0}


def test_put_copies_as_far_as_the_buffer_reaches():
    out = torch.zeros(6, dtype=torch.uint8)
    assert device.put(out, 1, torch.tensor([1, 2, 3], dtype=torch.uint8)) == 3
    assert device.put(out, 4, b"\x07\x08\x09") == 3
    assert device.put(out, 6, b"\x05") == 1
    assert out.tolist() == [0, 1, 2, 3, 7, 8]


@pytest.mark.parametrize("n, cores, pieces", [
    (64 * MIB, 1, 1), (64 * MIB, 2, 1), (64 * MIB, 3, 1), (64 * MIB, 4, 2), (64 * MIB, 6, 3),
    (64 * MIB, 8, 4), (64 * MIB, 64, 4), (22 * MIB, 8, 4), (SPLIT - 1, 64, 1), (700_000, 8, 1),
])
def test_the_piece_rule(monkeypatch, n, cores, pieces):
    monkeypatch.setattr(device.os, "cpu_count", lambda: cores)
    assert device.copy_pieces(n) == pieces


def test_other_layouts_and_dtypes_copy_as_tobytes(eight_cores):
    t = _tensor(SPLIT + 64).view(-1, 8)[:, ::2]  # not contiguous
    assert device.to_bytes(t) == t.numpy().tobytes()
    w = torch.arange(SPLIT // 4 + 3, dtype=torch.int32)
    assert device.to_bytes(w) == w.numpy().tobytes()


def test_a_tensor_off_the_cpu_is_refused():
    with pytest.raises(ValueError, match="CPU tensor"):
        device.to_bytes(torch.empty(4, dtype=torch.uint8, device="meta"))


def test_a_split_copy_records_one_range_on_the_calling_thread(eight_cores):
    t = _tensor(SPLIT + 5)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = device.d2h(t)
    ranges = [e for e in prof.events() if e.name.startswith(("copy.", "sync."))]
    assert [e.name for e in ranges] == ["copy.bytes"]
    assert got == t.numpy().tobytes() and device.copies["split"] == 1


def test_many_threads_copy_at_once(eight_cores):
    sources = [_tensor(SPLIT + i, seed=i) for i in range(4)]
    wants = [s.numpy().tobytes() for s in sources]
    threads_n, rounds, bad, errors = 12, 3, [], []

    def client(i):
        try:
            for r in range(rounds):
                j = (i + r) % len(sources)
                if device.to_bytes(sources[j]) != wants[j]:
                    bad.append((i, r))
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors and not bad
    assert device.copies == {"whole": 0, "split": threads_n * rounds, "pieces": 2 * threads_n * rounds}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("n", [3, 64 * MIB + 3])
def test_a_pinned_source_and_a_card_tensor(card, n):
    t = _tensor(n, seed=7)
    pinned = t.pin_memory()
    assert device.to_bytes(pinned) == t.numpy().tobytes()
    assert device.d2h(t.to(card)) == t.numpy().tobytes()
