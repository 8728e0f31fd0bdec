"""The arithmetic of rates, tails and idle shares, on synthetic windows and traces."""

import pytest

from perfbench import readers, stats
from perfbench.clients import Call, Phase
from perfbench.profile import PHASE_RANGE, Trace
from perfbench.run import Context


def _phase(latencies, stall=0.0, nbytes=1_000_000):
    """Two clients, back to back calls of the given latencies; ``stall`` seconds added to the third."""
    calls, at = [], [0.0, 0.0]
    for k, lat in enumerate(latencies):
        c = k % 2
        lat += stall if k == 2 else 0.0
        calls.append(Call(c, 0, at[c], at[c] + lat, nbytes, True))
        at[c] += lat
    return Phase("compress", 0.0, max(x.end for x in calls), calls=calls)


def _ctx(phase):
    return Context({}, 1.0, {"compress": phase}, {})


def test_rate_and_tail_move_with_a_stall():
    lat = [0.1] * 40
    calm, stalled = _ctx(_phase(lat)), _ctx(_phase(lat, stall=0.5))
    assert readers.rate_MBps(calm, "compress") == pytest.approx(40 / 2.0)
    assert readers.rate_MBps(stalled, "compress") < readers.rate_MBps(calm, "compress")
    assert readers.tail_ms(calm, "compress") == pytest.approx(100.0)
    assert readers.tail_ms(stalled, "compress", q=1.0) == pytest.approx(600.0)
    # the 95th percentile of 40 calls is the 38th: one stalled call of 40 does not move it, three do
    three = _phase([0.1] * 37 + [0.7] * 3)
    assert readers.tail_ms(_ctx(three), "compress") == pytest.approx(700.0)


def test_failed_calls_count_no_bytes():
    phase = _phase([0.1] * 4)
    phase.calls[0].ok = False
    assert readers.rate_MBps(_ctx(phase), "compress") == pytest.approx(3 / 0.2)


def test_tail_is_nearest_rank():
    assert stats.tail(list(range(1, 101))) == 95
    assert stats.tail([5.0]) == 5.0
    assert stats.tail([]) is None


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6)]
    assert stats.union_s(iv) == 4
    assert stats.union_s(iv, 1, 5.5) == 2.5
    assert stats.gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert stats.idle_pct(2.0, 8.0) == 75.0


def _trace():
    """A 10 s window: kernels busy 0-2 and 4-5 s on one card, two threads' ranges."""
    s = 1_000_000_000
    t = Trace()
    t.ranges = [(PHASE_RANGE, 0, 10 * s, 9), ("rsnb.decompress", 0, 6 * s, 1), ("rsnb.dec.walk", 1 * s, 2 * s, 1),
                ("rsnb.dec.d2h", 4 * s, 5 * s, 1), ("stream.enc.expand", 3 * s, 4 * s, 2)]
    t.ops = {1: (int(1.5 * s), 1), 2: (int(3.5 * s), 2)}
    t.device = [("lzss_match_kernel<4>(int*)", 0, 2 * s, 0, 1), ("Memcpy HtoD (Pageable -> Device)", 4 * s, 5 * s, 0, 2)]
    return t


def test_trace_reductions():
    t = _trace()
    assert t.window_s() == 10
    assert t.busy_s() == 3
    assert stats.idle_pct(t.busy_s(), t.window_s()) == 70
    assert t.device_seconds("lzss_match_kernel") == 2
    assert t.device_seconds("Memcpy HtoD", "Memcpy DtoH") == 1
    assert t.launched_under_s("rsnb.dec.walk") == 2
    assert t.launched_under_s("stream.enc.expand") == 1
    assert t.self_s("rsnb.decompress") == 4  # 6 s less the two nested seconds
    gaps = t.idle_gaps()
    # 2-4 s: at its middle each thread is in a range, a second to each; 5-10 s: at 7.5 s in none
    assert gaps == pytest.approx({"rsnb.decompress": 1.0, "stream.enc.expand": 1.0,
                                  "(outside the program's ranges)": 5.0})
    assert t.by_kernel() == {"lzss_match_kernel": 2.0, "Memcpy_HtoD": 1.0}
