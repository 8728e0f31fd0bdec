"""The reference equals the program's host oracles on small inputs (the format's edge cases)."""

import numpy as np
import pytest

from perfbench import corpus
from perfbench.reference import arithmetic, compress_pipeline, lzss, rsnb

rng = np.random.default_rng(3)
CASES = [b"", b"a", b"<<<\\\\\xff\xff<\\", b"abcabcabcabcabcabcabcabc" * 40, bytes(rng.integers(0, 256, 3000, dtype=np.uint8)),
         corpus._prose(3000, 3), corpus._html(2000, 4) + corpus._man(1000, 5), bytes(3000), corpus._xls(4000, 2),
         b"ab" * 1500]


def test_lzss_equals_the_oracle():
    oracle = pytest.importorskip("raisin_tpu_torch.formats.lzss")
    for window in (4096, 100, 7, 2, 1):
        for data, got in zip(CASES, lzss.compress_many(CASES, window, "cpu")):
            assert got == oracle.compress(data, window), (window, len(data))


def test_arithmetic_equals_the_oracle_past_the_model_freeze():
    oracle = pytest.importorskip("raisin_tpu_torch.formats.arithmetic")
    long = bytes(rng.integers(0, 40, 20000, dtype=np.uint8))  # past the 16126 steps of the adaptive model
    for data in CASES + [long, corpus._fax(18000, 1)]:
        assert arithmetic.compress(data) == oracle.compress(data), len(data)


def test_the_control_differs_only_past_its_narrower_model():
    short, long = CASES[5], corpus._prose(9000, 8)
    assert arithmetic.compress(short, arithmetic.CONTROL_MAX_FREQ) == arithmetic.compress(short)
    assert arithmetic.compress(long, arithmetic.CONTROL_MAX_FREQ) != arithmetic.compress(long)


def test_pipeline_and_framing():
    streams, lengths = compress_pipeline(CASES[3:6], ("lzss", "arithmetic"), 4096, "cpu")
    assert lengths[0] == [len(s) for s in lzss.compress_many(CASES[3:6], 4096, "cpu")]
    assert streams == [arithmetic.compress(s) for s in lzss.compress_many(CASES[3:6], 4096, "cpu")]
    blob = rsnb.header(("lzss", "arithmetic"), 4096, 4096, 9000, [len(s) for s in streams], [lengths[0]])
    blob += b"".join(streams)
    f = rsnb.parse(blob)
    assert (f["num_blocks"], f["orig_size"], int(f["offsets"][-1])) == (3, 9000, len(blob))
    assert [rsnb.payload(blob, f, b) for b in range(3)] == streams
    assert f["aux"][0].tolist() == lengths[0]
