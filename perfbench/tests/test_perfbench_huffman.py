"""The reference's Huffman layer (``perfbench/reference/huffman.py``) and its control.

On the CPU: the layer against the program's copy of the format, the
control's clipping, and the check of the cell ``rsnb-lzss-huffman.text``,
which passes sound answers and fails the control. On the card (``-m
card``), at the cell's own size: ``--control 1`` runs of three seeds come
out not correct.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

from perfbench import cells, corpus, generate, run
from perfbench.cells import ROOT
from perfbench.reference import compress_pipeline, rsnb
from perfbench.reference import huffman as ref
from perfbench.reference.arithmetic import CONTROL_MAX_FREQ

CELL = "rsnb-lzss-huffman.text"


def _checker(**config):
    cell = cells.find(CELL)
    entry = cell.entry().Entry.__new__(cell.entry().Entry)  # the check alone: no program
    for k, v in {**cell.config, **config}.items():
        setattr(entry, k, tuple(v) if k == "algorithms" else v)
    return entry


def _sound_and_control(entry, data: bytes, block: int):
    """The check's numbers for the reference's own container of ``data``, then for the control's,
    and the input's stats."""
    seed = 2**31 + 99
    traffic = generate.Traffic(seed, 1, "closed", [{"direction": "compress", "share": 1.0}], "cycle", {"kept": 1},
                               {}, [data], [[0]])
    blocks = [data[i : i + block] for i in range(0, len(data), block)]
    streams, lengths = compress_pipeline(blocks, entry.algorithms, entry.window, "cpu")
    blob = rsnb.header(entry.algorithms, block, entry.window, len(data), [len(s) for s in streams], [lengths[0]])
    kept = {"compress": [(0, blob + b"".join(streams))], "decompress": [(0, data)]}
    sound, stats = entry.check(traffic, kept, "cpu")
    control, _ = entry.check(traffic, kept, "cpu", control=True)
    return sound, control, stats, lengths


def test_reference_equals_the_programs_format_copy():
    oracle = pytest.importorskip("raisin_tpu_torch.formats.huffman")
    rng = np.random.default_rng(4)
    cases = [b"a", b"aab", b"\n\n\nx", bytes(rng.integers(0, 256, 3000, dtype=np.uint8)), corpus._prose(3000, 3),
             corpus._html(2000, 4), "naïve € 中 😀".encode() + b"\xe2\x28\xa1\xf0\x28\x8c\x28\xc3"]
    for data in cases:
        assert ref.compress(data) == oracle.compress_block(data), data[:20]
    assert ref.codes([97, 98, 99], [1, 1, 5]) == {97: "00", 98: "01", 99: "1"}  # Go's heap stops at the root


def test_valid_utf8_is_coded_as_go_and_the_rest_over_its_bytes():
    """Go's runes where the input is valid UTF-8; elsewhere the bytes, each written into the header as
    itself, where Go would write U+FFFD for each stray one."""
    text = "naïve € 中 😀 \ufffd".encode()
    head = ref.compress(text).split(ref.SEPARATOR)[0]
    assert "€".encode() in head and "\ufffd".encode() in head
    stray = b"x<y\xffz\xff\xc3"
    head = ref.compress(stray).split(ref.SEPARATOR)[0]
    assert head == b"1|<1|x1|y1|z1|\xc32|\xff"  # ascending byte order
    assert "\ufffd".encode() not in head


def test_control_clips_the_counts_past_its_bound():
    short, long = corpus._prose(3000, 3), corpus._prose(60000, 8)  # the space: ~550 and ~11,000 times
    assert ref.compress(short, CONTROL_MAX_FREQ) == ref.compress(short)
    clipped = ref.compress(long, CONTROL_MAX_FREQ)
    assert clipped != ref.compress(long) and b"%d| " % CONTROL_MAX_FREQ in clipped.split(ref.SEPARATOR)[0]


def test_huffman_control_fails_where_sound_answers_pass():
    """Blocks of 45,000 bytes of prose: the space passes 8191 in each block's token stream."""
    entry = _checker(block_size=45000)
    assert entry.algorithms == ("lzss", "huffman") and entry.aux_tables == 1
    data = corpus._prose(90000, generate.sub_seed(2**31 + 99, 1, 0))
    sound, control, stats, lengths = _sound_and_control(entry, data, 45000)
    assert all(v == 0 for v, _ in sound.values())
    assert stats[0]["tokens"] == sum(lengths[0]) and stats[0]["blocks"] == 2
    assert control["sampled_blocks_differing"][0] == 2 > control["sampled_blocks_differing"][1]


def test_huffman_check_passes_byte_coded_blocks():
    """Blocks of html and C with '<', which the LZSS escape writes as 0xFF: their streams are coded over
    their bytes, and the reference's own container passes."""
    entry = _checker(block_size=12000)
    data = corpus._html(12000, 5) + corpus._csrc(12000, 6)
    sound, _, _, _ = _sound_and_control(entry, data, 12000)
    assert all(v == 0 for v, _ in sound.values())
    streams, _ = compress_pipeline([data[:12000]], entry.algorithms, entry.window, "cpu")
    assert b"|\xff" in streams[0].split(ref.SEPARATOR)[0]


def test_the_layer_imports_nothing_of_the_program():
    code = "import perfbench.reference.huffman, sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert not set(out.stdout.split()) & ({"raisin_tpu_torch"} | set(run.FORBIDDEN))


@pytest.mark.card
def test_control_at_the_cells_size_is_not_correct(card):
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", CELL, "--seed", str(seed),
                              "--seconds", "4", "--trace", "0", "--control", "1"],
                             cwd=ROOT, capture_output=True, text=True, timeout=360)
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        print(CELL, seed, json.dumps(result["checks"]))
        assert result["correct"] is False
