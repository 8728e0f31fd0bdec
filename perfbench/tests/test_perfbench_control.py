"""The control (the reference with the arithmetic model's counts one bit narrower) fails the check.

On the CPU at a size a test holds, with answers that the reference
itself makes: sound answers pass, the control's fail. On the card
(``-m card``), at each cell's own size: ``--control 1`` runs of three
seeds each come out not correct.
"""

import json
import subprocess
import sys

import pytest

from perfbench import cells, generate
from perfbench.reference import compress_pipeline, rsnb
from perfbench.cells import ROOT


def _traffic(tmp_path, requests, check):
    spec = {"clients": 1, "loop": "closed", "phases": [{"direction": "compress", "share": 1.0}], "requests": requests,
            "order": "cycle", "check": check}
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(spec))
    return generate.load(path, 2**31 + 99)


def _checker(name, **config):
    cell = cells.find(name)
    entry = cell.entry().Entry.__new__(cell.entry().Entry)  # the check alone: no program
    for k, v in {**cell.config, **config}.items():
        setattr(entry, k, tuple(v) if k == "algorithms" else v)
    return entry


def test_container_control_fails_where_sound_answers_pass(tmp_path):
    entry = _checker("rsnb-lzss-arith.text", block_size=9000)
    traffic = _traffic(tmp_path, {"kind": "text_blocks", "bytes": 18000, "block": 9000, "source_bytes": 20000},
                       {"kept": 1})
    data = traffic.items[0]
    blocks = [data[i : i + 9000] for i in range(0, len(data), 9000)]
    streams, lengths = compress_pipeline(blocks, entry.algorithms, entry.window, "cpu")
    blob = rsnb.header(entry.algorithms, 9000, entry.window, len(data), [len(s) for s in streams], [lengths[0]])
    kept = {"compress": [(0, blob + b"".join(streams))], "decompress": [(0, data)]}
    sound, _ = entry.check(traffic, kept, "cpu")
    control, _ = entry.check(traffic, kept, "cpu", control=True)
    assert all(v == 0 for v, _ in sound.values())
    assert control["sampled_blocks_differing"][0] == 2 > control["sampled_blocks_differing"][1]


def test_stream_control_fails_where_sound_answers_pass(tmp_path):
    entry = _checker("stream-lzss-arith.canterbury")
    traffic = _traffic(tmp_path, {"kind": "canterbury_files", "scale": 0.02}, {"kept": "all"})
    streams, _ = compress_pipeline(traffic.items, entry.algorithms, entry.window, "cpu")
    kept = {"compress": list(enumerate(streams))}
    assert entry.check(traffic, kept, "cpu")[0]["streams_differing"][0] == 0
    # the files past the control's adaptive steps (lcet10.txt, plrabn12.txt, ptt5, kennedy.xls) differ
    assert entry.check(traffic, kept, "cpu", control=True)[0]["streams_differing"][0] >= 1


@pytest.mark.card
@pytest.mark.parametrize("workload", ["rsnb-lzss-arith.text", "rsnb-lzss-arith.incompressible",
                                      "stream-lzss-arith.canterbury"])
def test_control_at_the_cells_size_is_not_correct(card, workload):
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", workload, "--seed", str(seed),
                              "--seconds", "4", "--trace", "0", "--control", "1"],
                             cwd=ROOT, capture_output=True, text=True, timeout=360)
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        print(workload, seed, json.dumps(result["checks"]))
        assert result["correct"] is False
