"""The traffic: the same for the same seed, different across seeds, the same sizes for every seed."""

import itertools
import json

from perfbench import cells, generate
from perfbench.cells import ROOT

text = cells.load_module(ROOT / "perfbench" / "requests" / "text_blocks.py", "perfbench_requests_text_blocks")


def _mix(tmp_path, **requests):
    spec = {"clients": 2, "loop": "closed", "phases": [{"direction": "compress", "share": 1.0}], "requests": requests,
            "order": "shuffle" if requests["kind"] == "canterbury_files" else "cycle"}
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(spec))
    return path


def _draw(path, seed, calls=30):
    t = generate.load(path, seed)
    return t.items, [list(itertools.islice(t.schedule(c), calls)) for c in range(t.clients)]


def test_each_mix_repeats_for_a_seed_and_changes_with_it(tmp_path):
    for requests in ({"kind": "text_blocks", "bytes": 20000, "block": 4096, "source_bytes": 8192},
                     {"kind": "uniform_bytes", "bytes": 5000},
                     {"kind": "canterbury_files", "scale": 0.01}):
        path = _mix(tmp_path, **requests)
        seed = 2**31 + 12345  # past 32 signed bits
        items, order = _draw(path, seed)
        assert (items, order) == _draw(path, seed)
        other_items, other_order = _draw(path, seed + 1)
        assert other_items != items
        assert [len(b) for b in other_items] == [len(b) for b in items]
        if requests["kind"] == "canterbury_files":
            assert other_order != order and sorted(other_order[0][:11]) == list(range(11))


def test_text_blocks_hold_each_class_equally_often():
    sources = text.text_sources(7, 8192)
    data = text.text_blocks(7, 0, 14 * 1024, 1024, sources)
    starts = [bytes(data[i : i + 1024]) for i in range(0, len(data), 1024)]
    owner = [next(k for k, s in enumerate(sources) if bytes(s).find(b) >= 0) for b in starts]
    assert sorted(owner) == sorted(list(range(7)) * 2)


def test_the_benchmark_mixes_load():
    for name in ("text", "incompressible", "canterbury"):
        spec = json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())
        assert sum(p["share"] for p in spec["phases"]) == 1.0
