"""A configuration, a traffic mix, a kind of request, a loop and a metric are added as files and
entries, with no edit to a file that is there."""

import json
import shutil

from perfbench import cells, generate, run
from perfbench.cells import ROOT

REQUESTS = '''"""Requests of one repeated phrase, ``bytes`` long, one input a client."""

PHRASE = b"the quick brown fox jumps over the lazy dog. "


def make(seed, requests, clients):
    items = [(PHRASE * (requests["bytes"] // len(PHRASE) + 1))[: requests["bytes"] - c] for c in range(clients)]
    return items, [[c] for c in range(clients)]
'''

LOOP = '''"""The clients in turn, one call at a time, from one thread."""

import itertools
import time

from perfbench.clients import Call, Phase


def run(direction, fn, inputs, traffic, sizes, seconds, keep, span):
    schedules = [traffic.schedule(c) for c in range(traffic.clients)]
    phase = Phase(direction, time.perf_counter(), 0.0)
    phase.deadline = phase.start + seconds
    with span:
        for c in itertools.cycle(range(traffic.clients)):
            item, start = next(schedules[c]), time.perf_counter()
            if start >= phase.deadline:
                break
            out = fn(inputs(item))
            phase.calls.append(Call(c, item, start, time.perf_counter(), sizes[item], True))
            keep(c, item, out)
    phase.end = max((x.end for x in phase.calls), default=phase.start)
    return phase
'''


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}

    pb = tmp_path / "perfbench"
    config = json.loads((pb / "configs" / "rsnb-lzss-arith-w4096.json").read_text())
    config.update(name="rsnb-lzss-arith-w1024", window=1024, block_size=2048)
    (pb / "configs" / "rsnb-lzss-arith-w1024.json").write_text(json.dumps(config))
    (pb / "requests" / "phrase.py").write_text(REQUESTS)
    (pb / "loops" / "in_turn.py").write_text(LOOP)
    mix = json.loads((pb / "traffic" / "text.json").read_text())
    mix.update(clients=3, loop="in_turn", requests={"kind": "phrase", "bytes": 5000}, check={"kept": 1})
    (pb / "traffic" / "phrase3.json").write_text(json.dumps(mix))
    (pb / "metrics" / "calls.compress.py").write_text(
        "from perfbench import readers\n\n\ndef read(ctx):\n    return len(readers.calls(ctx, 'compress')) or None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "rsnb-lzss-arith-w1024",
                             "file": "perfbench/configs/rsnb-lzss-arith-w1024.json"})
    bench["workloads"].append({"name": "rsnb-lzss-arith-w1024.phrase3", "config": "rsnb-lzss-arith-w1024",
                               "traffic": "phrase3", "chips": 1, "why": "three clients in turn"})
    bench["per_layer"].append({"name": "calls.compress", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "engine", "moves": "compress_MBps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.find("rsnb-lzss-arith-w1024.phrase3", root=tmp_path)
    assert cell.config["window"] == 1024
    traffic = generate.load(cell.traffic_path, 2**31 + 7, tmp_path)
    assert [len(b) for b in traffic.items] == [5000, 4999, 4998] and traffic.loop == "in_turn"
    assert "calls.compress" in [m["name"] for m in cell.per_layer]
    assert "compress_MBps" in [m["name"] for m in cell.end_to_end]
    assert "decompress_MBps" not in [m["name"] for m in cell.end_to_end]  # listed for other cells only
    # a metric without a workloads list reaches every cell that reports what it moves
    assert "calls.compress" in [m["name"] for m in cells.find("rsnb-lzss-arith.text", root=tmp_path).per_layer]

    # the new cell runs end to end on the CPU, through the new loop and the new kind of request
    result = run.run_cell(cell, 2**31 + 7, 0.4, True, "cpu")
    assert result["correct"], result["checks"]
    assert 0 < result["metrics"]["calls.compress"]["value"] < result["attempted"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_listed_name_has_its_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.find(w["name"])
        traffic = json.loads(cell.traffic_path.read_text())
        assert (ROOT / "perfbench" / "requests" / f"{traffic['requests']['kind']}.py").exists()
        assert callable(cell.loop(traffic["loop"]).run)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
