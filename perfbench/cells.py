"""Finds everything of a cell by name, under a checkout's root.

``BENCHMARK.json`` lists the cells as (configuration, traffic) pairs and
the metrics. The rest are files of their own, found by the names there:

- ``perfbench/configs/<config>.json`` (the ``file`` of its entry): the
  entry point (``entry``), its arguments and the cards it needs;
- ``perfbench/entries/<entry>.py``: the calls into the program and the
  check of their answers against the reference;
- ``perfbench/traffic/<traffic>.json``: the mix, a data file read by
  ``perfbench/generate.py``, which makes its inputs by the request
  generator ``perfbench/requests/<kind>.py`` that the mix names;
- ``perfbench/loops/<loop>.py``: how the mix's clients send requests;
- ``perfbench/metrics/<metric>.py``: a reader with ``read(ctx)``, which
  returns the metric's value or None when it finds nothing to read.

So a configuration, a mix, a kind of request, a loop or a metric is
added by adding its file and its entry in ``BENCHMARK.json``, with no
edit to a file here.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_module(path: Path, name: str):
    """The module in the file ``path``, under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic_path: Path
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path

    def entry(self):
        """The entry module named by the configuration."""
        return load_module(self.root / "perfbench" / "entries" / f"{self.config['entry']}.py",
                           f"perfbench_entry_{self.config['entry']}")

    def loop(self, name: str):
        """The loop ``name``, which runs a phase's clients."""
        return load_module(self.root / "perfbench" / "loops" / f"{name}.py", f"perfbench_loop_{name}")

    def reader(self, metric: str):
        """The reader of ``metric``."""
        return load_module(self.root / "perfbench" / "metrics" / f"{metric}.py", f"perfbench_metric_{metric}")


def find(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; KeyError when it lists none."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}; it has {sorted(workloads)}")
    w = workloads[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    spec = json.loads((root / config["file"]).read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, w, spec, root / "perfbench" / "traffic" / f"{w['traffic']}.json", e2e, per_layer, root)
