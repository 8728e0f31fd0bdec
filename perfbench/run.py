"""The benchmark of raisin_tpu_torch: one cell of ``BENCHMARK.json`` a run.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. A run loads the cell (``perfbench/cells.py``), makes its inputs from
the seed (``perfbench/generate.py``), warms every shape that the cell's
traffic uses once, then runs each phase of the mix (compress, then
decompress) for its share of ``--seconds`` under the mix's loop
(``perfbench/loops/<loop>.py``: closed-loop clients, one host thread
each). Once the window has closed
and the peak device memory has been read, the entry's check compares the
answers with the benchmark's own reference (``perfbench/reference/``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, from a torch.profiler session a
phase), ``device`` and, last, ``checks``: each number compared with its
limit, which also end standard error.

``setup_s`` runs from the start of this module to the start of the
window: the imports, the kernels' load (their build on a checkout's first
run, into ``raisin_tpu_torch/_build/``), the inputs and the warm-up. A
checkout's first run also writes the bytecode of the modules it imports
under ``perfbench/_cache/pyc``, which later runs read.
A run exits with a code other than 0, and prints no result, without the
cards, or when JAX, flax or the JAX package (``raisin_tpu``) has been
imported by the time the window has closed.

``--control 1`` puts the control in the program's place for the check
(the reference with the arithmetic model's counts one bit narrower); no
run of the benchmark's own uses it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from perfbench import cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raisin_tpu")
TOP = 10  # entries of each list of the breakdown
KEEP_SHARE = 0.2  # the chance that a call's answer is kept, while a client has room


@dataclass
class Context:
    """What a metric's reader reads."""

    config: dict
    setup_s: float
    phases: dict  # direction -> clients.Phase
    items: dict  # item -> its sizes (entry.check's stats)


def log(message: str, t0: float = T0) -> None:
    """A line of progress on standard error, with the seconds since the run began."""
    print(f"perfbench: {message} at {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that belong to JAX or the JAX package, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs(root) -> None:
    """Every compiler cache that the run might use, at a fixed path inside the checkout: the program's
    kernel caches, and Python's bytecode of every module imported from here on (torch's installation
    may hold none, and the environment may forbid writing it beside the sources, so that each process
    would compile torch's modules anew)."""
    cache = root / "perfbench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.pycache_prefix = str(cache / "pyc")
    sys.dont_write_bytecode = False


class Keeper:
    """Which answers the check sees: each item's first, and a seeded sample of the rest (``kept`` a
    client, each call with chance KEEP_SHARE), or every answer with ``kept: "all"``."""

    def __init__(self, traffic, phase_index: int):
        from perfbench import generate

        self.all = traffic.check.get("kept") == "all"
        self.room = [0 if self.all else traffic.check.get("kept", 2)] * traffic.clients
        self.draws = [generate.rng(traffic.seed, 8, phase_index, c) for c in range(traffic.clients)]
        self.kept: list[tuple[int, bytes]] = []
        self.first: dict[int, bytes] = {}
        self.lock = threading.Lock()

    def keep(self, client: int, item: int, out) -> None:
        if out is None:
            return
        with self.lock:
            if item not in self.first:
                self.first[item] = out
                self.kept.append((item, out))
            elif self.all or (self.room[client] and self.draws[client].random() < KEEP_SHARE):
                self.room[client] -= 1
                self.kept.append((item, out))


def warm(fn, traffic, inputs) -> tuple[dict[int, bytes], int]:
    """Each client calls ``fn`` once on each of its items, all clients at once; -> (an answer an
    item, the calls that failed)."""
    made: dict[int, bytes] = {}
    failed = []

    def client(c: int) -> None:
        for item in dict.fromkeys(traffic.owned[c]):
            try:
                made[item] = fn(inputs(item))
            except Exception:  # counted as a failure of the run, like a failed call in the window
                traceback.print_exc(file=sys.stderr)
                failed.append(item)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(traffic.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return made, len(failed)


def breakdown(traces) -> dict:
    ops: dict[str, float] = {}
    idle: dict[str, float] = {}
    for t in traces:
        for k, v in t.by_kernel().items():
            ops[k] = ops.get(k, 0.0) + v
        for k, v in t.idle_gaps().items():
            idle[k] = idle.get(k, 0.0) + v
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device, control: bool = False,
             t0: float = T0) -> dict:
    """One run of ``cell``; -> the result's fields, ``checks`` last."""
    import torch
    from torch.profiler import record_function

    from perfbench import generate, profile

    cards = cell.workload["chips"]
    if torch.device(device).type == "cuda":
        torch.zeros(1, device=device)  # the CUDA context
        log("CUDA context made", t0)
    entry = cell.entry().Entry(cell.config, device)
    log("program loaded", t0)
    traffic = generate.load(cell.traffic_path, seed, cell.root)
    loop = cell.loop(traffic.loop)
    sizes = [len(b) for b in traffic.items]
    log("inputs made", t0)
    made: dict[int, bytes] = {}
    warm_failed = 0
    for ph in traffic.phases:
        d = ph["direction"]
        answers, failed = warm(entry.directions[d], traffic,
                               lambda i, d=d: entry.phase_input(d, i, traffic.items, made))
        warm_failed += failed
        if d == "compress":
            made = answers
    del answers
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log("warm-up done, the window opens", t0)

    phases, kept = {}, {}
    for k, ph in enumerate(traffic.phases):
        d = ph["direction"]
        keeper = Keeper(traffic, k)
        session = profile.Session(cards) if trace else None
        if session:
            session.start()
        phase = loop.run(d, entry.directions[d], lambda i, d=d: entry.phase_input(d, i, traffic.items, made),
                         traffic, sizes, seconds * ph["share"], keeper.keep,
                         record_function(profile.PHASE_RANGE) if trace else contextlib.nullcontext())
        if session:
            phase.trace = session.stop()
        phases[d], kept[d] = phase, keeper.kept
        if d == "compress":
            made = {**made, **keeper.first}

    on_card = torch.cuda.is_available() and torch.device(device).type == "cuda"
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(cards)) if on_card else 0
    del made
    if on_card:
        torch.cuda.empty_cache()  # the program's cached device memory, before the reference runs
    log("the window has closed", t0)
    numbers, items = entry.check(traffic, kept, device, control)
    log("the check is done", t0)
    calls = [c for p in phases.values() for c in p.calls]
    failed = sum(not c.ok for c in calls)
    numbers["calls_failed"] = (failed, 0)
    numbers["warm_up_calls_failed"] = (warm_failed, 0)
    ctx = Context(cell.config, setup_s, phases, items)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if on_card else torch.device(device).type,
           "count": cards, "memory_peak_bytes": peak}
    result = {"correct": all(v <= limit for v, limit in numbers.values()), "attempted": len(calls),
              "failed": failed, "metrics": metrics, "device": dev}
    log("metrics read", t0)
    if trace:
        traces = [p.trace for p in phases.values()]
        dev["busy_s"] = sum(t.busy_s() for t in traces)
        dev["window_s"] = sum(t.window_s() for t in traces)
        result["breakdown"] = breakdown(traces)
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in numbers.items()}
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    set_cache_dirs(cells.ROOT)
    cell = cells.find(args.workload)
    import torch

    log("torch imported")
    cards = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        print(f"perfbench: the cell asks for {cards} card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}, which no run may import", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
