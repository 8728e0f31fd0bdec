"""The one traffic generator: reads a mix's data file, ``perfbench/traffic/<name>.json``, and a seed.

A mix file holds only parameters:

- ``clients``: how many clients send requests, one host thread each;
- ``loop``: how they send them, the loop ``perfbench/loops/<loop>.py``
  (``closed``: a client sends its next request when the last one has
  returned);
- ``phases``: the directions in turn, each with its ``share`` of the
  window (``compress``, then ``decompress`` of what the compress phase
  made);
- ``requests``: what a request's input is. ``kind`` names the request
  generator ``perfbench/requests/<kind>.py``; the other keys are its
  parameters;
- ``order``: ``cycle`` (each client repeats its items) or ``shuffle`` (a
  new order of them every pass);
- ``check``: ``{"kept": 2}`` keeps each input's first answer and a seeded
  sample of at most 2 more a client and phase for the check, ``{"kept":
  "all"}`` every answer.

A request generator has ``make(seed, requests, clients)``, which returns
the inputs and each client's list of them (indices into the inputs). So a
mix of a new shape is added as its generator's file and its data file,
and a new way of sending as a loop's file, with no edit here.

Everything comes from ``seed`` (any integer): the same seed gives the same
inputs and orders, and each seed has the same sizes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


def rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one use of one seed."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), *keys]))


def sub_seed(seed: int, *keys: int) -> int:
    """A seed for one use of one seed, for generators that take an integer."""
    return int(np.random.SeedSequence([seed % (1 << 64), *keys]).generate_state(1)[0])


@dataclass
class Traffic:
    seed: int
    clients: int
    loop: str
    phases: list[dict]
    order: str
    check: dict
    spec: dict  # the whole mix file, for a loop's or a generator's own keys
    items: list[bytes]
    owned: list[list[int]]  # each client's items

    def schedule(self, client: int):
        """The items that ``client`` sends, in order, without end."""
        own = self.owned[client]
        r = rng(self.seed, 5, client)
        while True:
            yield from (own if self.order == "cycle" else [own[i] for i in r.permutation(len(own))])


def load(path: Path, seed: int, root: Path | None = None) -> Traffic:
    """The mix in the data file ``path``, its inputs made from ``seed`` by the generator it names under
    the checkout ``root`` (this one by default)."""
    from perfbench import cells

    spec = json.loads(Path(path).read_text())
    kind = spec["requests"]["kind"]
    maker = cells.load_module((root or cells.ROOT) / "perfbench" / "requests" / f"{kind}.py",
                              f"perfbench_requests_{kind}")
    items, owned = maker.make(seed, spec["requests"], spec["clients"])
    return Traffic(seed, spec["clients"], spec.get("loop", "closed"), spec["phases"], spec.get("order", "cycle"),
                   spec.get("check", {}), spec, items, owned)
