"""Nothing the benchmark runs imports JAX or the JAX package, by top-level names compared whole."""

import subprocess
import sys

from perfbench import run
from perfbench.cells import ROOT


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "raisin_tpu_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "raisin_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "flax", object())
    assert set(run.forbidden_modules()) - before == {"raisin_tpu", "flax"}


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_the_harness_and_the_program_load_no_jax():
    loaded = _loaded_after("import perfbench.run, perfbench.cells, perfbench.generate, perfbench.clients, "
                           "perfbench.profile, perfbench.stats, perfbench.readers, perfbench.work\n"
                           "from perfbench import cells\n"
                           "for name in ('rsnb-lzss-arith.text', 'stream-lzss-arith.canterbury'):\n"
                           "    cells.find(name).entry().Entry(cells.find(name).config, 'cpu')")
    assert "raisin_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import perfbench.reference, perfbench.reference.lzss, perfbench.reference.arithmetic, "
                           "perfbench.reference.rsnb")
    assert not loaded & ({"raisin_tpu_torch"} | set(run.FORBIDDEN))
