"""scripts/ci_bench_torch.sh (the port's CI benchmark page) against scripts/ci_bench.sh (the JAX package's).

Both scripts run on the CPU at RAISIN_CI_SCALE=0.001 (every corpus file
about 1 KB), the port's with RAISIN_CI_DEVICE=cpu (the kernels' plain
versions). The JAX script passes the single algorithms as bare strings,
which its ``benchmark_suite`` splits into letters ("l,z,s,s", a failed
row; ROADMAP Queue 3); the port's passes lists. So the port's rows must
equal, in order and apart from ``time_taken``, the JAX ``benchmark_suite``
over the same list as lists, on the same files; and every row of the JAX
script that names a real pipeline must be among them. Tolerance 0: the
rows hold byte counts, flags and ratios computed from them.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
from pathlib import Path

import pytest

from raisin_tpu.engine.benchmark import benchmark_suite as jax_suite
from raisin_tpu.utils import corpus as jax_corpus
from raisin_tpu_torch.engine.benchmark import CI_ALGORITHMS
from tests import go_heap
from tests.go_heap import jax_heap_at_go_rule  # noqa: F401  (a fixture)

# the JAX oracle builds Go's Huffman tree here, as the port does (tests/go_heap.py)
pytestmark = pytest.mark.usefixtures("jax_heap_at_go_rule")

REPO = Path(__file__).resolve().parent.parent
SCALE = "0.001"
FILES = 11  # the corpus' files; each contributes one row an algorithm


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    """(JAX script's output directory, the port's), both written on the CPU; the JAX script's process
    builds Go's Huffman tree (``tests/go_heap.py``)."""
    out = tmp_path_factory.mktemp("ci_pages")
    env = {**os.environ, "RAISIN_CI_SCALE": SCALE, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    site = out / "go_heap_site"
    site.mkdir()
    subprocess.run(["sh", str(REPO / "scripts" / "ci_bench.sh"), str(out / "jax")],
                   env={**env, "PYTHONPATH": go_heap.sitecustomize(site, REPO)}, check=True, capture_output=True)
    subprocess.run(["sh", str(REPO / "scripts" / "ci_bench_torch.sh"), str(out / "port")],
                   env={**env, "RAISIN_CI_DEVICE": "cpu"}, check=True, capture_output=True)
    return out / "jax", out / "port"


def _rows(d: Path) -> list[dict]:
    return json.loads((d / "results.json").read_text())


def _untimed(rows: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "time_taken"} for r in rows]


def test_port_page_writes_the_jax_corpus(pages):
    jax, port = pages
    names = sorted(p.name for p in (jax / "corpus").iterdir())
    assert names == sorted(p.name for p in (port / "corpus").iterdir()) and len(names) == FILES
    for name in names:
        assert (port / "corpus" / name).read_bytes() == (jax / "corpus" / name).read_bytes(), name
    html = (port / "index.html").read_text()
    assert html.count("<table") == FILES and all(",".join(a) in html for a in CI_ALGORITHMS)


def test_port_rows_equal_jax_suite_over_lists(pages):
    jax, port = pages
    files = [str(jax / "corpus" / name) for name in jax_corpus.generate(float(SCALE))]  # write_corpus's order
    with contextlib.redirect_stdout(io.StringIO()):
        _, results = jax_suite(files, CI_ALGORITHMS)
    want = [{"engine": r.compression_engine, "compression_ratio": r.ratio, "entropy": r.entropy,
             "lossless": r.lossless, "failed": r.failed, "original_bytes": r.original_bytes,
             "compressed_bytes": r.compressed_bytes} for r in results]
    got = _untimed(_rows(port))
    assert len(got) == FILES * len(CI_ALGORITHMS)
    assert got == want


def test_port_rows_hold_the_jax_scripts_real_rows(pages):
    """The JAX script's rows for the list entries (and any real row) are the port's, file by file."""
    jax, port = pages
    per = len(CI_ALGORITHMS)
    got, want = _untimed(_rows(port)), _untimed(_rows(jax))
    real = 0
    for f in range(FILES):
        port_file = got[f * per : (f + 1) * per]
        for row in want[f * per : (f + 1) * per]:
            if row["engine"].replace(",", "") in {"".join(a) for a in CI_ALGORITHMS if len(a) == 1}:
                assert row["failed"]  # a bare string split into letters (ROADMAP Queue 3)
                continue
            assert row in port_file, row
            real += 1
    assert real == FILES * sum(len(a) > 1 for a in CI_ALGORITHMS)


def test_port_script_refuses_the_jax_sample_page():
    proc = subprocess.run(["sh", str(REPO / "scripts" / "ci_bench_torch.sh"), str(REPO / "docs" / "sample_benchmark")],
                          capture_output=True, text=True, env={**os.environ, "RAISIN_CI_DEVICE": "cpu"})
    assert proc.returncode == 1 and "sample_benchmark" in proc.stderr
