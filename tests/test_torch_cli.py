"""The port's `raisin`/`grape` command line against the JAX package's, file for file.

``raisin_tpu_torch.cli.main(argv, device="cpu")`` runs the kernels' plain
versions and the native C copy; ``raisin_tpu.cli.main(argv)`` runs on CPU
JAX. Each command runs once per CLI in a directory of its own holding the
same inputs: the exit codes, the messages and every file left behind must
be equal (tolerance 0: the outputs are bytes), and each CLI must decode
what the other wrote. The benchmark table must hold the same rows but for
the time column. Modelled on tests/test_cli.py.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
from pathlib import Path

import pytest
import torch

import raisin_tpu
import raisin_tpu.native
from raisin_tpu import cli as jax_cli
from raisin_tpu.engine import registry as jax_registry
from raisin_tpu.parallel import blocks as jax_blocks
from raisin_tpu_torch import cli as port_cli
from raisin_tpu_torch.engine import registry as port_registry
from tests.fixtures import VERSE, random_text
from tests.go_heap import jax_heap_at_go_rule  # noqa: F401  (a fixture)

# the JAX oracle builds Go's Huffman tree here, as the port does (tests/go_heap.py)
pytestmark = pytest.mark.usefixtures("jax_heap_at_go_rule")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MAINS = {"jax": jax_cli.main, "port": functools.partial(port_cli.main, device="cpu")}
TEXT = VERSE + b" \\ < > , " + random_text(600, seed=70)


@pytest.fixture(scope="module", autouse=True)
def _own_native_cache(tmp_path_factory):
    """Builds of the JAX package's native library go to this module's directory."""
    patch = pytest.MonkeyPatch()
    patch.setattr(raisin_tpu.native, "_CACHE", str(tmp_path_factory.mktemp("native")))
    yield
    patch.undo()


@pytest.fixture(autouse=True)
def _auto_backends(monkeypatch):
    """``-backend`` sets each package's preferred backend for the process; every test starts at auto."""
    monkeypatch.setattr(jax_registry, "_preferred_backend", "auto")
    monkeypatch.setattr(port_registry, "_preferred_backend", "auto")


def _run(tag: str, tmp_path: Path, files: dict[str, bytes], argv: list[str], capsys):
    """Run one CLI in ``tmp_path/tag`` on ``files`` -> (exit code, stdout, files left behind)."""
    d = tmp_path / tag
    d.mkdir()
    for name, data in files.items():
        (d / name).write_bytes(data)
    rc = MAINS[tag]([a.replace("{d}", str(d)) for a in argv])
    out = capsys.readouterr().out.replace(str(d), "{d}")
    return rc, out, {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _both(tmp_path, files, argv, capsys):
    jax = _run("jax", tmp_path, files, argv, capsys)
    port = _run("port", tmp_path, files, argv, capsys)
    assert port == jax
    return jax


INPUTS = {"a.txt": TEXT}
# id -> (inputs, compress argv, the -algorithm of its decode)
COMPRESS = {
    "default": (INPUTS, ["raisin", "{d}/a.txt"], "lzss,arithmetic"),
    "huffman": (INPUTS, ["raisin", "-compress", "{d}/a.txt", "-algorithm=huffman", "-out={d}/a.h"], "huffman"),
    "backend=host": (INPUTS, ["raisin", "{d}/a.txt", "-backend=host"], "lzss,arithmetic"),
    "backend=native": (INPUTS, ["raisin", "{d}/a.txt", "-backend", "native"], "lzss,arithmetic"),
    "backend=device": (INPUTS, ["raisin", "{d}/a.txt", "-backend=device"], "lzss,arithmetic"),
    "container": ({"a.txt": VERSE * 20}, ["raisin", "{d}/a.txt", "-container", "-blocksize=4096"], ""),
    "container gzip": ({"a.txt": VERSE * 8}, ["raisin", "{d}/a.txt", "-container", "-blocksize=4096",
                                              "-algorithm=gzip"], ""),
    "window": (INPUTS, ["raisin", "{d}/a.txt", "-window=2048"], "lzss,arithmetic"),
    "window past the card's": (INPUTS, ["raisin", "{d}/a.txt", "-window=70000"], "lzss,arithmetic"),
    "container window 16384": ({"a.txt": VERSE * 8}, ["raisin", "{d}/a.txt", "-container", "-blocksize=4096",
                                                      "-window=16384"], ""),
    "multi-file": ({"a.txt": TEXT, "b.txt": VERSE}, ["raisin", "{d}/a.txt,{d}/b.txt", "-algorithm=arithmetic",
                                                     "-outext=ar"], "arithmetic"),
}


@pytest.mark.parametrize("case", COMPRESS)
def test_compress_writes_the_jax_files(case, tmp_path, capsys):
    files, argv, algorithm = COMPRESS[case]
    rc, out, left = _both(tmp_path, files, argv, capsys)
    assert rc == 0 and "Compression ratio" in out
    written = sorted(set(left) - set(files))
    assert written
    # each CLI decodes what the other wrote
    for tag, other in (("jax", "port"), ("port", "jax")):
        for name in written:
            path = tmp_path / other / name
            source = next(f for f in files if name.startswith(f + ".") or name == "a.h")
            args = ["raisin", "-decompress", str(path), f"-out={path}.back", "-no-delete"]
            assert MAINS[tag](args + ([f"-algorithm={algorithm}"] if algorithm else [])) == 0
            assert Path(f"{path}.back").read_bytes() == files[source], (tag, name)


@pytest.mark.parametrize("algorithm", ["", "huffman"])
def test_grape_writes_the_jax_files(algorithm, tmp_path, capsys):
    flag = [f"-algorithm={algorithm}"] if algorithm else []
    stream = raisin_tpu.compress_bytes(TEXT, [algorithm] if algorithm else ["lzss", "arithmetic"])
    rc, out, left = _both(tmp_path, {"a.txt.rsn": stream}, ["grape", "{d}/a.txt.rsn", *flag], capsys)
    # grape deletes its input by default (cmd/cli.go:150)
    assert rc == 0 and out == "Decompressing...\n" and left == {"a.txt": TEXT}


def test_grape_keeps_and_names_outputs_like_jax(tmp_path, capsys):
    streams = {f"{n}.rsn": raisin_tpu.compress_bytes(d, ["arithmetic"]) for n, d in (("a", TEXT), ("b", VERSE))}
    rc, _, left = _both(tmp_path, streams, ["grape", "{d}/a.rsn,{d}/b.rsn", "-algorithm=arithmetic", "-outext=out",
                                             "-no-delete"], capsys)
    assert rc == 0 and left["a.rsn.out"] == TEXT and left["b.rsn.out"] == VERSE


@pytest.mark.parametrize(
    "argv",
    [
        ["raisin", "{d}/missing.txt"],
        ["raisin"],
        ["raisin", "-benchmark"],
        ["grape"],
        ["raisin", "-compress", "-decompress", "{d}/a.txt"],
        ["raisin", "{d}/a.txt", "-algorithm=bogus"],
        ["raisin", "-decompress", "{d}/a.txt", "-algorithm=lzss,bogus"],
        ["raisin", "{d}/a.txt", "-container", "-algorithm=bogus"],
    ],
    ids=["missing", "no file", "benchmark no file", "grape no file", "two commands", "bogus", "bogus decode",
         "bogus container"],
)
def test_errors_match_jax(argv, tmp_path, capsys):
    rc, out, left = _both(tmp_path, INPUTS, argv, capsys)
    assert rc == 1 and left == INPUTS
    if "bogus" in argv[-1]:
        assert "Valid algorithms: all, suite, lzss, dmc" in out


def test_corrupt_stream_fails_like_jax(tmp_path, capsys):
    rc, out, _ = _both(tmp_path, {"a.rsn": b"\x00\x00\x00"}, ["grape", "{d}/a.rsn", "-algorithm=arithmetic"], capsys)
    assert rc == 1 and out.startswith("Decompressing...\ndecompression failed:")


@pytest.mark.parametrize("command", ["-compress", "-decompress"])
def test_several_devices_name_item_13(command, tmp_path, capsys, monkeypatch):
    """-devices=2 shards the container over two entries (the port's CPU entries, JAX's virtual
    devices) and writes the unsharded bytes; more devices than the machine has exit 1 and leave
    the files as they were. (The name dates from when the port refused -devices.)"""
    if command == "-compress":
        files, argv = INPUTS, ["raisin", "-compress", "-container", "{d}/a.txt"]
    else:
        c = jax_blocks.compress_container(TEXT, ("lzss", "arithmetic"), block_size=512)
        files, argv = {"a.rsn": c}, ["grape", "-decompress", "{d}/a.rsn"]
    monkeypatch.setattr("os.cpu_count", lambda: 8)  # the CPU entries a count may name
    for sub in ("sharded", "many"):
        (tmp_path / sub).mkdir()
    rc, _, left = _both(tmp_path / "sharded", files, argv + ["-devices=2", "-blocksize=512"], capsys)
    assert rc == 0
    _, _, unsharded = _run("port", tmp_path, files, argv + ["-blocksize=512"], capsys)
    assert left == unsharded
    assert (left["a.txt.rsn"] if command == "-compress" else left["a"]) == (
        jax_blocks.compress_container(TEXT, ("lzss", "arithmetic"), block_size=512)
        if command == "-compress" else TEXT)
    rc, out, left = _run("port", tmp_path / "many", files, argv + ["-devices=99"], capsys)
    assert rc == 1 and out == "devices=99: more than the 8 visible CPU cores\n" and left == files


def _table_rows(out: str) -> list[list[str]]:
    """The benchmark table's rows, each cell stripped, without the time column."""
    rows = []
    for line in out.splitlines():
        if line.startswith("│"):
            cells = [c.strip() for c in line.strip("│").split("│")]
            rows.append(cells[:1] + cells[2:])
    return rows


@pytest.mark.parametrize("algorithms", [None, "dmc,lzw,[lzss,arithmetic],mcc,flate,zlib,[huffman,gzip]"],
                         ids=["default", "host-only"])
def test_benchmark_rows_equal_jax(algorithms, tmp_path, capsys):
    argv = ["raisin", "-benchmark", "{d}/a.txt"] + ([f"-algorithm={algorithms}"] if algorithms else [])
    rows = {}
    for tag in MAINS:
        rc, out, _ = _run(tag, tmp_path, INPUTS, argv, capsys)
        assert rc == 0
        rows[tag] = _table_rows(out)
    want = jax_cli.parse_algorithms(algorithms or jax_cli.DEFAULT_BENCH_ALGORITHMS)
    assert rows["port"] == rows["jax"]
    assert len(rows["port"]) == len(want) + 2  # the header and the footer
    lossless = {r[0]: r[-1] for r in rows["port"][1:-1]}
    assert lossless == {",".join(a): "false" if "dmc" in a else "true" for a in want}


def test_benchmark_generate_writes_index(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "bench.txt").write_bytes(TEXT)
    assert port_cli.main(["raisin", "-benchmark", "bench.txt", "-algorithm=arithmetic,gzip", "-generate"],
                         device="cpu") == 0
    assert "Wrote table to index.html" in capsys.readouterr().out
    html = (tmp_path / "index.html").read_text()
    assert "go-pretty-table" in html and "<td>arithmetic</td>" in html and "<td>gzip</td>" in html


def test_profile_writes_a_trace(tmp_path, capsys):
    (tmp_path / "a.txt").write_bytes(TEXT)
    trace_dir = tmp_path / "trace"
    assert port_cli.main(["raisin", str(tmp_path / "a.txt"), "-algorithm=lzss,huffman",
                          f"-profile={trace_dir}"], device="cpu") == 0
    traces = list(trace_dir.glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "stream.compress" in names


def test_help_and_parser_match_jax(capsys):
    assert port_cli.main(["raisin", "-help"]) == 0
    assert "Usage of raisin" in capsys.readouterr().err
    for s in ("lzss,arithmetic", "lzss,[lzss,arithmetic],gzip", "[a,b],[c,d]", ""):
        assert port_cli.parse_algorithms(s) == jax_cli.parse_algorithms(s)
    assert (port_cli.DEFAULT_ALGORITHMS, port_cli.DEFAULT_BENCH_ALGORITHMS) == (
        jax_cli.DEFAULT_ALGORITHMS, jax_cli.DEFAULT_BENCH_ALGORITHMS)


def test_launchers_round_trip(tmp_path):
    """bin/raisin_torch and bin/grape_torch, with no card visible: the default raw pipeline
    compresses on the card and so fails; the native backend needs none, nor does the decode of
    a raw stream (the C runtime)."""
    src = tmp_path / "a.txt"
    src.write_bytes(TEXT)
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")

    def run(launcher, *args):
        return subprocess.run(["sh", str(REPO / "bin" / launcher), *args], cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=300)

    proc = run("raisin_torch", str(src))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "a.txt.rsn").exists()
    for launcher, args in (("raisin_torch", [str(src), "-backend=native"]),
                           ("grape_torch", [f"{src}.rsn", f"-out={src}.back"])):
        proc = run(launcher, *args)
        assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "a.txt.back").read_bytes() == TEXT
    assert not (tmp_path / "a.txt.rsn").exists()
    assert re.search(r"Compression ratio", run("raisin_torch", str(src), "-algorithm=gzip", f"-out={src}.gz").stdout)
    assert (tmp_path / "a.txt.gz").read_bytes() == raisin_tpu.compress_bytes(TEXT, ["gzip"])
