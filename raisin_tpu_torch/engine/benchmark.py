"""Benchmark suite — parity with reference engine.BenchmarkSuite (engine.go:213).

The port of raisin_tpu/engine/benchmark.py over the port's engine. The
functions take ``device`` besides the JAX package's arguments and pass it
to ``compress_bytes`` and ``decompress_bytes`` (None: the CUDA card).

Per file, every algorithm layer-stack runs concurrently in its own worker
(reference: one goroutine per algorithm, engine.go:243) with exception
isolation producing a ``Failed`` result (engine.go:315-330) and a one-minute
suite timeout producing ``>1m0s`` DNF rows (engine.go:216,246). Results sort
lossless-first then ascending compression ratio (engine.go:266-276).

Entropy columns are in nats (engine.go:410, ``goent`` with math.Log). The
reference's "actual entropy" column divides decompressed-byte frequencies by
the COMPRESSED length (engine.go:412-423) — a bug we reproduce for column
parity (the numbers are what a reference user expects to see); the correct
compressed-stream entropy is additionally available via
``Result.compressed_entropy``.
"""

from __future__ import annotations

import html as _html
import math
import threading
import time
from dataclasses import dataclass

from raisin_tpu_torch.engine.core import compress_bytes, decompress_bytes
from raisin_tpu_torch.engine.templates import render_benchmark_page
from raisin_tpu_torch.utils.misc import byte_count_si

SUITE_TIMEOUT_SECONDS = 60.0


@dataclass
class Settings:
    """Parity with engine.Settings (engine.go:342)."""

    write_out_files: bool = False
    print_stats: bool = False
    print_status: bool = False


def new_suite_settings() -> Settings:
    return Settings(print_status=True)


@dataclass
class Result:
    """Parity with engine.Result (engine.go:201)."""

    compression_engine: str = ""
    time_taken: str = ""
    ratio: float = 0.0
    actual_entropy: float = 0.0
    entropy: float = 0.0
    lossless: bool = False
    failed: bool = False
    # Extensions beyond the reference:
    compressed_entropy: float = 0.0  # the non-buggy version of actual_entropy
    seconds: float = 0.0
    original_bytes: int = 0
    compressed_bytes: int = 0


def _entropy_nats(counts: dict[int, int], total: int) -> float:
    """-sum(p ln p) over p = count/total (goent discrete.Entropy with math.Log)."""
    if total <= 0:
        return 0.0
    acc = 0.0
    for c in counts.values():
        p = c / total
        if p > 0:
            acc -= p * math.log(p)
    return acc


def _byte_counts(data: bytes) -> dict[int, int]:
    counts: dict[int, int] = {}
    for b in data:
        counts[b] = counts.get(b, 0) + 1
    return counts


def _format_duration(seconds: float) -> str:
    """Go-style duration string rounded to 10µs (engine.go:334)."""
    us = round(seconds * 1e6 / 10) * 10
    if us < 1000:
        return f"{us}µs"
    if us < 1_000_000:
        ms = us / 1000
        return f"{ms:g}ms"
    s = us / 1e6
    if s < 60:
        return f"{s:g}s"
    m, rem = divmod(s, 60)
    return f"{int(m)}m{rem:g}s"


def benchmark_file(
    algorithms: list[str], path: str, settings: Settings | None = None, device=None
) -> Result:
    """Parity with engine.BenchmarkFile (engine.go:357)."""
    settings = settings or Settings()
    with open(path, "rb") as f:
        contents = f.read()

    algorithms_string = ",".join(algorithms)
    if settings.print_status:
        print(f"{algorithms_string} Compressing...")

    theoretical = _entropy_nats(_byte_counts(contents), len(contents))

    start = time.perf_counter()
    compressed = compress_bytes(contents, algorithms, device=device)
    if settings.write_out_files:
        with open(f"{path.rsplit('/', 1)[-1]}.compressed", "wb") as f:
            f.write(compressed)
    if settings.print_status:
        print(f"{algorithms_string} Decompressing...")
    decompressed = decompress_bytes(compressed, algorithms, device=device)
    duration = time.perf_counter() - start

    if settings.write_out_files:
        with open(f"{path.rsplit('/', 1)[-1]}.decompressed", "wb") as f:
            f.write(decompressed)

    lossless = decompressed == contents
    ratio = len(compressed) / len(contents) * 100 if contents else float("inf")
    # Reference bug reproduced: decompressed-byte frequencies over compressed
    # length (engine.go:412-423).
    actual = _entropy_nats(_byte_counts(decompressed), len(compressed))
    correct_actual = _entropy_nats(_byte_counts(compressed), len(compressed))

    result = Result(
        compression_engine=algorithms_string,
        time_taken=_format_duration(duration),
        ratio=ratio,
        actual_entropy=actual,
        entropy=theoretical,
        lossless=lossless,
        failed=False,
        compressed_entropy=correct_actual,
        seconds=duration,
        original_bytes=len(contents),
        compressed_bytes=len(compressed),
    )
    if settings.print_stats:
        print(f"Lossless: {str(lossless).lower()}")
        print(f"Original bytes: {len(contents)}")
        print(f"Compressed bytes: {len(compressed)}")
        if not lossless:
            print(f"Decompressed bytes: {len(decompressed)}")
        print(f"Compression ratio: {ratio:.2f}%")
        print(f"Original Shannon entropy: {theoretical:.2f}")
        print(f"Compressed Shannon entropy: {actual:.2f}")
        print(f"Time taken: {result.time_taken}")
    return result


def _async_benchmark_file(results: dict, key: str, algorithms: list[str], path: str, device=None) -> None:
    """Parity with engine.AsyncBenchmarkFile (engine.go:310): isolate failures."""
    try:
        start = time.perf_counter()
        result = benchmark_file(algorithms, path, new_suite_settings(), device=device)
        result.time_taken = _format_duration(time.perf_counter() - start)
        print(f"{key} finished benchmarking")
        results[key] = result
    except Exception as exc:  # noqa: BLE001 — parity with recover()
        print(f"{key} errored during execution, continuing")
        print("Err:", exc)
        results[key] = Result(
            compression_engine=key, time_taken="failed", lossless=False, failed=True
        )


# ---------------------------------------------------------------------------
# Table rendering (go-pretty StyleLight look, engine.go:227-291)

_HEADERS = [
    "engine",
    "time taken",
    "compression ratio",
    "actual entropy",
    "theoretical entropy",
    "lossless",
]


def _render_table(rows: list[list[str]], footer: list[str]) -> str:
    widths = [len(h) for h in _HEADERS]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    for i, cell in enumerate(footer[: len(widths)]):
        widths[i] = max(widths[i], len(cell))

    def line(l: str, m: str, r: str) -> str:
        return l + m.join("─" * (w + 2) for w in widths) + r

    def row_str(cells: list[str]) -> str:
        padded = [f" {c:<{w}} " for c, w in zip(cells + [""] * len(widths), widths)]
        return "│" + "│".join(padded) + "│"

    out = [line("┌", "┬", "┐"), row_str([h.upper() for h in _HEADERS]), line("├", "┼", "┤")]
    for row in rows:
        out.append(row_str(row))
    out.append(line("├", "┼", "┤"))
    out.append(row_str(footer))
    out.append(line("└", "┴", "┘"))
    return "\n".join(out)


def _render_table_html(rows: list[list[str]], footer: list[str]) -> str:
    def tr(cells: list[str], tag: str) -> str:
        tds = "".join(f"<{tag}>{_html.escape(c)}</{tag}>" for c in cells)
        return f"<tr>{tds}</tr>"

    head = tr([h.upper() for h in _HEADERS], "th")
    body = "\n".join(tr(r, "td") for r in rows)
    foot = tr(footer, "td")
    return (
        '<table class="go-pretty-table">\n'
        f"<thead>\n{head}\n</thead>\n"
        f"<tbody>\n{body}\n</tbody>\n"
        f"<tfoot>\n{foot}\n</tfoot>\n"
        "</table>"
    )


def benchmark_suite(
    files: list[str],
    algorithms: list[list[str]],
    generate_html: bool = False,
    timeout: float = SUITE_TIMEOUT_SECONDS,
    device=None,
) -> tuple[str, list[Result]]:
    """Parity with engine.BenchmarkSuite (engine.go:213)."""
    html_parts: list[str] = []
    all_results: list[Result] = []

    for i, path in enumerate(files):
        print(f"Compressing file {i + 1}/{len(files)} - {path}")
        with open(path, "rb") as f:
            file_size = len(f.read())

        results_by_key: dict[str, Result] = {}
        threads = []
        keys = []
        for layer in algorithms:
            key = ",".join(layer)
            keys.append(key)
            print("Benchmarking", key)
            t = threading.Thread(
                target=_async_benchmark_file, args=(results_by_key, key, layer, path, device), daemon=True
            )
            threads.append(t)
            t.start()

        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

        ok_rows: list[Result] = []
        failed_rows: list[Result] = []
        for key in keys:
            result = results_by_key.get(key)
            if result is None:
                result = Result(
                    compression_engine=key,
                    time_taken=f">{_format_duration(timeout)}",
                    lossless=False,
                    failed=True,
                )
            (failed_rows if result.failed else ok_rows).append(result)

        ok_rows.sort(key=lambda r: (not r.lossless, r.ratio))

        rows = [
            [
                r.compression_engine,
                r.time_taken,
                f"{r.ratio:.2f}%",
                f"{r.actual_entropy:.2f}",
                f"{r.entropy:.2f}",
                str(r.lossless).lower(),
            ]
            for r in ok_rows
        ] + [
            [r.compression_engine, r.time_taken, "DNF", "DNF", "DNF", str(r.lossless).lower()]
            for r in failed_rows
        ]
        footer = ["File", path, "Size", byte_count_si(file_size), "", ""]
        print(_render_table(rows, footer))
        all_results.extend(ok_rows + failed_rows)
        if generate_html:
            html_parts.append("<br>" + _render_table_html(rows, footer))

    if generate_html:
        return render_benchmark_page("".join(html_parts)), all_results
    return "", all_results
