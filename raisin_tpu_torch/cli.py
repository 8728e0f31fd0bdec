"""`raisin` / `grape` command line (parity with reference cmd/cli.go): the port of raisin_tpu/cli.py.

Surface:

    raisin [command] file[,file2,…] [flags]

Commands (exactly one; defaults to -compress, or -decompress when the
executable name ends in "grape", cmd/cli.go:54):
    -compress -decompress -benchmark -help

Flags:
    -algorithm=a,b,[c,d]   codec layers; "[…]" groups stack layers in
                           benchmark mode (cmd/cli.go:203). Defaults:
                           compress/decompress "lzss,arithmetic"
                           benchmark "lzss,arithmetic,huffman,[lzss,arithmetic],gzip"
    -out=PATH              output name (single file)
    -outext=EXT            output extension (multiple files)
    -delete                delete inputs afterwards (default false for
                           compress, TRUE for decompress, cmd/cli.go:114,150)
    -generate              benchmark only: write index.html
    -backend=auto|host|native|device
    -container             compress into the RSNB block container (the
                           block-parallel scale path; decompress
                           auto-detects the RSNB magic)
    -blocksize=N           container block size in bytes (default 65536)
    -devices=N|auto        the number of cards; the port runs on one so far,
                           and any other value exits 1 (multi-GPU is
                           ROADMAP Queue 1 item 13)
    -window=N              LZSS search window (default 4096; parity with
                           lz.NewWriterLevel, lzss.go:42). In container
                           mode this sets the speed/ratio tradeoff
    -profile[=DIR]         wrap the run in a torch.profiler trace, written
                           as a Chrome trace file into DIR (default
                           raisin_tpu_torch_trace in the temporary directory)

``main(argv, device=...)`` takes the device for every codec and container
call (None: the CUDA card; "cpu" runs the kernels' plain versions); it is
a keyword for callers, not a flag.
"""

from __future__ import annotations

import contextlib
import os
import sys

from raisin_tpu_torch.engine import registry
from raisin_tpu_torch.engine.benchmark import benchmark_suite
from raisin_tpu_torch.engine.core import (
    compress_file,
    compress_files,
    decompress_file,
    decompress_files,
)

COMMANDS = ["compress", "decompress", "benchmark", "help"]

DEFAULT_ALGORITHMS = "lzss,arithmetic"
DEFAULT_BENCH_ALGORITHMS = "lzss,arithmetic,huffman,[lzss,arithmetic],gzip"


def parse_algorithms(algorithm_string: str) -> list[list[str]]:
    """Benchmark-mode parser with "[…]" layer groups (cmd/cli.go:203)."""
    algorithms: list[list[str]] = []
    buffer = ""
    layer: list[str] = []
    in_layer = False
    for ch in algorithm_string:
        if ch == ",":
            if in_layer and buffer:
                layer.append(buffer)
            elif buffer:
                algorithms.append([buffer])
            buffer = ""
        elif ch == "[":
            in_layer = True
        elif ch == "]":
            layer.append(buffer)
            buffer = ""
            in_layer = False
            algorithms.append(layer)
            layer = []
        else:
            buffer += ch
    if buffer:
        algorithms.append([buffer])
    return algorithms


def _error(msg: str) -> "int":
    print(msg, end="")
    return 1


def _split_flags(args: list[str]) -> tuple[dict[str, str], list[str]]:
    flags: dict[str, str] = {}
    positional: list[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-"):
            name = a.lstrip("-")
            if "=" in name:
                k, v = name.split("=", 1)
                flags[k] = v
            elif name in ("compress", "decompress", "benchmark", "help", "delete", "generate", "no-delete"):
                flags[name] = "true"
            elif i + 1 < len(args) and not args[i + 1].startswith("-"):
                # Allow "-algorithm value" spelling in addition to "-algorithm=value"
                if name in ("algorithm", "out", "outext", "backend", "blocksize", "devices", "window"):
                    flags[name] = args[i + 1]
                    i += 1
                else:
                    flags[name] = "true"
            else:
                flags[name] = "true"
        else:
            positional.append(a)
        i += 1
    return flags, positional


def main(argv: list[str] | None = None, device=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    application = argv[0] if argv else "raisin"
    flags, positional = _split_flags(argv[1:])

    commands = [c for c in ("compress", "decompress", "benchmark", "help") if flags.get(c) == "true"]
    if len(commands) > 1:
        return _error("Please specify a single command. \n")
    if not commands:
        # default by executable name (cmd/cli.go:54)
        base = os.path.basename(application)
        command = "decompress" if base.endswith("grape") else "compress"
    else:
        command = commands[0]

    if command == "help":
        print(f"Usage of {application}:", file=sys.stderr)
        print(f"Valid commands include: \n\t {', '.join(COMMANDS)}", file=sys.stderr)
        print(__doc__, file=sys.stderr)
        return 0

    if flags.get("backend"):
        registry.set_preferred_backend(flags["backend"])

    if "profile" in flags:
        from raisin_tpu_torch.utils.profiling import DEFAULT_TRACE_DIR, trace

        trace_dir = flags["profile"] if flags["profile"] != "true" else DEFAULT_TRACE_DIR
        profile_cm = trace(trace_dir)
    else:
        profile_cm = contextlib.nullcontext()

    with profile_cm:
        return _run_command(command, flags, positional, application, device)


def _run_command(command: str, flags: dict, positional: list[str], application: str, device) -> int:

    file_arg = positional[0] if positional else ""
    if not file_arg:
        if command == "compress":
            return _error("Please provide a file to be compressed\n")
        if command == "benchmark":
            return _error("Please provide a file to be benchmarked\n")
        return _error("Please provide a file to be decompressed\n")

    files = [f.strip() for f in file_arg.split(",")]
    for f in files:
        if f != "help" and not os.path.exists(f):
            return _error(f"Could not open file (likely does not exist): {f}\n")

    if command == "compress":
        algorithms = [a.strip() for a in flags.get("algorithm", DEFAULT_ALGORITHMS).split(",")]
        delete_after = flags.get("delete") == "true"
        container = flags.get("container") == "true"
        block_size = int(flags.get("blocksize", str(1 << 16)))
        devices = flags.get("devices")
        window = int(flags["window"]) if "window" in flags else None
        try:
            if len(files) > 1:
                ext = "." + flags.get("outext", "rsn")
                compress_files(
                    algorithms, files, ext,
                    container=container, block_size=block_size, devices=devices,
                    window=window, device=device,
                )
            else:
                out = flags.get("out", files[0] + ".rsn")
                compress_file(
                    algorithms, files[0], out,
                    container=container, block_size=block_size, devices=devices,
                    window=window, device=device,
                )
        except KeyError as exc:
            return _error(f"{exc.args[0]}\nValid algorithms: {', '.join(registry.ENGINES)}\n")
        except NotImplementedError as exc:  # -devices other than 1 (ROADMAP Queue 1 item 13)
            return _error(f"{exc}\n")
        if delete_after:
            for f in files:
                os.remove(f)
        return 0

    if command == "decompress":
        algorithms = [a.strip() for a in flags.get("algorithm", DEFAULT_ALGORITHMS).split(",")]
        # reference default: delete inputs after decompression (cmd/cli.go:150)
        delete_after = flags.get("no-delete") != "true" if "delete" not in flags else flags["delete"] == "true"
        try:
            if len(files) > 1:
                ext = flags.get("outext", "")
                decompress_files(
                    algorithms, files, ("." + ext) if ext else "",
                    devices=flags.get("devices"), device=device,
                )
            else:
                default_out = os.path.splitext(files[0])[0]
                out = flags.get("out", default_out)
                decompress_file(algorithms, files[0], out, devices=flags.get("devices"), device=device)
        except KeyError as exc:
            return _error(f"{exc.args[0]}\nValid algorithms: {', '.join(registry.ENGINES)}\n")
        except NotImplementedError as exc:  # -devices other than 1 (ROADMAP Queue 1 item 13)
            return _error(f"{exc}\n")
        except ValueError as exc:
            return _error(f"decompression failed: {exc}\n")
        if delete_after:
            for f in files:
                os.remove(f)
        return 0

    # benchmark
    if file_arg == "help":
        print("Flags:\n  -algorithm, -generate", file=sys.stderr)
        return 0
    algorithms = parse_algorithms(flags.get("algorithm", DEFAULT_BENCH_ALGORITHMS))
    generate_html = flags.get("generate") == "true"
    output, _results = benchmark_suite(files, algorithms, generate_html, device=device)
    if generate_html:
        with open("index.html", "w") as f:
            f.write(output)
        print("Wrote table to index.html")
    return 0


if __name__ == "__main__":
    sys.exit(main())
