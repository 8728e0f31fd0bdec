"""Entry points of the port: one-card forward step and multi-rank dry run (the counterpart of __graft_entry__.py).

- :func:`entry` returns the forward step of the flagship pipeline (LZSS
  match search and commit, then the adaptive arithmetic coder over a batch
  of blocks: kernels D, E and I) and its example arguments, at the JAX
  entry's shapes.
- :func:`dryrun_multichip` runs the container and the sharded encode step
  on n ranks (processes joined by ``torch.distributed``) and holds every
  payload and every block's bits against the port's oracle copies
  (``formats/lzss.py``, ``formats/arithmetic.py``).

    python -m raisin_tpu_torch.entry --dryrun N [--device cpu|cuda:K] [--backend gloo]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

B, S, WINDOW = 4, 1024, 4096
DRYRUN_BLOCK = 4096  # container block size of the dry run
DRYRUN_S = 4096  # block width of the dry run's sharded step
RANK_TIMEOUT = 900  # seconds a dry-run rank may take


def entry(device: torch.device | str | None = None):
    """-> (forward, (x, lengths)): forward(x, lengths) -> (bits (B, MB) uint8, bit_len (B,)).

    ``x`` is (4, 1024) uint8 of bytes 97..104 from seed 0, as the JAX
    entry's, on ``device`` (None: the card).
    """
    from raisin_tpu_torch.ops.device import resolve_device
    from raisin_tpu_torch.parallel.lzss_sharded import sharded_pipeline_step
    from raisin_tpu_torch.parallel.mesh import data_mesh

    dev = resolve_device(device)
    step = sharded_pipeline_step(data_mesh(1, dev), S, WINDOW)

    def forward(x: torch.Tensor, lengths: torch.Tensor):
        _, _, bits, bit_len = step(x, lengths)
        return bits, bit_len

    rng = np.random.default_rng(0)
    x = rng.integers(97, 105, size=(B, S)).astype(np.uint8)
    lengths = np.full((B,), S, dtype=np.int32)
    return forward, (torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev))


@contextlib.contextmanager
def rendezvous():
    """-> a ``file://`` URL at which the processes of one host meet (``multihost.initialize``), in a
    fresh temporary directory removed afterwards: no port is picked, so none can be taken meanwhile."""
    with tempfile.TemporaryDirectory(prefix="rsn-rendezvous-") as tmp:
        yield "file://" + os.path.join(tmp, "store")


def run_ranks(argv_of, n: int, env: dict | None = None, timeout: float = RANK_TIMEOUT) -> list[str]:
    """Start n processes (``argv_of(rank)``) with the repository on the path and wait for all.

    -> each one's output (stdout and stderr). Every process is waited for or
    killed; RuntimeError names the first rank that exited nonzero.
    """
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    procs = [subprocess.Popen(argv_of(r), env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {n} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def dryrun_multichip(n_devices: int, backend: str | None = None, device: torch.device | str | None = None) -> None:
    """Run the dry run on ``n_devices`` ranks, one process each.

    ``device=None`` (or ``"cuda"``) gives rank r card r, under NCCL: n past
    the visible cards raises ValueError naming both numbers, and no card
    raises RuntimeError. ``"cuda:K"`` puts every rank on card K, which
    needs ``backend="gloo"`` (NCCL refuses two ranks on one card);
    ``"cpu"`` runs gloo ranks on the host's cores, which they share. The
    backend is NCCL on cards and gloo on the CPU unless ``backend`` names
    one. Raises RuntimeError naming the rank that failed
    (:func:`run_ranks`); prints rank 0's summary.
    """
    from raisin_tpu_torch.parallel.mesh import first_devices

    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda" and (device is None or torch.device(device).index is None):
        devices = [str(d) for d in first_devices(n_devices, "cuda")]
    else:
        devices = [str(torch.device(device))] * n_devices
        if kind == "cuda" and n_devices > 1 and backend in (None, "nccl"):
            raise ValueError(f"{n_devices} ranks on {devices[0]}: NCCL refuses two ranks on one card; "
                             "pass backend='gloo' or device=None for a card a rank")
    env = dict(os.environ)
    if kind == "cpu":  # each rank its share of the cores: spinning OpenMP threads collide
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n_devices))
    with rendezvous() as url:
        cmd = [sys.executable, "-m", "raisin_tpu_torch.entry", "--rank-of", str(n_devices), "--init", url]
        cmd += ["--backend", backend] if backend else []
        outs = run_ranks(lambda r: cmd + ["--rank", str(r), "--device", devices[r]], n_devices, env)
    print(outs[0].strip().splitlines()[-1])


def _dryrun_data(n: int) -> tuple[bytes, np.random.Generator]:
    """The JAX dry run's container input (a ragged tail block on purpose) and its generator, after it."""
    rng = np.random.default_rng(0)
    words = [b"shard", b"mesh", b"block", b"tpu", b"stream", b"window "]
    data = b" ".join(words[i] for i in rng.integers(0, len(words), 3 * n * DRYRUN_BLOCK // 6))
    return data[: (2 * n + 1) * DRYRUN_BLOCK - 517], rng


def _dryrun_rank(rank: int, n: int, init: str, device: str, backend: str | None) -> None:
    import torch.distributed as dist

    from raisin_tpu_torch.formats import arithmetic, lzss
    from raisin_tpu_torch.parallel import blocks, multihost
    from raisin_tpu_torch.parallel.lzss_sharded import sharded_pipeline_step
    from raisin_tpu_torch.parallel.multihost_worker import encode_segment

    dev = multihost.initialize(init, n, rank, backend=backend, device=device)
    try:
        # part 1: the container over the ranks' block ranges, every payload against the oracle
        data, rng = _dryrun_data(n)
        bs = DRYRUN_BLOCK
        nblocks = -(-len(data) // bs)
        lo, hi = multihost.process_block_range(nblocks)
        payloads, aux = encode_segment(data, lo, hi, bs, WINDOW, dev) if hi > lo else ([], [])
        for i, p in enumerate(payloads, lo):
            if p != arithmetic.compress(lzss.compress(data[i * bs : (i + 1) * bs])):
                raise AssertionError(f"container block {i} diverged from the oracle")
        segments = [None] * n
        dist.all_gather_object(segments, (payloads, aux))
        container = blocks.assemble_container([p for s in segments for p in s[0]], [[t for s in segments for t in s[1]]],
                                              blocks.LZ_ARITH, bs, WINDOW, len(data))
        if rank == 0 and blocks.decompress_container(container, device=dev) != data:
            raise AssertionError("the rank-order container did not round-trip")

        # part 2: the ('data', 'model') step, the distance window split over model groups of 2
        model_axis = 2 if n % 2 == 0 else 1
        mesh = multihost.global_data_mesh(model_axis)
        nb = 2 * mesh.shape["data"]
        x = np.full((nb, DRYRUN_S), 0, dtype=np.uint8)
        lengths = np.zeros((nb,), dtype=np.int32)
        for i in range(nb):
            k = int(rng.integers(DRYRUN_S // 2, DRYRUN_S))
            x[i, :k] = rng.integers(97, 105, size=k)
            lengths[i] = k
        mine = slice(2 * (rank // model_axis), 2 * (rank // model_axis) + 2)
        step = sharded_pipeline_step(mesh, DRYRUN_S, WINDOW)
        _, _, bits, bit_len = step(torch.from_numpy(x[mine]).to(dev), torch.from_numpy(lengths[mine]).to(dev))
        bits, bit_len = bits.cpu().numpy(), bit_len.cpu().numpy()
        for b, i in enumerate(range(nb)[mine]):
            block = x[i, : lengths[i]].tobytes()
            want = arithmetic.encode_bits(lzss.commit_tokens(block, lzss.find_matches(block, WINDOW)))
            pad = 8 - want.size % 8
            if int(bit_len[b]) != want.size + pad or not (bits[b, pad : pad + want.size] == want).all():
                raise AssertionError(f"sharded block {i} diverged from the oracle")
        devices = [None] * n
        dist.all_gather_object(devices, str(dev))
        if rank == 0:
            print(f"dryrun_multichip OK: {n} ranks on {', '.join(sorted(set(devices)))} ({dist.get_backend()}): "
                  f"container {nblocks}/{nblocks} blocks oracle-exact (bs={bs}, ragged tail); {mesh.shape} step "
                  f"{nb}/{nb} blocks x {DRYRUN_S} B oracle-exact", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raisin_tpu_torch.entry")
    ap.add_argument("--dryrun", type=int, help="run the dry run on this many ranks")
    ap.add_argument("--rank-of", type=int, help=argparse.SUPPRESS)  # one rank of a dry run of this size
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)  # the ranks' rendezvous URL
    ap.add_argument("--device", help="cpu, or cuda:K for every rank on card K (default: a card a rank)")
    ap.add_argument("--backend")
    args = ap.parse_args(argv)
    if args.rank_of is not None:
        _dryrun_rank(args.rank, args.rank_of, args.init, args.device, args.backend)
    else:
        dryrun_multichip(args.dryrun or 2, args.backend, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
