"""Tensor-parallel LZSS match search and the sharded encode step: the port of raisin_tpu/parallel/lzss_sharded.py.

Two mesh axes:

- ``'data'``: blocks are sharded data-parallel (each rank gets its own
  blocks);
- ``'model'``: the match search's distance window is split among the
  ranks of a model group. Rank m of the group runs kernel D over the
  distances (m * wl, (m + 1) * wl], wl = window // model size, and the
  exact greedy result comes back with two MAX all-reduces over the group:

      L = all_reduce(L_local, MAX)                          # longest match anywhere
      D = all_reduce(where(L_local == L, D_local, 0), MAX)  # largest distance at L

  (the largest distance is the leftmost occurrence, bytes.Index semantics).

Then kernel E commits the tokens and the stream coder (kernel I and the
expansion of ``ops/arithmetic_scan.py``) writes each block's `.rsn` bits,
as the JAX step's ``commit_blocks`` and ``encode_blocks``.

The ranks are the processes of the ``torch.distributed`` group, laid out
as ``parallel.multihost.global_data_mesh`` lays them: rank r is entry
(r // model size, r % model size). Without an initialised group, one
process runs every shard of its model group in turn and combines them by
the same rule.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from raisin_tpu_torch.ops import arithmetic_scan, lzss_commit, lzss_match
from raisin_tpu_torch.parallel.mesh import Mesh

WINDOW = 4096


def combine(L_a: torch.Tensor, D_a: torch.Tensor, L_b: torch.Tensor, D_b: torch.Tensor):
    """Two distance shards' matches -> the match over both: the all-reduce rules in one process."""
    L = torch.maximum(L_a, L_b)
    return L, torch.maximum(torch.where(L_a == L, D_a, 0), torch.where(L_b == L, D_b, 0))


def _model_group(mesh: Mesh):
    """-> (this rank's model index, its process group), or (None, None) without an initialised group.

    Every rank creates every model group, as ``dist.new_group`` requires.
    """
    if not (dist.is_available() and dist.is_initialized()):
        return None, None
    model, world = mesh.shape["model"], dist.get_world_size()
    if mesh.size != world:
        raise ValueError(f"mesh of {mesh.size} devices over a group of {world} processes")
    rank = dist.get_rank()
    groups = [dist.new_group(list(range(g * model, (g + 1) * model))) for g in range(world // model)]
    return rank % model, groups[rank // model]


def sharded_pipeline_step(mesh: Mesh, S: int, window: int = WINDOW):
    """Build the encode step (LZSS match and commit, arithmetic coder) over ``('data', 'model')``.

    Returns ``fn(x (B, S) uint8 escaped bytes, lengths (B,) int32) ->
    (tok (B, S) uint8, tok_len (B,), bits (B, MB) uint8, bit_len (B,))`` for
    this rank's ``'data'`` shard of blocks, with MB = 17 * (S + 8) + 16
    rounded up to whole bytes: the JAX step's outputs on the same blocks.
    Every rank of the group calls this and then ``fn`` collectively.
    """
    model = mesh.shape.get("model", 1)
    wl = window // model
    steps = S + 8  # the coder's steps: the token stream (<= S) and its EOF
    index, group = _model_group(mesh) if model > 1 else (None, None)

    def step(x: torch.Tensor, lengths: torch.Tensor):
        if group is not None:
            L_loc, D_loc = lzss_match.find_matches(x, lengths, window, index * wl, (index + 1) * wl)
            L = L_loc.clone()
            dist.all_reduce(L, dist.ReduceOp.MAX, group=group)
            D = torch.where(L_loc == L, D_loc, 0)
            dist.all_reduce(D, dist.ReduceOp.MAX, group=group)
        else:
            L, D = lzss_match.find_matches(x, lengths, window, 0, wl)
            for m in range(1, model):
                L, D = combine(L, D, *lzss_match.find_matches(x, lengths, window, m * wl, (m + 1) * wl))
        tok, tok_len = lzss_commit.commit_tokens(x, L, D, lengths)
        j = torch.arange(steps, dtype=torch.int32, device=x.device)
        syms = torch.where(j[None, :] < tok_len[:, None], F.pad(tok, (0, 8))[:, :steps].to(torch.int32),
                           arithmetic_scan.EOF).to(torch.int32)
        bits, bit_len = arithmetic_scan.encode_blocks(syms, tok_len)
        return tok, tok_len, bits, bit_len

    return step
