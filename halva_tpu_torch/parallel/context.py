"""Context (sequence) parallelism: attention over sequence-sharded
activations, on K1-K3's `q_offset`.

Counterpart of halva_tpu/parallel/context.py. Every rank holds a shard of
the queries and its shard of the keys and values; it all-gathers K, V and
their segment ids along the "seq" axis and runs the flash kernels with its
queries' global position, `q_offset = rank * Sq_local`, so the causal,
window and ALiBi terms see global positions. The backward is K2 / K3 with
the same offset, then a reduce-scatter of dK and dV (the transpose of the
gather). Shards are contiguous, so the causal mask gives late shards more
work than early ones, as in the reference.

The reference clamps its Pallas query tile to the shard (`block_q`); the
port's kernels plan their own tiles for any Sq (flash_fwd_plan,
flash_bwd_plan), so neither entry takes tile sizes.
`sequential_cp_attention` runs every shard's body in one process, one
after another over the whole K and V: the same kernel calls on one card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from halva_tpu_torch.ops.flash_attention import flash_attention
from halva_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    reduce_scatter,
)

SEQ_AXIS = "seq"


class _GatherSeq(torch.autograd.Function):
    """All-gather along dim 1; the backward reduce-scatters the grad."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, dim=1)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, dim=1), None


def cp_flash_attention(
    q: torch.Tensor,  # (B, Sq/n, H, D) this rank's query shard
    k: torch.Tensor,  # (B, Skv/n, KVH, D) its key shard
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,  # (B, Sq/n)
    kv_segment_ids: torch.Tensor,  # (B, Skv/n)
    group=None,
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The per-shard body: `group` is the "seq" axis's process group (the
    reference binds an axis name inside shard_map). Gathers K/V, runs this
    rank's queries against them; returns the local (B, Sq/n, H, D)
    output. Differentiable in q, k and v."""
    if group is None:
        raise ValueError("cp_flash_attention is a per-shard body: pass the "
                         "process group of the seq axis (group=)")
    idx = dist.get_rank(group)
    k_full = _GatherSeq.apply(k, group)
    v_full = _GatherSeq.apply(v, group)
    kvseg_full = all_gather(kv_segment_ids, group, dim=1)
    return flash_attention(q, k_full, v_full, q_segment_ids, kvseg_full,
                           causal=causal, scale=scale, alibi=alibi,
                           sliding_window=sliding_window,
                           q_offset=idx * q.shape[1])


def _chunk(x, mesh: Mesh, dims: Dict[int, str]) -> torch.Tensor:
    """This rank's chunk of x along each named dim."""
    for dim, axis in dims.items():
        n = x.shape[dim] // mesh.size(axis)
        x = x.narrow(dim, mesh.index(axis) * n, n)
    return x.contiguous()


class _Shard(torch.autograd.Function):
    """This rank's chunk of a tensor every rank holds whole; the backward
    all-gathers the grad chunks, so every rank ends with the whole grad
    (the loss is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, dims: Dict[int, str]):
        ctx.mesh, ctx.dims = mesh, dims
        return _chunk(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return _unshard(g, ctx.mesh, ctx.dims), None, None


def _unshard(x, mesh: Mesh, dims: Dict[int, str]) -> torch.Tensor:
    for dim, axis in reversed(list(dims.items())):
        x = all_gather(x, mesh.group(axis), dim)
    return x


class _Unshard(torch.autograd.Function):
    """The whole tensor from every rank's chunk; the backward keeps this
    rank's chunk of the grad."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, dims: Dict[int, str]):
        ctx.mesh, ctx.dims = mesh, dims
        return _unshard(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.mesh, ctx.dims), None, None


def context_parallel_attention(
    mesh: Mesh,
    q: torch.Tensor,  # (B, S, H, D), the whole tensors on every rank
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,  # (B, S)
    kv_segment_ids: torch.Tensor,
    seq_axis: str = SEQ_AXIS,
    batch_axis: Optional[str] = None,
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Shard the sequence dim over `seq_axis` (and the batch over
    `batch_axis`), run cp_flash_attention on each rank's shard, and give
    every rank the whole (B, S, H, D) output: the reference's shard_map
    with global arrays in and out. Differentiable in q, k and v."""
    dims = {1: seq_axis} if batch_axis is None else {0: batch_axis,
                                                     1: seq_axis}
    ql, kl, vl = (_Shard.apply(t, mesh, dims) for t in (q, k, v))
    qsl, kvsl = (_chunk(s, mesh, dims)
                 for s in (q_segment_ids, kv_segment_ids))
    out = cp_flash_attention(ql, kl, vl, qsl, kvsl,
                             group=mesh.group(seq_axis), causal=causal,
                             scale=scale, alibi=alibi,
                             sliding_window=sliding_window)
    return _Unshard.apply(out, mesh, dims)


def sequential_cp_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    shards: int,
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The `shards` shard bodies of cp_flash_attention in one process, one
    after another, each over the whole K and V with its q_offset; their
    outputs concatenated. Autograd sums dK and dV over the shards (the
    reduce-scatter's sum)."""
    s = q.shape[1]
    if s % shards:
        raise ValueError(f"{s} queries do not divide {shards} shards")
    n = s // shards
    outs = [flash_attention(q[:, i * n:(i + 1) * n].contiguous(), k, v,
                            q_segment_ids[:, i * n:(i + 1) * n].contiguous(),
                            kv_segment_ids, causal=causal, scale=scale,
                            alibi=alibi, sliding_window=sliding_window,
                            q_offset=i * n)
            for i in range(shards)]
    return torch.cat(outs, dim=1)
