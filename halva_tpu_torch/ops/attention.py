"""Segment-id attention: the plain PyTorch version and the dispatcher.

Counterpart of halva_tpu/ops/attention.py. `segment_ids[b, t] == 0` marks
padding; a query attends only keys with the same nonzero segment id (and,
when causal, not past its own index; with a sliding window, not further
back than the window). ALiBi (MPT) adds -slope_h * distance to the logits.
Layout (B, S, H, D) throughout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30  # finite big-negative: a fully masked row gives no NaN


def make_attention_mask(
    q_segment_ids: torch.Tensor,  # (B, Sq) int
    kv_segment_ids: torch.Tensor,  # (B, Skv) int
    causal: bool = True,
    q_offset=None,  # int or (B,) tensor: position of query row 0
    sliding_window: Optional[int] = None,  # Mistral-style local window
) -> torch.Tensor:
    """Boolean (B, 1, Sq, Skv) mask: True = attend.

    `q_offset` puts query i at absolute position offset + i (a query shard
    against all keys, or a decode step); `sliding_window` keeps only keys
    within the last W positions of the query."""
    same = (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]) & (
        q_segment_ids[:, :, None] != 0
    )
    dev = q_segment_ids.device
    q_pos = torch.arange(q_segment_ids.shape[1], device=dev)[None, :]
    if q_offset is not None:
        if isinstance(q_offset, torch.Tensor):
            q_pos = q_pos + q_offset[:, None]
        else:
            q_pos = q_pos + int(q_offset)
    k_pos = torch.arange(kv_segment_ids.shape[1], device=dev)[None, :]
    dist = q_pos[:, :, None] - k_pos[:, None, :]  # (1|B, Sq, Skv)
    if causal:
        same = same & (dist >= 0)
    if sliding_window is not None:
        same = same & (dist < sliding_window)
    return same[:, None, :, :]


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """(H,) fp32 ALiBi slopes (MPT): 2^(-8(h+1)/H) for a power-of-two head
    count; otherwise the ladder of the power of two below, then every other
    slope of the next ladder. Computed on `device` from aranges (no host
    copy, so a CUDA graph can capture it), in fp64 as the reference's host
    arithmetic."""
    k = 2 ** math.floor(math.log2(num_heads))

    def ladder(n, idx):  # slope idx + 1 of the n-head ladder
        return torch.exp2(-8.0 * (idx + 1) / n)

    i = torch.arange(k, dtype=torch.float64, device=device)
    slopes = ladder(k, i)
    if k != num_heads:
        j = torch.arange(num_heads - k, dtype=torch.float64, device=device)
        slopes = torch.cat([slopes, ladder(2 * k, 2 * j)])
    return slopes.float()


def alibi_bias(
    num_heads: int,
    q_positions: torch.Tensor,  # (B, Sq)
    k_positions: torch.Tensor,  # (B, Skv)
) -> torch.Tensor:
    """(B, H, Sq, Skv) fp32 ALiBi additive bias: -slope_h * |q - k|."""
    s = alibi_slopes(num_heads, q_positions.device)
    dist = (q_positions[:, :, None] - k_positions[:, None, :]).float()
    return -dist.abs()[:, None, :, :] * s[None, :, None, None]


def causal_alibi_bias(num_heads: int, sq: int, skv: int, device,
                      q_offset: int = 0) -> torch.Tensor:
    """(1, H, Sq, Skv) ALiBi bias of queries at positions q_offset + i
    against keys at their indices."""
    q_pos = torch.arange(sq, device=device)[None, :] + int(q_offset)
    k_pos = torch.arange(skv, device=device)[None, :]
    return alibi_bias(num_heads, q_pos, k_pos)


def attention_reference(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,  # (B, Skv, KVH, D)
    mask: Optional[torch.Tensor] = None,  # (B, 1|H, Sq, Skv) bool
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,  # additive (1|B, H, Sq, Skv)
) -> torch.Tensor:
    """Plain attention: fp32 logits, softmax and PV; output in q's dtype.
    GQA: KVH divides H and kv heads are repeated over the query groups.
    `bias` (ALiBi) is added to the scaled logits before the mask."""
    h, d = q.shape[2], q.shape[3]
    kvh = k.shape[2]
    if scale is None:
        scale = d**-0.5
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def alibi_in_kernel(num_heads: int) -> bool:
    """Whether the flash kernels' slope formula 2^(-8(h+1)/H) covers this
    head count: powers of two only (the reference's rule,
    halva_tpu/ops/attention.py:152)."""
    return num_heads & (num_heads - 1) == 0


KERNEL_HEAD_DIM = 128  # the head dim the attention kernels are built for


def kernel_route(impl: str, head_dim: int) -> str:
    """"kernel" or "plain" for a caller's `impl` at this head dim, decided
    from the config alone, on either device: "auto" takes the kernels (K1-K5,
    and K6 / K7 for a packed-int4 decode step) at head dim 128, the head dim
    they are built for, and the plain versions at any other; a caller who
    names "kernel" or "plain" gets what they name, and the kernels' wrappers
    raise on a head dim they do not take. The reference makes the same
    choice for its own reason (`dh % 128 == 0`, the TPU's lane width,
    halva_tpu/models/llama.py:878)."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto":
        return "kernel" if head_dim == KERNEL_HEAD_DIM else "plain"
    return impl


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    causal: bool = True,
    impl: str = "auto",
    alibi: bool = False,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Segment-id attention entry point. Shapes as attention_reference.

    impl "plain" runs attention_reference on a materialized mask (and ALiBi
    bias). "auto" and "kernel" go through the flash wrapper
    (ops/flash_attention.py), which launches the CUDA kernel for CUDA
    tensors and uses its plain version for CPU tensors, with ALiBi and the
    sliding window computed inside the kernel: the device decides, never a
    failure. ALiBi with a head count that is not a power of two takes the
    plain path on either device, as in the reference: the kernels' slope
    formula does not cover it. So does "auto" at a head dim other than 128
    (`kernel_route`).
    """
    route = kernel_route(impl, q.shape[3])
    from halva_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    if route == "plain" or (alibi and not alibi_in_kernel(q.shape[2])):
        return flash_attention_plain(
            q, k, v, q_segment_ids, kv_segment_ids, causal=causal,
            alibi=alibi, sliding_window=sliding_window,
        )
    return flash_attention(
        q, k, v, q_segment_ids, kv_segment_ids, causal=causal, alibi=alibi,
        sliding_window=sliding_window,
    )
