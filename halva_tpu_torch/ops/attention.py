"""Segment-id attention: the plain PyTorch version and the dispatcher.

Counterpart of halva_tpu/ops/attention.py. `segment_ids[b, t] == 0` marks
padding; a query attends only keys with the same nonzero segment id (and,
when causal, not past its own index). Layout (B, S, H, D) throughout.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite big-negative: a fully masked row gives no NaN


def make_attention_mask(
    q_segment_ids: torch.Tensor,  # (B, Sq) int
    kv_segment_ids: torch.Tensor,  # (B, Skv) int
    causal: bool = True,
) -> torch.Tensor:
    """Boolean (B, 1, Sq, Skv) mask: True = attend."""
    same = (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]) & (
        q_segment_ids[:, :, None] != 0
    )
    if causal:
        dev = q_segment_ids.device
        q_pos = torch.arange(q_segment_ids.shape[1], device=dev)
        k_pos = torch.arange(kv_segment_ids.shape[1], device=dev)
        same = same & (q_pos[:, None] >= k_pos[None, :])[None]
    return same[:, None, :, :]


def attention_reference(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,  # (B, Skv, KVH, D)
    mask: Optional[torch.Tensor] = None,  # (B, 1|H, Sq, Skv) bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention: fp32 logits, softmax and PV; output in q's dtype.
    GQA: KVH divides H and kv heads are repeated over the query groups."""
    h, d = q.shape[2], q.shape[3]
    kvh = k.shape[2]
    if scale is None:
        scale = d**-0.5
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    causal: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    """Segment-id attention entry point. Shapes as attention_reference.

    impl "plain" runs attention_reference. "auto" and "kernel" go through
    the flash wrapper (ops/flash_attention.py), which launches the CUDA
    kernel for CUDA tensors and uses its plain version for CPU tensors: the
    device decides, never a failure.
    """
    if impl == "plain":
        mask = make_attention_mask(q_segment_ids, kv_segment_ids, causal)
        return attention_reference(q, k, v, mask=mask)
    if impl not in ("auto", "kernel"):
        raise ValueError(f"unknown attention impl {impl!r}")
    from halva_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(
        q, k, v, q_segment_ids, kv_segment_ids, causal=causal
    )
