"""K1: flash-attention forward (CUDA, csrc/flash_fwd.cu) and its plain version.

Counterpart of halva_tpu/ops/flash_attention.py (forward only: the backward
kernels K2/K3 belong to the training slice). Public layout (B, S, H, D) like
the rest of the package; GQA when KVH divides H.

`flash_attention` launches the kernel for CUDA tensors and uses
`flash_attention_plain` for CPU tensors. There is no fallback: on a CUDA
tensor it launches or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from halva_tpu_torch import _kernels
from halva_tpu_torch.ops.attention import (
    attention_reference,
    make_attention_mask,
)

KERNEL = "flash_fwd"


def flash_attention_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,  # (B, Sq)
    kv_segment_ids: torch.Tensor,  # (B, Skv)
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    mask = make_attention_mask(q_segment_ids, kv_segment_ids, causal)
    return attention_reference(q, k, v, mask=mask, scale=scale)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on CUDA tensors: returns (o (B, Sq, H, D) bf16, lse
    (B, H, Sq) fp32, natural log). Fully masked rows give o = 0."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    tensors = (q, k, v, q_segment_ids, kv_segment_ids)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("flash_attention_fwd: all inputs on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("flash_attention_fwd: q, k, v must be bfloat16")
    if any(t.dtype != torch.int32 for t in tensors[3:]):
        raise TypeError("flash_attention_fwd: segment ids must be int32")
    if (
        k.shape != (b, skv, kvh, d)
        or v.shape != k.shape
        or h % kvh
        or q_segment_ids.shape != (b, sq)
        or kv_segment_ids.shape != (b, skv)
    ):
        raise ValueError(
            f"flash_attention_fwd: bad shapes q {tuple(q.shape)} "
            f"k {tuple(k.shape)} v {tuple(v.shape)} "
            f"segs {tuple(q_segment_ids.shape)} {tuple(kv_segment_ids.shape)}"
        )
    if d != 128:
        raise ValueError(f"flash_attention_fwd: head dim {d} is not 128")
    if any(not t.is_contiguous() for t in tensors) or any(
        t.data_ptr() % 16 for t in (q, k, v)
    ):
        raise ValueError("flash_attention_fwd: inputs must be contiguous, "
                         "q, k, v 16-byte aligned")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().halva_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_segment_ids.data_ptr(), kv_segment_ids.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            b, sq, skv, h, kvh, d, float(scale), int(causal), stream,
        )
    _kernels.check(err, KERNEL)
    _kernels.launches[KERNEL] += 1
    return o, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
    q_offset=None,
) -> torch.Tensor:
    """Segment-id flash attention; layout as halva_tpu's flash_attention."""
    if alibi or sliding_window is not None or q_offset is not None:
        raise NotImplementedError(
            "flash_attention: ALiBi, sliding window and q_offset are not "
            "ported yet (ROADMAP queue 2, K1 modes)"
        )
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_segment_ids, kv_segment_ids, causal, scale
        )
    o, _ = flash_attention_fwd(
        q, k, v, q_segment_ids, kv_segment_ids, causal, scale
    )
    return o
