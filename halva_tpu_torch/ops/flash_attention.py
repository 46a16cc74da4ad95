"""Flash attention with segment ids: K1 (forward, csrc/flash_fwd.cu), K2 and
K3 (backward, csrc/flash_bwd.cu), and their plain versions.

Counterpart of halva_tpu/ops/flash_attention.py. Public layout (B, S, H, D)
like the rest of the package; GQA when KVH divides H.

`flash_attention` on CUDA tensors is a `torch.autograd.Function`: the
forward launches K1 and keeps o and the log-sum-exp, the backward computes
delta = rowsum(dO * O) and launches K2 (dQ) and K3 (dK, dV). On CPU tensors
it is `flash_attention_plain`, and autograd goes through the plain ops.
There is no fallback: on a CUDA tensor it launches or raises.
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
KERNEL_DQ = "flash_bwd_dq"
KERNEL_DKV = "flash_bwd_dkv"


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


def flash_attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, H, Sq): the backward's per-row
    statistic, a torch reduction as it is XLA's in the reference."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,  # (B, Sq)
    kv_segment_ids: torch.Tensor,  # (B, Skv)
    o: torch.Tensor,  # (B, Sq, H, D) the forward's output
    lse: torch.Tensor,  # (B, H, Sq) fp32, natural log
    do: torch.Tensor,  # (B, Sq, H, D)
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's, k's and v's dtypes: the plain counterpart of the
    reference's `_flash_bwd`. P is recomputed from the saved LSE and selected
    to 0 where masked (a fully masked row's LSE would overflow exp);
    delta = rowsum(dO * O) in fp32; P is rounded to dO's dtype before dV and
    dS = P * (dP - delta) * scale to the input dtype before dK and dQ, as the
    Pallas kernels round them; every product accumulates in fp32; dK and dV
    are summed over each KV head's query group."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if scale is None:
        scale = d**-0.5
    mask = make_attention_mask(q_segment_ids, kv_segment_ids, causal)
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=s.device))
    delta = flash_attention_delta(o, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = dk.reshape(b, skv, kvh, g, d).sum(3)
    dv = dv.reshape(b, skv, kvh, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda_args(name, q, k, v, q_segment_ids, kv_segment_ids):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    tensors = (q, k, v, q_segment_ids, kv_segment_ids)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name}: q, k, v must be bfloat16")
    if any(t.dtype != torch.int32 for t in tensors[3:]):
        raise TypeError(f"{name}: segment ids must be int32")
    if (
        k.shape != (b, skv, kvh, d)
        or v.shape != k.shape
        or h % kvh
        or q_segment_ids.shape != (b, sq)
        or kv_segment_ids.shape != (b, skv)
    ):
        raise ValueError(
            f"{name}: bad shapes q {tuple(q.shape)} "
            f"k {tuple(k.shape)} v {tuple(v.shape)} "
            f"segs {tuple(q_segment_ids.shape)} {tuple(kv_segment_ids.shape)}"
        )
    if d != 128:
        raise ValueError(f"{name}: head dim {d} is not 128")
    if any(not t.is_contiguous() for t in tensors) or any(
        t.data_ptr() % 16 for t in (q, k, v)
    ):
        raise ValueError(f"{name}: inputs must be contiguous, "
                         "q, k, v 16-byte aligned")


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
    _check_cuda_args("flash_attention_fwd", q, k, v, q_segment_ids,
                     kv_segment_ids)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
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


def _check_bwd_args(name, q, k, v, q_segment_ids, kv_segment_ids, do, lse,
                    delta):
    _check_cuda_args(name, q, k, v, q_segment_ids, kv_segment_ids)
    b, sq, h, _ = q.shape
    if do.shape != q.shape or lse.shape != (b, h, sq) or (
            delta.shape != lse.shape):
        raise ValueError(
            f"{name}: bad shapes do {tuple(do.shape)} lse {tuple(lse.shape)} "
            f"delta {tuple(delta.shape)} for q {tuple(q.shape)}")
    if do.dtype != torch.bfloat16 or lse.dtype != torch.float32 or (
            delta.dtype != torch.float32):
        raise TypeError(f"{name}: do must be bfloat16, lse and delta fp32")
    if any(t.device != q.device for t in (do, lse, delta)):
        raise ValueError(f"{name}: all inputs on one CUDA device")
    if any(not t.is_contiguous() for t in (do, lse, delta)) or (
            do.data_ptr() % 16):
        raise ValueError(f"{name}: do, lse, delta must be contiguous, do "
                         "16-byte aligned")


def _bwd_args(q, k, v, q_segment_ids, kv_segment_ids, do, lse, delta,
              causal, scale):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_segment_ids.data_ptr(), kv_segment_ids.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    return ptrs, (b, sq, skv, h, kvh, d, float(scale), int(causal))


def flash_attention_bwd_dq(q, k, v, q_segment_ids, kv_segment_ids, do, lse,
                           delta, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Launch K2 on CUDA tensors: dq (B, Sq, H, D) bf16."""
    _check_bwd_args("flash_attention_bwd_dq", q, k, v, q_segment_ids,
                    kv_segment_ids, do, lse, delta)
    ptrs, dims = _bwd_args(q, k, v, q_segment_ids, kv_segment_ids, do, lse,
                           delta, causal, scale)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().halva_flash_bwd_dq_bf16(
            *ptrs, dq.data_ptr(), *dims, stream)
    _kernels.check(err, KERNEL_DQ)
    _kernels.launches[KERNEL_DQ] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, q_segment_ids, kv_segment_ids, do, lse,
                            delta, causal: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on CUDA tensors: (dk, dv) (B, Skv, KVH, D) bf16, summed
    over each KV head's query group inside the kernel."""
    _check_bwd_args("flash_attention_bwd_dkv", q, k, v, q_segment_ids,
                    kv_segment_ids, do, lse, delta)
    ptrs, dims = _bwd_args(q, k, v, q_segment_ids, kv_segment_ids, do, lse,
                           delta, causal, scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().halva_flash_bwd_dkv_bf16(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, stream)
    _kernels.check(err, KERNEL_DKV)
    _kernels.launches[KERNEL_DKV] += 1
    return dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) bf16 from K2 and K3, in the inputs' layouts; o and lse
    are K1's outputs for the same inputs."""
    if o.shape != q.shape or o.device != q.device:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} on "
                         f"{o.device} for q {tuple(q.shape)} on {q.device}")
    do = do.contiguous()
    delta = flash_attention_delta(o, do)
    args = (q, k, v, q_segment_ids, kv_segment_ids, do, lse.contiguous(),
            delta, causal, scale)
    dq = flash_attention_bwd_dq(*args)
    dk, dv = flash_attention_bwd_dkv(*args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (no gradient into the segment ids)."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, q_segment_ids, kv_segment_ids,
                                     causal, scale)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, q_seg, kv_seg, o, lse, do,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


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
    """Segment-id flash attention; layout as halva_tpu's flash_attention.
    Differentiable in q, k and v on both devices."""
    if alibi or sliding_window is not None or q_offset is not None:
        raise NotImplementedError(
            "flash_attention: ALiBi, sliding window and q_offset are not "
            "ported yet (ROADMAP queue 2, K1 modes)"
        )
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_segment_ids, kv_segment_ids, causal, scale
        )
    return _FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids,
                                 causal, scale)
