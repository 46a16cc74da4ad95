"""int8 weights for serving: quantizers, W8A8 and weight-dequant matmuls.

Counterpart of halva_tpu/ops/quant.py (int8 part; NF4 is not ported yet).
Symmetric absmax int8: per output channel for dense kernels (..., in, out),
per row for vocab-sized embedding tables. The quantizers run on any device
and give the same int8 bytes and bf16 scale bits as the reference's host
quantizer: fp32 absmax, round half to even, clip to [-127, 127].

The int8 matmul of W8A8 is a plain library product (`torch._int_mm`), as the
reference leaves it to XLA; no Pallas kernel sits on this path.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

Params = Dict[str, Any]


def _absmax_int8(w: torch.Tensor, dim: int):
    w32 = w.float()
    absmax = w32.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kernel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., in, out) -> int8 kernel + (..., 1, out) bf16 scales."""
    q, scale = _absmax_int8(w, -2)
    return {"kernel_q": q, "kernel_scale": scale.to(torch.bfloat16)}


def quantize_embedding(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(V, D) -> int8 rows + (V, 1) bf16 scales."""
    q, scale = _absmax_int8(w, -1)
    return {"embedding_q": q, "embedding_scale": scale.to(torch.bfloat16)}


def quantize_params(params: Params, quantize_embed: bool = True) -> Params:
    """Every 2-D/3-D dense kernel -> int8 (`kernel_q`, `kernel_scale`), and
    vocab tables (>= 4096 rows) -> `embedding_q` when quantize_embed.
    Sibling leaves (biases) are kept; the input tree is not modified."""

    def rewrite(node):
        if isinstance(node, (list, tuple)):
            return type(node)(rewrite(x) for x in node)
        if not isinstance(node, dict):
            return node
        if "kernel" in node and node["kernel"].ndim in (2, 3):
            out = {k: v for k, v in node.items() if k != "kernel"}
            out.update(quantize_kernel(node["kernel"]))
            return out
        if (
            quantize_embed
            and "embedding" in node
            and node["embedding"].ndim == 2
            and node["embedding"].shape[0] >= 4096  # vocab tables only
        ):
            out = {k: v for k, v in node.items() if k != "embedding"}
            out.update(quantize_embedding(node["embedding"]))
            return out
        return {k: rewrite(v) for k, v in node.items()}

    return rewrite(params)


def quantize_rows_int8(x: torch.Tensor):
    """(..., D) -> (int8 values, fp32 (..., 1) scales), symmetric absmax
    over the last dim: dynamic per-token activations, per-(token, head)
    KV."""
    return _absmax_int8(x, -1)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s8 (M, K) x s8 (K, N) -> s32 (M, N) through torch._int_mm. On CUDA
    it needs M > 16 (and K, N multiples of 8): a decode batch is padded
    with zero rows, which are dropped again."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros((32 - m, a.shape[1]))])
    return torch._int_mm(a.contiguous(), b.contiguous())[:m]


def int8_dense(x: torch.Tensor, kernel_q: torch.Tensor,
               kernel_scale: torch.Tensor) -> torch.Tensor:
    """W8A8: per-token int8 activations times per-channel int8 weights,
    exact s32 accumulation, then y = acc * sx * sw in fp32, cast to x's
    dtype."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, sx = quantize_rows_int8(x.reshape(-1, k))
    acc = int_matmul(xq, kernel_q)
    y = acc.float() * sx * kernel_scale.float()
    return y.to(x.dtype).reshape(*lead, -1)


def w8_dense(x: torch.Tensor, kernel_q: torch.Tensor,
             kernel_scale: torch.Tensor) -> torch.Tensor:
    """Weight-dequant int8 matmul: x @ (kernel_q * kernel_scale) in x's
    dtype."""
    w = kernel_q.to(x.dtype) * kernel_scale.to(x.dtype)
    return x @ w


def dequantize_kernel(p: Params, dtype=torch.bfloat16) -> torch.Tensor:
    return (p["kernel_q"].float() * p["kernel_scale"].float()).to(dtype)


def embed_lookup(p: Params, ids: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Quantization-aware embedding lookup. An int8 table gives `dtype`
    (bf16 by default) whatever the tree's float dtype, as the reference."""
    if "embedding_q" in p:
        rows = p["embedding_q"][ids].float()
        return (rows * p["embedding_scale"][ids].float()).to(dtype)
    return p["embedding"][ids]


# Routing switches, read from the environment once, as the reference's:
# HALVA_W8A8 (default on) and HALVA_W4A8 (default off).
_W8A8 = None
_W4A8 = None


def w8a8_enabled() -> bool:
    """Whether int8 kernels run as W8A8 (int8 activations) instead of
    weight dequant. HALVA_W8A8=0 turns it off."""
    global _W8A8
    if _W8A8 is None:
        _W8A8 = os.environ.get("HALVA_W8A8", "1") != "0"
    return _W8A8


def set_w8a8(enabled: bool) -> None:
    global _W8A8
    _W8A8 = bool(enabled)


def w4a8_enabled() -> bool:
    """Whether per-channel int4 prefill matmuls run as W4A8
    (w4_matmul.w4a8_dense). HALVA_W4A8=1 turns it on."""
    global _W4A8
    if _W4A8 is None:
        _W4A8 = os.environ.get("HALVA_W4A8", "0") == "1"
    return _W4A8


def set_w4a8(enabled: bool) -> None:
    global _W4A8
    _W4A8 = bool(enabled)
