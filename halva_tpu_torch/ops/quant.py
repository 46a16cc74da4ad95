"""int8 and NF4 weights: quantizers, W8A8, weight-dequant and NF4 matmuls.

Counterpart of halva_tpu/ops/quant.py. Symmetric absmax int8: per output
channel for dense kernels (..., in, out), per row for vocab-sized embedding
tables. The quantizers run on any device and give the same int8 bytes and
bf16 scale bits as the reference's host quantizer: fp32 absmax, round half
to even, clip to [-127, 127]. NF4 (the QLoRA code book): one of 16 code
values per weight, nearest in fp32, per-output-channel absmax scales.

The matmuls are `torch.autograd.Function`s with the reference's pinned
backward, dx = g @ dequant(W).T with the weights dequantized again in g's
dtype, no gradient to the quantized leaves. For `int8_dense` (W8A8) that is
the straight-through estimator: round() has zero derivative almost
everywhere, and plain autograd would reach x only through the absmax scale.
The int8 product of W8A8 is a library product (`torch._int_mm`), as the
reference leaves it to XLA; the weight-dequant product of `w8_dense` is K8
(ops/int8_matmul.py) for the CUDA tensors it takes.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from halva_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_takes

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


# bitsandbytes NF4 code values (the QLoRA paper's table), as the reference's
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367,
    -0.39491748809814453, -0.28444138169288635, -0.18477343022823334,
    -0.09105003625154495, 0.0, 0.07958029955625534,
    0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
    0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
)
_NF4_CHUNK = 1 << 22  # weights per argmin pass: a (chunk, 16) fp32 temporary


def quantize_kernel_nf4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., in, out) -> NF4 code indices `kernel_q4` + (..., 1, out) bf16
    absmax scales `kernel_scale4`; dequant = NF4_CODE[index] * scale.

    torch has no 4-bit integer type: `kernel_q4` holds one code index (0 to
    15) per `torch.uint8` byte, where the reference's `jnp.uint4` packs two,
    so an NF4 tree takes as much device memory as an int8 one. The nearest
    code is the first minimum of |w / scale - code| in fp32, the reference's
    `argmin` with its tie rule, taken over slices of the weights so that the
    16-wide temporary stays small."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    normed = (w32 / scale).reshape(-1)
    code = torch.tensor(NF4_CODE, dtype=torch.float32, device=w.device)
    idx = torch.empty(normed.shape, dtype=torch.uint8, device=w.device)
    for i in range(0, normed.numel(), _NF4_CHUNK):
        part = normed[i:i + _NF4_CHUNK]
        idx[i:i + _NF4_CHUNK] = (part[:, None] - code).abs().argmin(dim=-1)
    return {"kernel_q4": idx.reshape(w.shape),
            "kernel_scale4": scale.to(torch.bfloat16)}


def _nf4_dequant(idx: torch.Tensor, scale: torch.Tensor,
                 dtype) -> torch.Tensor:
    code = torch.tensor(NF4_CODE, dtype=dtype, device=idx.device)
    return code[idx.int()] * scale.to(dtype)


class _NF4Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_q4, kernel_scale4):
        ctx.save_for_backward(kernel_q4, kernel_scale4)
        return x @ _nf4_dequant(kernel_q4, kernel_scale4, x.dtype)

    @staticmethod
    def backward(ctx, g):
        w = _nf4_dequant(*ctx.saved_tensors, g.dtype)
        return g @ w.t(), None, None


def nf4_dense(x: torch.Tensor, kernel_q4: torch.Tensor,
              kernel_scale4: torch.Tensor) -> torch.Tensor:
    """NF4 weight-only matmul (a QLoRA-class frozen base): x @ (NF4_CODE[
    kernel_q4] * kernel_scale4) in x's dtype; the backward dequantizes again
    instead of keeping the float weights."""
    return _NF4Dense.apply(x, kernel_q4, kernel_scale4)


def quantize_params(params: Params, quantize_embed: bool = True,
                    bits: int = 8) -> Params:
    """Every 2-D/3-D dense kernel -> int8 (`kernel_q`, `kernel_scale`) or,
    with bits=4, NF4 (`kernel_q4`, `kernel_scale4`), and vocab tables (>=
    4096 rows) -> int8 `embedding_q` when quantize_embed (at bits=4 too, as
    in the reference). Sibling leaves (biases, LoRA factors) are kept; the
    input tree is not modified."""
    if bits not in (4, 8):
        raise ValueError(f"quantize_params: bits must be 4 or 8, got {bits}")
    qk = quantize_kernel_nf4 if bits == 4 else quantize_kernel

    def rewrite(node):
        if isinstance(node, (list, tuple)):
            return type(node)(rewrite(x) for x in node)
        if not isinstance(node, dict):
            return node
        if "kernel" in node and node["kernel"].ndim in (2, 3):
            out = {k: v for k, v in node.items() if k != "kernel"}
            out.update(qk(node["kernel"]))
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


def _dequant_t(kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
               dtype) -> torch.Tensor:
    """dequant(W).T with the product taken in `dtype`, as the reference's
    backward takes it."""
    return (kernel_q.to(dtype) * kernel_scale.to(dtype)).t()


class _Int8Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_q, kernel_scale):
        ctx.save_for_backward(kernel_q, kernel_scale)
        lead, k = x.shape[:-1], x.shape[-1]
        xq, sx = quantize_rows_int8(x.reshape(-1, k))
        acc = int_matmul(xq, kernel_q)
        y = acc.float() * sx * kernel_scale.float()
        return y.to(x.dtype).reshape(*lead, -1)

    @staticmethod
    def backward(ctx, g):
        return g @ _dequant_t(*ctx.saved_tensors, g.dtype), None, None


def int8_dense(x: torch.Tensor, kernel_q: torch.Tensor,
               kernel_scale: torch.Tensor) -> torch.Tensor:
    """W8A8: per-token int8 activations times per-channel int8 weights,
    exact s32 accumulation, then y = acc * sx * sw in fp32, cast to x's
    dtype. Backward: straight-through, dx = g @ dequant(W).T."""
    return _Int8Dense.apply(x, kernel_q, kernel_scale)


class _W8Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_q, kernel_scale):
        ctx.save_for_backward(kernel_q, kernel_scale)
        if x.device.type == "cpu" or not int8_matmul_takes(
                x, kernel_q, kernel_scale):
            return x @ (kernel_q.to(x.dtype) * kernel_scale.to(x.dtype))
        return int8_matmul(x, kernel_q, kernel_scale)

    @staticmethod
    def backward(ctx, g):
        return g @ _dequant_t(*ctx.saved_tensors, g.dtype), None, None


def w8_dense(x: torch.Tensor, kernel_q: torch.Tensor,
             kernel_scale: torch.Tensor) -> torch.Tensor:
    """Weight-dequant int8 matmul, x @ (kernel_q * kernel_scale) in x's
    dtype: K8 (ops/int8_matmul.py) for CUDA tensors that it takes
    (`int8_matmul_takes`: bf16 x and scales, K % 64 == 0, N % 8 == 0),
    which scales the fp32 sum instead of the weights; that expression itself
    for CPU tensors and for the rest (an fp32 tree's tower), as the
    reference computes it for every shape.
    Backward dx = g @ dequant(W).T."""
    return _W8Dense.apply(x, kernel_q, kernel_scale)


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
