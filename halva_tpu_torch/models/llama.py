"""Llama-family decoder, bf16 greedy-decode subset, in plain PyTorch.

Counterpart of halva_tpu/models/llama.py with the same param tree: per-layer
weights stacked on a leading `num_layers` axis, dense kernels (in, out). The
reference's `lax.scan` over layers is a Python loop over layer slices
(`layer_slice`), which are views. KV caches are head-major
(L, B, KVH, S, Dh), as the decode kernel wants them.

Ported here: plain dense kernels (+ bias), RMSNorm / bias-free LayerNorm,
RoPE (HF half-split, fp32 tables, linear scaling), the forward, prefill into
a bf16 prompt cache, and the KV-cached decode step over a bf16 gen cache.
Not ported yet (each raises NotImplementedError naming its ROADMAP slice):
LoRA and quantized weight branches of `dense` / `embed`, ALiBi, sliding
window, int8/int4 KV caches, tensor parallelism and beams.

Shapes: B batch, S sequence, D hidden, H heads, Dh head dim, V vocab.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from halva_tpu_torch.config import LlamaConfig
from halva_tpu_torch.ops.attention import attention
from halva_tpu_torch.ops.decode_attention import (
    decode_attend_layer,
    decode_attend_plain,
)

Params = Dict[str, Any]

_QUANT_KEYS = ("kernel_q", "kernel_q4", "kernel_q4p", "lora_a")


def _mlp_act(cfg: LlamaConfig):
    if cfg.mlp_act == "silu":
        return F.silu
    if cfg.mlp_act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if cfg.mlp_act == "gelu":
        return F.gelu
    raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}")


def _check_supported(cfg: LlamaConfig) -> None:
    if cfg.position_embedding != "rope":
        raise NotImplementedError(
            "ALiBi (MPT) is not ported yet (ROADMAP queue 2, K1 modes)"
        )
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (ROADMAP queue 2, "
            "K1 modes)"
        )


# --------------------------------------------------------------------------
# Primitive layers
# --------------------------------------------------------------------------


def dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    """y = x @ kernel [+ bias]."""
    for key in _QUANT_KEYS:
        if key in p:
            raise NotImplementedError(
                f"dense: '{key}' weights are not ported yet (ROADMAP queue "
                "1: LoRA with the DPA training slice, int8/int4 weights with "
                "the int4 serving slice)"
            )
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def layer_norm_np(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Bias-free LayerNorm (MPT norm convention), fp32 statistics."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return ((x - mean) * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             unit_offset: bool = False) -> torch.Tensor:
    """RMSNorm in fp32, result cast back to the input dtype.
    unit_offset: Gemma convention, effective scale = 1 + w."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    w = scale.float()
    if unit_offset:
        w = 1.0 + w
    return (x * w).to(dtype)


def rope_cos_sin(
    positions: torch.Tensor,  # (B, S) int
    head_dim: int,
    theta: float,
    linear_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (B, S, Dh/2) in fp32."""
    dev = positions.device
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=dev) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    pos = positions.float()
    if linear_scale is not None:
        pos = pos / linear_scale
    angles = pos[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """HF half-split rotation on (B, S, H, Dh): x*cos + rotate_half(x)*sin."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def _embedding_table(params: Params) -> torch.Tensor:
    if "embedding_q" in params["embed"]:
        raise NotImplementedError(
            "quantized embeddings are not ported yet (ROADMAP queue 1, int4 "
            "serving slice)"
        )
    return params["embed"]["embedding"]


def embed(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; out-of-range ids (the -200 image sentinel,
    -100 ignore) are clamped to 0 and overwritten by the splice."""
    table = _embedding_table(params)
    return F.embedding(input_ids.clamp(0, table.shape[0] - 1), table)


def _norm(cfg: LlamaConfig, x: torch.Tensor, scale: torch.Tensor):
    if cfg.norm_type == "layernorm":
        return layer_norm_np(x, scale, cfg.rms_norm_eps)
    return rms_norm(x, scale, cfg.rms_norm_eps, cfg.rmsnorm_unit_offset)


def layer_slice(layers: Params, li: int) -> Params:
    """Layer `li` of the stacked layer tree (views, no copies)."""
    if isinstance(layers, dict):
        return {k: layer_slice(v, li) for k, v in layers.items()}
    return layers[li]


def _mlp(cfg: LlamaConfig, y: torch.Tensor, mp: Params) -> torch.Tensor:
    act = _mlp_act(cfg)
    if cfg.gated_mlp:
        return dense(act(dense(y, mp["gate"])) * dense(y, mp["up"]),
                     mp["down"])
    return dense(act(dense(y, mp["up"])), mp["down"])


def _attn_block(cfg, lp, x, cos, sin, segment_ids, attn_impl):
    """Pre-norm attention sublayer; returns (x + attn, roped k, v)."""
    b, s, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.kv_heads, cfg.head_size
    ap = lp["attn"]
    y = _norm(cfg, x, lp["input_norm"]["scale"])
    q = apply_rope(dense(y, ap["wq"]).reshape(b, s, h, dh), cos, sin)
    k = apply_rope(dense(y, ap["wk"]).reshape(b, s, kvh, dh), cos, sin)
    v = dense(y, ap["wv"]).reshape(b, s, kvh, dh)
    out = attention(q, k, v, segment_ids, segment_ids, causal=True,
                    impl=attn_impl)
    return x + dense(out.reshape(b, s, h * dh), ap["wo"]), k, v


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def forward_embeds(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    segment_ids: torch.Tensor,  # (B, S) int32; 0 = padding
    positions: torch.Tensor,  # (B, S)
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Decoder stack over input embeddings; final hidden states after the
    final norm (B, S, D)."""
    _check_supported(cfg)
    cos, sin = rope_cos_sin(positions, cfg.head_size, cfg.rope_theta,
                            cfg.rope_scaling)
    x = inputs_embeds
    for li in range(cfg.num_layers):
        lp = layer_slice(params["layers"], li)
        x, _, _ = _attn_block(cfg, lp, x, cos, sin, segment_ids, attn_impl)
        x = x + _mlp(cfg, _norm(cfg, x, lp["post_attn_norm"]["scale"]),
                     lp["mlp"])
    return _norm(cfg, x, params["final_norm"]["scale"])


def lm_logits(params: Params, cfg: LlamaConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits."""
    if cfg.tie_word_embeddings:
        out = hidden @ _embedding_table(params).t().to(hidden.dtype)
    else:
        out = dense(hidden, params["lm_head"])
    return out.float()


def forward(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Token-id convenience entry: fp32 logits (B, S, V)."""
    b, s = input_ids.shape
    dev = input_ids.device
    if segment_ids is None:
        segment_ids = torch.ones((b, s), dtype=torch.int32, device=dev)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev).expand(b, s)
    x = embed(params, input_ids)
    if cfg.embed_scale:  # Gemma: embeddings * sqrt(hidden)
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype)
    h = forward_embeds(params, cfg, x, segment_ids, positions, attn_impl)
    return lm_logits(params, cfg, h)


# --------------------------------------------------------------------------
# KV-cached decode: a read-only PROMPT cache (exact prompt length, written by
# prefill) and a small GENERATED cache (max_new slots, written in place one
# slot per step). Both head-major (L, B, KVH, S, Dh).
# --------------------------------------------------------------------------


def init_gen_cache(
    cfg: LlamaConfig,
    batch: int,
    max_new: int,
    dtype=torch.bfloat16,
    device="cpu",
) -> Params:
    """Zeroed gen cache (L, B, KVH, Sg, Dh). Sg is max_new rounded up to a
    multiple of 128, as in the reference, so the shapes agree; slots past
    the current step stay invalid."""
    sg = -(-max_new // 128) * 128
    shape = (cfg.num_layers, batch, cfg.kv_heads, sg, cfg.head_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    segment_ids: torch.Tensor,  # (B, S) int32
    positions: torch.Tensor,  # (B, S)
    cache_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    quantize_cache=False,
) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward writing the prompt cache.

    Returns (final hidden states (B, S, D), {k, v}: (L, B, KVH, S, Dh)).
    Prompts are right-padded; padding keys carry segment id 0 so decode
    steps never attend to them."""
    _check_supported(cfg)
    if quantize_cache:
        raise NotImplementedError(
            "int8/int4 prompt caches are not ported yet (ROADMAP queue 2, "
            "K4 int8/int4 modes)"
        )
    b, s, _ = inputs_embeds.shape
    cos, sin = rope_cos_sin(positions, cfg.head_size, cfg.rope_theta,
                            cfg.rope_scaling)
    shape = (cfg.num_layers, b, cfg.kv_heads, s, cfg.head_size)
    dev = inputs_embeds.device
    cache = {"k": torch.empty(shape, dtype=cache_dtype, device=dev),
             "v": torch.empty(shape, dtype=cache_dtype, device=dev)}
    x = inputs_embeds
    for li in range(cfg.num_layers):
        lp = layer_slice(params["layers"], li)
        x, k, v = _attn_block(cfg, lp, x, cos, sin, segment_ids, attn_impl)
        x = x + _mlp(cfg, _norm(cfg, x, lp["post_attn_norm"]["scale"]),
                     lp["mlp"])
        cache["k"][li].copy_(k.transpose(1, 2))  # head-major
        cache["v"][li].copy_(v.transpose(1, 2))
    return _norm(cfg, x, params["final_norm"]["scale"]), cache


def _write_gen(gen: Params, k: torch.Tensor, v: torch.Tensor, li: int,
               step: int) -> None:
    """Write this layer's new k, v (B, 1, KVH, Dh) at gen slot `step`, in
    place (the reference returns an updated copy)."""
    gen["k"][li, :, :, step] = k[:, 0]
    gen["v"][li, :, :, step] = v[:, 0]


def _decode_attend(q, prompt_l, prompt_seg, gen_l, gen_valid, attn_impl):
    """K4 (ops/decode_attention.py) unless attn_impl is "plain"."""
    if attn_impl == "plain":
        return decode_attend_plain(q, prompt_l, prompt_seg, gen_l, gen_valid)
    return decode_attend_layer(q, prompt_l, prompt_seg, gen_l, gen_valid)


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    token_embeds: torch.Tensor,  # (B, 1, D)
    positions: torch.Tensor,  # (B,) absolute position of this token
    prompt_cache: Params,  # read-only {k, v}: (L, B, KVH, Sp, Dh)
    prompt_seg: torch.Tensor,  # (B, Sp) 0 = padding
    gen_cache: Params,  # {k, v}: (L, B, KVH, Sg, Dh), updated in place
    step: int,  # decode step = gen slot to write
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, Params]:
    """One decode step: (fp32 logits (B, V), gen cache). The new token's KV
    goes to gen slot `step` (lockstep across rows); its RoPE position is
    per-row `positions`. Attention goes through K4 for CUDA tensors."""
    _check_supported(cfg)
    if "k_scale" in prompt_cache or "k4" in prompt_cache:
        raise NotImplementedError(
            "int8/int4 prompt caches are not ported yet (ROADMAP queue 2, "
            "K4 int8/int4 modes)"
        )
    b = token_embeds.shape[0]
    h, kvh, dh = cfg.num_heads, cfg.kv_heads, cfg.head_size
    sg = gen_cache["k"].shape[3]
    cos, sin = rope_cos_sin(positions[:, None], dh, cfg.rope_theta,
                            cfg.rope_scaling)
    dev = token_embeds.device
    gen_valid = (torch.arange(sg, device=dev) <= step).expand(b, sg)
    gen_valid = gen_valid.contiguous()
    x = token_embeds
    for li in range(cfg.num_layers):
        lp = layer_slice(params["layers"], li)
        ap = lp["attn"]
        y = _norm(cfg, x, lp["input_norm"]["scale"])
        q = apply_rope(dense(y, ap["wq"]).reshape(b, 1, h, dh), cos, sin)
        k = apply_rope(dense(y, ap["wk"]).reshape(b, 1, kvh, dh), cos, sin)
        v = dense(y, ap["wv"]).reshape(b, 1, kvh, dh)
        _write_gen(gen_cache, k, v, li, step)
        out = _decode_attend(
            q,
            {"k": prompt_cache["k"][li], "v": prompt_cache["v"][li]},
            prompt_seg,
            {"k": gen_cache["k"][li], "v": gen_cache["v"][li]},
            gen_valid,
            attn_impl,
        )
        x = x + dense(out.reshape(b, 1, h * dh), ap["wo"])
        x = x + _mlp(cfg, _norm(cfg, x, lp["post_attn_norm"]["scale"]),
                     lp["mlp"])
    hidden = _norm(cfg, x, params["final_norm"]["scale"])
    return lm_logits(params, cfg, hidden)[:, 0], gen_cache
