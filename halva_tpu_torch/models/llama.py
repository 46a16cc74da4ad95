"""Llama-family decoder (Llama, Mistral, MPT), in plain PyTorch.

Counterpart of halva_tpu/models/llama.py with the same param tree: per-layer
weights stacked on a leading `num_layers` axis, dense kernels (in, out). The
reference's `lax.scan` over layers is a Python loop over per-layer views
(`layer_slice`, `unstack_layers`). KV caches are head-major
(L, B, KVH, S, Dh), as the decode kernel wants them.

Ported here: dense kernels (+ bias, + LoRA) in float, int8 (`kernel_q`:
W8A8, or weight dequant through K8), NF4 (`kernel_q4`) and packed int4
(`kernel_q4p`), int8 embeddings,
RMSNorm / bias-free LayerNorm, RoPE (HF half-split, fp32 tables, linear
scaling) or ALiBi (MPT: no rotation, a per-head distance bias inside the
flash kernels), the Mistral sliding window (inside the flash kernels), the
forward (with per-layer rematerialisation for training),
prefill into a bf16, int8 or int4 prompt cache, and the KV-cached decode
step over a bf16 or int8 gen cache, with `beam_k` beams per item against
an item-row prompt cache, and the K-token speculative verify step
(`verify_step`, K5's shared gen stage). An int4 tree decodes through
`_decode_step_w4`, and verifies, through K6 (up to `W4_GEMV_MAX_ROWS` rows)
or K7 (above) for every layer matmul and K4 or K5 for attention. A config
whose head dim the kernels are not built for (128 and 256: Gemma-2B's is
256) takes the plain versions of all of them under attn_impl="auto"
(`ops/attention.kernel_route`); at 128 and 256 a forward with grad enabled
(training) runs K1 and its backward K2 and K3. The decode kernels K4 and
K5 carry no bias and no window, as the Pallas kernels they replace: an
ALiBi decode step, and a windowed one whose cache outgrows the window, take
the position-aware plain attention (`decode_step`, the reference's rule).
`verify_step` and per-row gen validity are RoPE-only without a window, as
in the reference.

Manual tensor parallelism (`tp`, `tp_group`: prefill, decode_step and the
packed-int4 step, the reference's tp / tp_axis): the caller passes this
rank's shards of the layer stacks (parallel/partition.eval_shmap_pspecs:
wq/wk/wv/gate/up by output columns, wo/down by input rows); the model
computes on its num_heads/tp and kv_heads/tp local heads (the caches hold
them) and all-reduces the outputs of wo and down over `tp_group`, so the
kernels run unchanged on the local shards. Gather-at-use (the other route)
hands `layer_slice` a partition.GatheredLayers, whose layers arrive
all-gathered.

Shapes: B batch, S sequence, D hidden, H heads, Dh head dim, V vocab.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from halva_tpu_torch.config import LlamaConfig
from halva_tpu_torch.ops import quant
from halva_tpu_torch.ops.attention import (
    alibi_bias,
    attention,
    kernel_route,
)
from halva_tpu_torch.ops.decode_attention import (
    decode_attend_layer,
    decode_attend_plain,
    fold_attend_layer,
    fold_attend_plain,
)
from halva_tpu_torch.ops.w4_matmul import (
    dequantize_int4,
    w4_decode_matmul,
    w4_dense_stacked_plain,
    w4a8_dense,
)
from halva_tpu_torch.parallel.mesh import all_reduce
from halva_tpu_torch.parallel.partition import GatheredLayers

Params = Dict[str, Any]


def _mlp_act(cfg: LlamaConfig):
    if cfg.mlp_act == "silu":
        return F.silu
    if cfg.mlp_act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if cfg.mlp_act == "gelu":
        return F.gelu
    raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}")


# --------------------------------------------------------------------------
# Primitive layers
# --------------------------------------------------------------------------


def dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    """y = x @ kernel [+ bias] [+ lora_scale * (x @ lora_a) @ lora_b]; the
    kernel may be packed int4 (`kernel_q4p`: W4A8 when the scales are per
    channel and W4A8 is on, else bf16 dequant then matmul), NF4
    (`kernel_q4`) or int8 (`kernel_q`: W8A8 when on, else weight dequant,
    K8 on the card). Every branch is differentiable in x, the quantized
    ones with the reference's pinned backward (ops/quant.py). The LoRA
    branch keys on `lora_a`: a `lora_scale` standing alone (the frozen
    reference tree of train/trainer.py keeps it) adds nothing."""
    if "kernel_q4p" in p:
        if quant.w4a8_enabled() and p["kernel_scale4p"].shape[1] == 1:
            y = w4a8_dense(x, p["kernel_q4p"], p["kernel_scale4p"])
        else:
            y = x @ dequantize_int4(p["kernel_q4p"], p["kernel_scale4p"],
                                    x.dtype)
    elif "kernel_q4" in p:
        y = quant.nf4_dense(x, p["kernel_q4"], p["kernel_scale4"])
    elif "kernel_q" in p:
        if quant.w8a8_enabled():
            y = quant.int8_dense(x, p["kernel_q"], p["kernel_scale"])
        else:
            y = quant.w8_dense(x, p["kernel_q"], p["kernel_scale"])
    else:
        y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    if "lora_a" in p:
        lo = (x @ p["lora_a"].to(x.dtype)) @ p["lora_b"].to(x.dtype)
        y = y + p["lora_scale"].to(x.dtype) * lo
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
    """The (V, D) table; an int8 table dequantized in fp32."""
    ep = params["embed"]
    if "embedding_q" in ep:
        return ep["embedding_q"].float() * ep["embedding_scale"].float()
    return ep["embedding"]


def embed(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; out-of-range ids (the -200 image sentinel,
    -100 ignore) are clamped to 0 and overwritten by the splice. An int8
    table gives bf16 rows whatever the tree's dtype (quant.embed_lookup)."""
    ep = params["embed"]
    table = ep.get("embedding", ep.get("embedding_q"))
    ids = input_ids.clamp(0, table.shape[0] - 1)
    if "embedding_q" in ep:
        return quant.embed_lookup(ep, ids)
    return F.embedding(ids, table)


def _norm(cfg: LlamaConfig, x: torch.Tensor, scale: torch.Tensor):
    if cfg.norm_type == "layernorm":
        return layer_norm_np(x, scale, cfg.rms_norm_eps)
    return rms_norm(x, scale, cfg.rms_norm_eps, cfg.rmsnorm_unit_offset)


def layer_slice(layers: Params, li: int) -> Params:
    """Layer `li` of the stacked layer tree (views, no copies; a
    GatheredLayers all-gathers its shards of the layer)."""
    if isinstance(layers, GatheredLayers):
        return layers.layer(li)
    if isinstance(layers, dict):
        return {k: layer_slice(v, li) for k, v in layers.items()}
    return layers[li]


def _mlp(cfg: LlamaConfig, y: torch.Tensor, mp: Params) -> torch.Tensor:
    act = _mlp_act(cfg)
    if cfg.gated_mlp:
        return dense(act(dense(y, mp["gate"])) * dense(y, mp["up"]),
                     mp["down"])
    return dense(act(dense(y, mp["up"])), mp["down"])


def _tp_reduce(tp: int, tp_group):
    """The sum over the model group of a row-split dense's output (the
    reference's psum); the identity without TP."""
    if tp > 1:
        return lambda y: all_reduce(y, tp_group)
    return lambda y: y


def _local_heads(cfg: LlamaConfig, tp: int) -> Tuple[int, int]:
    if tp > 1 and cfg.position_embedding == "alibi":
        raise ValueError("manual TP takes no ALiBi: the kernels derive a "
                         "head's slope from its index "
                         "(parallel/partition.manual_tp_ready)")
    return cfg.num_heads // tp, cfg.kv_heads // tp


def _attn_block(cfg, lp, x, cos, sin, segment_ids, attn_impl, tp=1,
                red=None):
    """Pre-norm attention sublayer; returns (x + attn, k (roped under RoPE),
    v). Under manual TP (`tp` local heads' shards) `red` all-reduces wo's
    output."""
    b, s, _ = x.shape
    h, kvh = _local_heads(cfg, tp)
    dh = cfg.head_size
    ap = lp["attn"]
    y = _norm(cfg, x, lp["input_norm"]["scale"])
    q = dense(y, ap["wq"]).reshape(b, s, h, dh)
    k = dense(y, ap["wk"]).reshape(b, s, kvh, dh)
    v = dense(y, ap["wv"]).reshape(b, s, kvh, dh)
    if cfg.position_embedding == "rope":
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    # the Mistral window and the MPT bias are computed inside the flash
    # kernels (ops/attention.py; the plain path materializes mask and bias)
    out = attention(q, k, v, segment_ids, segment_ids, causal=True,
                    impl=attn_impl,
                    alibi=cfg.position_embedding == "alibi",
                    sliding_window=cfg.sliding_window)
    o = dense(out.reshape(b, s, h * dh), ap["wo"])
    return x + (o if red is None else red(o)), k, v


def _layer(cfg, attn_impl, x, lp, cos, sin, segment_ids, gather=None):
    """One decoder layer: attention sublayer, then the MLP sublayer.
    `gather` takes the layer's shards to the whole layer (gather-at-use)."""
    if gather is not None:
        lp = gather(lp)
    x, _, _ = _attn_block(cfg, lp, x, cos, sin, segment_ids, attn_impl)
    return x + _mlp(cfg, _norm(cfg, x, lp["post_attn_norm"]["scale"]),
                    lp["mlp"])


def unstack_layers(layers: Params) -> List[Params]:
    """The per-layer trees of a stacked layer tree, as views from one
    `unbind` per leaf: autograd then stacks the layers' grads of a leaf once,
    where `layer_slice` would scatter each into a zeroed full-size tensor."""
    if isinstance(layers, dict):
        per_key = {k: unstack_layers(v) for k, v in layers.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[li] for k, v in per_key.items()} for li in range(n)]
    return layers.unbind(0)


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
    remat: bool = False,
) -> torch.Tensor:
    """Decoder stack over input embeddings; final hidden states after the
    final norm (B, S, D).

    remat: when autograd records, each layer is a non-reentrant
    `torch.utils.checkpoint` region (the reference's `jax.checkpoint(...,
    nothing_saveable)` per layer): the forward keeps only the layer inputs,
    and the backward runs each layer again before its gradient (so K1 runs
    once more per layer).

    A stack of shards (partition.GatheredLayers: serving's gather-at-use,
    or TrainGatheredLayers on a train mesh) is unbound into each layer's
    shards, and the layer is gathered inside `_layer`, so inside the remat
    region: the backward gathers it again, and a gathered layer is alive
    only while it runs."""
    cos, sin = rope_cos_sin(positions, cfg.head_size, cfg.rope_theta,
                            cfg.rope_scaling)
    x = inputs_embeds
    remat = remat and torch.is_grad_enabled()
    stack = params["layers"]
    gather = stack.gather if isinstance(stack, GatheredLayers) else None
    for lp in unstack_layers(stack):
        if remat:
            # no randomness in a layer: no RNG state to stash and restore
            x = checkpoint(_layer, cfg, attn_impl, x, lp, cos, sin,
                           segment_ids, gather, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer(cfg, attn_impl, x, lp, cos, sin, segment_ids, gather)
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
# slot per step). Both head-major (L, B, KVH, S, Dh). Prompt caches are
# bf16 {k, v}, int8 {k, v, k_scale, v_scale} (scales (L, B, KVH, S)) or int4
# {k4, v4, k_scale, v_scale} (token pairs packed along S, scales
# (L, B, 2, KVH, ceil(S/2)) with the even/odd plane ahead of the heads);
# gen caches bf16 or int8 with (L, B, KVH, Sg) scales.
# --------------------------------------------------------------------------

KV_QUANT = (False, True, "int8", "int4")


def init_gen_cache(
    cfg: LlamaConfig,
    batch: int,
    max_new: int,
    dtype=torch.bfloat16,
    device="cuda",
    quantized: bool = False,
    tp: int = 1,
) -> Params:
    """Zeroed gen cache (L, B, KVH, Sg, Dh); quantized: int8 values with
    per-(head, slot) bf16 scales (ones). Sg is max_new rounded up to a
    multiple of 128, as in the reference, so the shapes agree; slots past
    the current step stay invalid. Under manual TP it holds the kv_heads/tp
    local heads."""
    sg = -(-max_new // 128) * 128
    shape = (cfg.num_layers, batch, cfg.kv_heads // tp, sg, cfg.head_size)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.ones(shape[:-1], dtype=torch.bfloat16,
                                  device=device),
            "v_scale": torch.ones(shape[:-1], dtype=torch.bfloat16,
                                  device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Dh) -> int8 values + per-leading-dims bf16 scales (symmetric
    absmax/127 over the head dim)."""
    q, scale = quant.quantize_rows_int8(t)
    return q, scale[..., 0].to(torch.bfloat16)


def _quantize_kv4(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, KVH, S, Dh), S even -> (packed (B, KVH, S/2, Dh) int8 with token
    2r in the low nibble and 2r+1 in the high nibble, scales (B, 2, KVH,
    S/2) bf16 with the even/odd plane leading). Symmetric absmax/7 per
    (token, head), values in [-7, 7]."""
    if t.shape[2] % 2:
        raise ValueError("int4 KV packing needs an even sequence length")
    t32 = t.float()
    absmax = t32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 7.0)
    q = torch.clamp(torch.round(t32 / scale), -7, 7).to(torch.int32)
    packed = (q[:, :, 1::2] << 4) | (q[:, :, 0::2] & 0xF)  # [0, 255]
    packed = (packed - 256 * (packed > 127).to(torch.int32)).to(torch.int8)
    sc = scale[..., 0]  # (B, KVH, S)
    scales = torch.stack([sc[:, :, 0::2], sc[:, :, 1::2]], dim=1)
    return packed, scales.to(torch.bfloat16)


def _store_prompt_kv(cache: Params, li: int, kh: torch.Tensor,
                     vh: torch.Tensor, quantize_cache) -> None:
    """Write layer li's head-major k, v (B, KVH, S, Dh) into the prompt
    cache in its format."""
    if quantize_cache == "int4":
        if kh.shape[2] % 2:  # one dead token slot (segment 0 downstream)
            kh, vh = F.pad(kh, (0, 0, 0, 1)), F.pad(vh, (0, 0, 0, 1))
        for name, t in (("k", kh), ("v", vh)):
            q, sc = _quantize_kv4(t)
            cache[name + "4"][li] = q
            cache[name + "_scale"][li] = sc
    elif quantize_cache:
        for name, t in (("k", kh), ("v", vh)):
            q, sc = _quantize_kv(t)
            cache[name][li] = q
            cache[name + "_scale"][li] = sc
    else:
        cache["k"][li].copy_(kh)
        cache["v"][li].copy_(vh)


def prefill(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    segment_ids: torch.Tensor,  # (B, S) int32
    positions: torch.Tensor,  # (B, S)
    cache_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    quantize_cache=False,
    tp: int = 1,
    tp_group=None,
) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward writing the prompt cache.

    Returns (final hidden states (B, S, D), prompt cache). quantize_cache:
    False = `cache_dtype` {k, v}; True | "int8" = int8 values + per-(token,
    head) scales; "int4" = nibble-packed token pairs (an odd S gets one
    dead padding slot). Prompts are right-padded; padding keys carry
    segment id 0 so decode steps never attend to them. tp / tp_group:
    manual TP on this rank's shards (module docstring); the cache holds
    the local heads."""
    if quantize_cache not in KV_QUANT:
        raise ValueError(f"quantize_cache must be one of {KV_QUANT}, got "
                         f"{quantize_cache!r}")
    b, s, _ = inputs_embeds.shape
    cos, sin = rope_cos_sin(positions, cfg.head_size, cfg.rope_theta,
                            cfg.rope_scaling)
    nl, kvh, dh = cfg.num_layers, _local_heads(cfg, tp)[1], cfg.head_size
    red = _tp_reduce(tp, tp_group)
    dev = inputs_embeds.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    if quantize_cache == "int4":
        s2 = -(-s // 2)
        cache = {n: empty((nl, b, kvh, s2, dh), torch.int8)
                 for n in ("k4", "v4")}
        cache.update({n: empty((nl, b, 2, kvh, s2), torch.bfloat16)
                      for n in ("k_scale", "v_scale")})
    elif quantize_cache:
        cache = {n: empty((nl, b, kvh, s, dh), torch.int8)
                 for n in ("k", "v")}
        cache.update({n: empty((nl, b, kvh, s), torch.bfloat16)
                      for n in ("k_scale", "v_scale")})
    else:
        cache = {n: empty((nl, b, kvh, s, dh), cache_dtype)
                 for n in ("k", "v")}
    x = inputs_embeds
    for li in range(nl):
        lp = layer_slice(params["layers"], li)
        x, k, v = _attn_block(cfg, lp, x, cos, sin, segment_ids, attn_impl,
                              tp, red)
        x = x + red(_mlp(cfg, _norm(cfg, x, lp["post_attn_norm"]["scale"]),
                         lp["mlp"]))
        _store_prompt_kv(cache, li, k.transpose(1, 2), v.transpose(1, 2),
                         quantize_cache)
    return _norm(cfg, x, params["final_norm"]["scale"]), cache


Step = Union[int, torch.Tensor]


def step_index(step: Step, device) -> torch.Tensor:
    """The decode step as a (1,) int64 index on `device`: from a host int
    (a fill, no copy from the host) or from a 0-d device tensor (a view),
    so that a step held on the card is never read on the host."""
    if isinstance(step, torch.Tensor):
        return step.reshape(1).long()
    return torch.full((1,), step, dtype=torch.long, device=device)


def _write_gen(gen: Params, k: torch.Tensor, v: torch.Tensor, li: int,
               step: Step) -> None:
    """Write this layer's new k, v (B, 1, KVH, Dh) at gen slot `step` (an
    int or a 0-d device tensor), in place (the reference returns an updated
    copy), quantized with per-(head, slot) scales when the cache is int8."""
    idx = step_index(step, k.device)
    for name, t in (("k", k[:, 0]), ("v", v[:, 0])):
        if "k_scale" in gen:
            q, sc = _quantize_kv(t)
            gen[name][li].index_copy_(2, idx, q[:, :, None])
            gen[name + "_scale"][li].index_copy_(2, idx, sc[:, :, None])
        else:
            gen[name][li].index_copy_(2, idx, t[:, :, None].to(
                gen[name].dtype))


def _layer_cache(cache: Params, li: int) -> Params:
    return {key: t[li] for key, t in cache.items()}


def _decode_attend(q, prompt_l, prompt_seg, gen_l, gen_valid, attn_impl,
                   beam_k=1, beam_route="auto", bias_p=None, bias_g=None):
    """K4, or K5 for beams (ops/decode_attention.py); the plain version when
    the route is "plain" (named, or "auto" at a head dim the kernels are not
    built for) or a bias comes with the step (the kernels carry none)."""
    if kernel_route(attn_impl, q.shape[-1]) == "plain" or bias_p is not None:
        return decode_attend_plain(q, prompt_l, prompt_seg, gen_l, gen_valid,
                                   beam_k, bias_p, bias_g)
    return decode_attend_layer(q, prompt_l, prompt_seg, gen_l, gen_valid,
                               beam_k, beam_route)


def decode_positions(cfg: LlamaConfig, positions: torch.Tensor,
                     prompt_seg: torch.Tensor, gen_valid: torch.Tensor,
                     step: Step, beam_k: int = 1):
    """The position-aware part of a decode step, as the reference's
    `decode_step` computes it: (prompt_seg, gen_valid, bias_p, bias_g,
    pos_ok).

    Cached keys sit at known positions: prompts are right-padded and
    contiguous from 0 (position = index), gen slot s' holds position
    positions - step + s'. A sliding window drops gen slots and, once the
    cache can outgrow it, prompt keys (by zeroing their segment id) older
    than the window. ALiBi gives the biases bias_p (B items, H, Sp) and
    bias_g (B rows, H, Sg). pos_ok says whether the decode kernels compute
    this step's attention: they carry no bias and no window, so ALiBi never
    is, and a window only while the whole cache fits inside it (it then
    masks nothing)."""
    alibi = cfg.position_embedding == "alibi"
    window = cfg.sliding_window
    bb, sp = prompt_seg.shape
    sg = gen_valid.shape[1]
    pos_ok = not alibi and (window is None or sp + sg <= window)
    bias_p = bias_g = None
    if not alibi and window is None:
        return prompt_seg, gen_valid, bias_p, bias_g, pos_ok
    dev = positions.device
    # beams of an item share positions (lockstep): every beam_k-th row
    pos_item = positions.reshape(bb, beam_k)[:, 0]
    kpos_p = torch.arange(sp, device=dev).expand(bb, sp)
    kpos_g = positions[:, None] - step + torch.arange(sg, device=dev)[None]
    if window is not None:
        gen_valid = gen_valid & (positions[:, None] - kpos_g < window)
        if sp + sg > window:
            prompt_seg = torch.where(pos_item[:, None] - kpos_p < window,
                                     prompt_seg,
                                     torch.zeros_like(prompt_seg))
    if alibi:
        bias_p = alibi_bias(cfg.num_heads, pos_item[:, None], kpos_p)[:, :, 0]
        bias_g = alibi_bias(cfg.num_heads, positions[:, None],
                            kpos_g)[:, :, 0]
    return prompt_seg, gen_valid.contiguous(), bias_p, bias_g, pos_ok


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    token_embeds: torch.Tensor,  # (B, 1, D)
    positions: torch.Tensor,  # (B,) absolute position of this token
    prompt_cache: Params,  # read-only, (L, B, KVH, Sp, Dh) leaves
    prompt_seg: torch.Tensor,  # (B, Sp) 0 = padding, Sp the true length
    gen_cache: Params,  # (L, B, KVH, Sg, Dh) leaves, updated in place
    step: Step,  # decode step = gen slot to write: int or 0-d tensor
    attn_impl: str = "auto",
    beam_k: int = 1,
    beam_route: str = "auto",
    gen_valid_override: Optional[torch.Tensor] = None,
    write_slot: Optional[Step] = None,
    tp: int = 1,
    tp_group=None,
) -> Tuple[torch.Tensor, Params]:
    """One decode step: (fp32 logits (B, V), gen cache). The new token's KV
    goes to gen slot `step` (lockstep across rows; a host int or, as the
    reference's `()` int32 array, a 0-d device tensor, which nothing reads
    on the host, so the step can run from a CUDA graph); its position (RoPE,
    ALiBi, window) is per-row `positions`. Attention goes through K4 for
    CUDA tensors; a packed-int4 tree takes `_decode_step_w4`.
    attn_impl="plain" takes the plain versions of the kernels instead.

    An ALiBi config, and a sliding-window one whose prompt plus gen cache
    can outgrow the window, attend through `decode_attend_plain` with the
    step's bias and window mask on either device, as the reference sends
    them to its XLA attention (halva_tpu/models/llama.py:896-900): the
    decode kernels, like the Pallas ones, carry neither. That choice comes
    from the config and the cache shapes, never from a failure. A
    packed-int4 tree then runs the generic layer loop, whose `dense`
    dequantizes (the reference's route too).

    beam_k > 1 (ops/beam.py): token_embeds, positions and the gen cache carry
    B*K beam rows while the prompt cache and prompt_seg stay at B item rows;
    row r attends prompt row r // K, through K5 (beam_route "fold"), K4's
    beam mode ("grid"), or the one `auto_beam_route` picks ("auto").

    gen_valid_override (B, Sg) bool / write_slot (an int or a 0-d tensor):
    the continuous-batching engine (ops/continuous.py) runs rows at per-row
    local steps over a ring-buffered gen cache. The KV write goes to the one
    slot `write_slot` instead of `step`, and validity is the caller's per-row
    ring mask instead of the lockstep `slot <= step`. K4 reads validity per
    slot either way. RoPE only, without a window, as in the reference: the
    key positions of ALiBi and a window assume lockstep gen slots.

    tp / tp_group: manual TP on this rank's shards (module docstring); the
    caches hold the local heads."""
    b = token_embeds.shape[0]
    if beam_k < 1 or b % beam_k or prompt_seg.shape[0] * beam_k != b:
        raise ValueError(f"decode_step: {b} rows are not beam_k={beam_k} "
                         f"beams of {prompt_seg.shape[0]} prompt rows")
    (h, kvh), dh = _local_heads(cfg, tp), cfg.head_size
    red = _tp_reduce(tp, tp_group)
    sg = gen_cache["k"].shape[3]
    rope = cfg.position_embedding == "rope"
    cos, sin = rope_cos_sin(positions[:, None], dh, cfg.rope_theta,
                            cfg.rope_scaling)
    dev = token_embeds.device
    if gen_valid_override is not None:
        if not rope or cfg.sliding_window:
            raise NotImplementedError(
                "per-row gen validity (continuous batching) supports RoPE "
                "without a sliding window: the key positions of a window "
                "or ALiBi assume lockstep gen slots")
        gen_valid = gen_valid_override.contiguous()
    else:
        gen_valid = (torch.arange(sg, device=dev) <= step).expand(b, sg)
        gen_valid = gen_valid.contiguous()
    if write_slot is None:
        write_slot = step
    prompt_seg, gen_valid, bias_p, bias_g, pos_ok = decode_positions(
        cfg, positions, prompt_seg, gen_valid, step, beam_k)
    if not pos_ok:
        attn_impl = "plain"  # no kernel computes this step's attention
    elif "kernel_q4p" in params["layers"]["attn"]["wq"]:
        return _decode_step_w4(params, cfg, token_embeds, prompt_cache,
                               prompt_seg, gen_cache, write_slot, cos, sin,
                               gen_valid, attn_impl, beam_k, beam_route, tp,
                               red)
    x = token_embeds
    for li in range(cfg.num_layers):
        lp = layer_slice(params["layers"], li)
        ap = lp["attn"]
        y = _norm(cfg, x, lp["input_norm"]["scale"])
        q = dense(y, ap["wq"]).reshape(b, 1, h, dh)
        k = dense(y, ap["wk"]).reshape(b, 1, kvh, dh)
        v = dense(y, ap["wv"]).reshape(b, 1, kvh, dh)
        if rope:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        _write_gen(gen_cache, k, v, li, write_slot)
        out = _decode_attend(q, _layer_cache(prompt_cache, li), prompt_seg,
                             _layer_cache(gen_cache, li), gen_valid,
                             attn_impl, beam_k, beam_route, bias_p, bias_g)
        x = x + red(dense(out.reshape(b, 1, h * dh), ap["wo"]))
        x = x + red(_mlp(cfg, _norm(cfg, x, lp["post_attn_norm"]["scale"]),
                         lp["mlp"]))
    hidden = _norm(cfg, x, params["final_norm"]["scale"])
    return lm_logits(params, cfg, hidden)[:, 0], gen_cache


def _w4_mm(attn_impl: str, head_dim: int):
    """The packed-int4 layer matmul of a decode or verify step: K6 or K7 by
    the number of rows (ops/w4_matmul.w4_decode_matmul) on the kernel route,
    the plain version on the plain one."""
    if kernel_route(attn_impl, head_dim) == "plain":
        return w4_dense_stacked_plain
    return w4_decode_matmul


def _decode_step_w4(params, cfg, token_embeds, prompt_cache, prompt_seg,
                    gen_cache, write_slot, cos, sin, gen_valid, attn_impl,
                    beam_k=1, beam_route="auto", tp=1, red=None):
    """decode_step over packed-int4 layer stacks: all 7 layer matmuls go
    through K6 or, above W4_GEMV_MAX_ROWS rows, K7
    (ops/w4_matmul.w4_decode_matmul) on (B, K) rows and attention through
    K4 (K5 for beams), each on its layer slice (a view).
    Layer biases are not read, as in the reference. A plain route (named, or
    "auto" at a head dim the kernels are not built for, where the reference
    does not run its w4 decode step either) takes the plain versions of all
    of them. Under manual TP (`tp` local heads' shards, tp-packed columns)
    `red` all-reduces the outputs of wo and down."""
    mm = _w4_mm(attn_impl, cfg.head_size)
    act = _mlp_act(cfg)
    red = red or _tp_reduce(1, None)
    b = token_embeds.shape[0]
    (h, kvh), dh = _local_heads(cfg, tp), cfg.head_size
    x = token_embeds
    for li in range(cfg.num_layers):
        lp = layer_slice(params["layers"], li)
        ap, mp = lp["attn"], lp["mlp"]
        y2 = _norm(cfg, x, lp["input_norm"]["scale"])[:, 0]  # (B, D)
        q = apply_rope(mm(y2, ap["wq"]).reshape(b, 1, h, dh), cos, sin)
        k = apply_rope(mm(y2, ap["wk"]).reshape(b, 1, kvh, dh), cos, sin)
        v = mm(y2, ap["wv"]).reshape(b, 1, kvh, dh)
        _write_gen(gen_cache, k, v, li, write_slot)
        out = _decode_attend(q, _layer_cache(prompt_cache, li), prompt_seg,
                             _layer_cache(gen_cache, li), gen_valid,
                             attn_impl, beam_k, beam_route)
        x = x + red(mm(out.reshape(b, h * dh), ap["wo"]))[:, None]
        y2 = _norm(cfg, x, lp["post_attn_norm"]["scale"])[:, 0]
        if cfg.gated_mlp:
            mlp = mm(act(mm(y2, mp["gate"])) * mm(y2, mp["up"]), mp["down"])
        else:
            mlp = mm(act(mm(y2, mp["up"])), mp["down"])
        x = x + red(mlp)[:, None]
    hidden = _norm(cfg, x, params["final_norm"]["scale"])
    return lm_logits(params, cfg, hidden)[:, 0], gen_cache


# --------------------------------------------------------------------------
# Speculative verification: K candidate tokens per row in one pass.
# --------------------------------------------------------------------------


def write_gen_candidates(gen: Params, kc: torch.Tensor, vc: torch.Tensor,
                         gen_len: torch.Tensor) -> None:
    """Write all K candidate KVs of every layer, kc / vc (L, B, K, KVH, Dh),
    at per-row slots gen_len[b] .. gen_len[b] + K - 1 of the head-major
    (L, B, KVH, Sg, Dh) gen cache, in place, quantized when the cache is
    int8: one indexed write per leaf and verify step. A window that would
    run past the cache is moved back to end at its last slot, as the
    reference's `dynamic_update_slice` clamps its start (only rows past
    their budget get there). Rejected candidates need no rollback: validity
    derives from gen_len, and the next step's window covers their slots."""
    nl, b, kq = kc.shape[:3]
    sg = gen["k"].shape[3]
    if kq > sg:
        raise ValueError(f"{kq} candidates do not fit a {sg}-slot gen cache")
    dev = kc.device
    start = gen_len.long().clamp(0, sg - kq)
    slots = start[:, None] + torch.arange(kq, device=dev)  # (B, K)
    rows = torch.arange(b, device=dev)[:, None].expand(b, kq)
    for name, t in (("k", kc), ("v", vc)):
        # the two index tensors lead the result: (B, K, L, KVH[, Dh])
        if "k_scale" in gen:
            q, sc = _quantize_kv(t)
            gen[name][:, rows, :, slots] = q.permute(1, 2, 0, 3, 4)
            gen[name + "_scale"][:, rows, :, slots] = sc.permute(1, 2, 0, 3)
        else:
            gen[name][:, rows, :, slots] = t.permute(1, 2, 0, 3, 4).to(
                gen[name].dtype)


def _verify_attend(q, prompt_l, prompt_seg, gen_l, gen_valid, k, v,
                   attn_impl):
    """K5's shared gen stage (ops/decode_attention.py) unless the route is
    "plain" (named, or "auto" at a head dim the kernels are not built
    for)."""
    plain = kernel_route(attn_impl, q.shape[-1]) == "plain"
    fold = fold_attend_plain if plain else fold_attend_layer
    return fold(q, prompt_l, prompt_seg, gen_l, gen_valid, q.shape[1],
                shared_gen=True, candidates=(k, v))


def verify_step(
    params: Params,
    cfg: LlamaConfig,
    token_embeds: torch.Tensor,  # (B, K, D) [cur, draft_1 .. draft_{K-1}]
    positions: torch.Tensor,  # (B,) absolute position of token 0
    prompt_cache: Params,
    prompt_seg: torch.Tensor,  # (B, Sp)
    gen_cache: Params,  # updated in place
    gen_len: torch.Tensor,  # (B,) valid gen-cache slots
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, Params]:
    """Score K candidate tokens per row in one pass over the model
    (ops/speculative.py drives it): (fp32 logits (B, K, V), position i's
    next-token logits, and the gen cache with all K candidates' KV written
    at slots gen_len .. gen_len + K - 1; the caller advances gen_len by the
    accepted count only). Query i attends the prompt, the gen slots below
    gen_len and the candidates j <= i, whose K/V never pass through the
    cache (K5, shared gen stage). On a packed-int4 tree every layer matmul
    goes through K6 or K7 at B*K rows and layer biases are not read (the
    reference's `_verify_step_w4`); attn_impl="plain" takes the kernels'
    plain versions. RoPE configs without a sliding window only, as in the
    reference (its speculative entry refuses the others, and callers decode
    greedily instead)."""
    if cfg.position_embedding != "rope" or cfg.sliding_window is not None:
        raise NotImplementedError(
            "verify_step supports RoPE, no-sliding-window configs (the "
            "reference's contract, halva_tpu/models/llama.py:1322)")
    b, kq, _ = token_embeds.shape
    h, kvh, dh = cfg.num_heads, cfg.kv_heads, cfg.head_size
    sg = gen_cache["k"].shape[3]
    dev = token_embeds.device
    pos_k = positions[:, None] + torch.arange(kq, device=dev)[None, :]
    cos, sin = rope_cos_sin(pos_k, dh, cfg.rope_theta, cfg.rope_scaling)
    gen_valid = torch.arange(sg, device=dev)[None, :] < gen_len[:, None]
    w4 = "kernel_q4p" in params["layers"]["attn"]["wq"]
    mm = _w4_mm(attn_impl, dh)
    act = _mlp_act(cfg)

    def proj(y, p):  # K6 or K7 over the (B*K, in) rows of a packed-int4 stack
        if w4:
            return mm(y.reshape(b * kq, -1), p).reshape(b, kq, -1)
        return dense(y, p)

    x = token_embeds
    kcs, vcs = [], []
    for li in range(cfg.num_layers):
        lp = layer_slice(params["layers"], li)
        ap, mp = lp["attn"], lp["mlp"]
        y = _norm(cfg, x, lp["input_norm"]["scale"])
        q = apply_rope(proj(y, ap["wq"]).reshape(b, kq, h, dh), cos, sin)
        k = apply_rope(proj(y, ap["wk"]).reshape(b, kq, kvh, dh), cos, sin)
        v = proj(y, ap["wv"]).reshape(b, kq, kvh, dh)
        out = _verify_attend(q, _layer_cache(prompt_cache, li), prompt_seg,
                             _layer_cache(gen_cache, li), gen_valid, k, v,
                             attn_impl)
        x = x + proj(out.reshape(b, kq, h * dh), ap["wo"])
        y = _norm(cfg, x, lp["post_attn_norm"]["scale"])
        if cfg.gated_mlp:
            mlp = proj(act(proj(y, mp["gate"])) * proj(y, mp["up"]),
                       mp["down"])
        else:
            mlp = proj(act(proj(y, mp["up"])), mp["down"])
        x = x + mlp
        kcs.append(k)
        vcs.append(v)
    hidden = _norm(cfg, x, params["final_norm"]["scale"])
    logits = lm_logits(params, cfg, hidden)  # (B, K, V) fp32
    write_gen_candidates(gen_cache, torch.stack(kcs), torch.stack(vcs),
                         gen_len)
    return logits, gen_cache
