"""Plain Mistral-7B decoder layer, fp32 (HF MistralDecoderLayer).

RMSNorm, q/k/v without bias, rotary embeddings on the half-split
(rotate_half) layout with inv_freq = theta^(-2i/D), grouped-query attention
(each key/value head serves num_heads / num_kv_heads query heads), causal
with the sliding window (query i sees keys j with i - W < j <= i), output
projection, residual; RMSNorm, SiLU-gated MLP, residual. The head is an
untied (D, V) kernel after the final RMSNorm. A LoRA branch adds
scale * (x A) B to a dense's output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def lin(x, lw, lora, name):
    y = x @ lw[name]
    if lora is not None and name in lora:
        a, b, s = lora[name]
        y = y + s * ((x @ a) @ b)
    return y


def rope(x, positions, theta):
    dh = x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = (positions.double()[:, None] * inv).float()
    c, s = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def layer(x: torch.Tensor, lw: dict, lora, llm: dict) -> torch.Tensor:
    """x (n, D) fp32 -> (n, D). lw: the layer's fp32 weights by short name
    (wq, wk, wv, wo, gate, up, down, input_norm, post_attn_norm); lora:
    None or {name: (A, B, scale)}."""
    n, d = x.shape
    h = llm["num_heads"]
    kvh = llm.get("num_kv_heads") or h
    dh = llm.get("head_dim") or d // h
    eps = llm["rms_norm_eps"]
    pos = torch.arange(n, device=x.device)
    y = rms_norm(x, lw["input_norm"], eps)
    q = rope(lin(y, lw, lora, "wq").view(n, h, dh), pos, llm["rope_theta"])
    k = rope(lin(y, lw, lora, "wk").view(n, kvh, dh), pos, llm["rope_theta"])
    v = lin(y, lw, lora, "wv").view(n, kvh, dh)
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
    dist = pos[:, None] - pos[None, :]
    keep = dist >= 0
    if llm.get("sliding_window"):
        keep = keep & (dist < llm["sliding_window"])
    scores = scores.masked_fill(~keep, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", scores.softmax(-1), v).reshape(n, h * dh)
    x = x + lin(o, lw, lora, "wo")
    y = rms_norm(x, lw["post_attn_norm"], eps)
    m = F.silu(lin(y, lw, lora, "gate")) * lin(y, lw, lora, "up")
    return x + lin(m, lw, lora, "down")


def final_norm(x, llm_weights: dict, llm: dict):
    return rms_norm(x, llm_weights["final_norm"]["scale"].float(),
                    llm["rms_norm_eps"])


def head(llm_weights: dict) -> torch.Tensor:
    """The (D, V) output kernel, in the weights' own dtype."""
    return llm_weights["lm_head"]["kernel"]
