"""Plain MPT-7B decoder block, fp32 (MosaicML's MPTBlock, no_bias).

LayerNorm without bias, fused-in-one q/k/v without bias, multi-head
attention with ALiBi (head h of H adds slope_h * (j - i) to the logit of
query i and key j, slope_h = 2^(-alibi_bias_max * (h + 1) / H) with
alibi_bias_max 8), causal, output projection, residual; LayerNorm, up
projection, exact GELU, down projection, residual. The head is the tied
token embedding after the final LayerNorm. A LoRA branch adds
scale * (x A) B to a dense's output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ALIBI_BIAS_MAX = 8


def layer_norm(x, w, eps):
    return F.layer_norm(x, x.shape[-1:], w, None, eps)


def lin(x, lw, lora, name):
    y = x @ lw[name]
    if lora is not None and name in lora:
        a, b, s = lora[name]
        y = y + s * ((x @ a) @ b)
    return y


def slopes(h: int, device) -> torch.Tensor:
    m = torch.arange(1, h + 1, dtype=torch.float64, device=device)
    return (2.0 ** (-ALIBI_BIAS_MAX * m / h)).float()


def layer(x: torch.Tensor, lw: dict, lora, llm: dict) -> torch.Tensor:
    """x (n, D) fp32 -> (n, D); lw and lora as in mistral.layer."""
    n, d = x.shape
    h = llm["num_heads"]
    dh = d // h
    eps = llm["rms_norm_eps"]
    pos = torch.arange(n, device=x.device)
    y = layer_norm(x, lw["input_norm"], eps)
    q, k, v = (lin(y, lw, lora, w).view(n, h, dh) for w in ("wq", "wk", "wv"))
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
    rel = (pos[None, :] - pos[:, None]).float()  # j - i
    scores = scores + slopes(h, x.device)[:, None, None] * rel
    scores = scores.masked_fill(rel[None] > 0, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", scores.softmax(-1), v).reshape(n, d)
    x = x + lin(o, lw, lora, "wo")
    y = layer_norm(x, lw["post_attn_norm"], eps)
    return x + lin(F.gelu(lin(y, lw, lora, "up")), lw, lora, "down")


def final_norm(x, llm_weights: dict, llm: dict):
    return layer_norm(x, llm_weights["final_norm"]["scale"].float(),
                      llm["rms_norm_eps"])


def head(llm_weights: dict) -> torch.Tensor:
    """The (D, V) output kernel: the token embedding, transposed."""
    return llm_weights["embed"]["embedding"].t()
