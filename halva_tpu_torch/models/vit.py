"""CLIP vision tower (ViT-L/14-336 for LLaVA-1.5) in plain PyTorch.

Counterpart of halva_tpu/models/vit.py, CLIP path: cls token, pre-LayerNorm,
quick_gelu (SigLIP's gelu_tanh and no-cls configs run the same code). The
patch embedding is one matmul over unfolded patches, as in the reference
(not a convolution), and attention is the plain bidirectional
`attention_reference`: the reference runs no Pallas kernel here either.
`encode` returns HF `hidden_states[select_layer]`; LLaVA-1.5 takes -2 with
the cls token dropped ("patch"). InternViT (RMSNorm, qk-norm, LayerScale)
and RADIO are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from halva_tpu_torch.config import ViTConfig
from halva_tpu_torch.models.llama import layer_slice, dense
from halva_tpu_torch.ops.attention import attention_reference

Params = Dict[str, Any]


def layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics, result in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * p["scale"].float() + p["bias"].float()).to(dtype)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu":
        return F.gelu
    raise ValueError(f"unknown activation {name!r}")


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, num_patches, patch*patch*C), row-major patches,
    channel last inside a patch (the conv kernel's (kh, kw, in) order)."""
    b, c, h, w = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 3, 5, 1)  # (B, gh, gw, ph, pw, C)
    return x.reshape(b, gh * gw, patch * patch * c)


def _vit_layer(cfg: ViTConfig, x: torch.Tensor, p: Params) -> torch.Tensor:
    b, n, d = x.shape
    h = cfg.num_heads
    act = _act(cfg.hidden_act)
    y = layer_norm(x, p["ln1"], cfg.layer_norm_eps)
    q = dense(y, p["attn"]["wq"]).reshape(b, n, h, d // h)
    k = dense(y, p["attn"]["wk"]).reshape(b, n, h, d // h)
    v = dense(y, p["attn"]["wv"]).reshape(b, n, h, d // h)
    attn = attention_reference(q, k, v, mask=None)  # bidirectional
    x = x + dense(attn.reshape(b, n, d), p["attn"]["wo"])
    y = layer_norm(x, p["ln2"], cfg.layer_norm_eps)
    return x + dense(act(dense(y, p["mlp"]["fc1"])), p["mlp"]["fc2"])


def encode(
    params: Params,
    cfg: ViTConfig,
    images: torch.Tensor,  # (B, 3, H, W)
    select_layer: int = -2,
    select_feature: str = "patch",
) -> torch.Tensor:
    """The selected hidden state (B, N, D); HF indexing (0 = embeddings,
    i = output of layer i), "patch" drops the prefix tokens."""
    if cfg.norm_type != "layernorm" or cfg.qk_norm or cfg.layer_scale:
        raise NotImplementedError(
            "InternViT towers are not ported yet (ROADMAP queue 1, alt "
            "backends)"
        )
    if select_feature not in ("patch", "cls_patch"):
        raise ValueError(f"unexpected select feature {select_feature!r}")
    b = images.shape[0]
    d = cfg.hidden_size
    kernel = params["patch_embed"]["kernel"].reshape(-1, d)
    # compute in the tower's param dtype (bf16 when serving)
    x = patchify(images, cfg.patch_size).to(kernel.dtype) @ kernel
    if "bias" in params["patch_embed"]:
        x = x + params["patch_embed"]["bias"].to(x.dtype)
    prefix = []
    if cfg.use_cls_token:
        cls = params["cls_token"]["embedding"].to(x.dtype)
        prefix.append(cls.expand(b, 1, d))
    if cfg.num_register_tokens:
        reg = params["register_tokens"]["embedding"].to(x.dtype)
        prefix.append(reg.expand(b, cfg.num_register_tokens, d))
    if prefix:
        x = torch.cat(prefix + [x], dim=1)
    x = x + params["pos_embed"]["embedding"].to(x.dtype)[None]
    if cfg.use_pre_layernorm:
        x = layer_norm(x, params["pre_ln"], cfg.layer_norm_eps)
    # run only up to the selected layer: later layers feed nothing
    for li in range(select_layer % (cfg.num_layers + 1)):
        x = _vit_layer(cfg, x, layer_slice(params["layers"], li))
    if select_feature == "patch":
        return x[:, cfg.num_prefix_tokens:]
    return x
