"""Vision towers in plain PyTorch: CLIP, SigLIP, InternViT and RADIO.

Counterpart of halva_tpu/models/vit.py. One functional ViT, driven by
ViTConfig flags: CLIP = cls token, pre-LayerNorm, quick_gelu; SigLIP = no
cls token, no pre-LN, gelu_tanh; InternViT = RMSNorm blocks, an RMSNorm over
the whole embed width on q and k before the head split, LayerScale on both
residual branches, bias-free qkv; RADIO = a timm ViT with register tokens
after the cls token, run by `encode_radio`. The patch embedding is one
matmul over unfolded patches, as in the reference (not a convolution), and
attention is the plain bidirectional `attention_reference`: the reference
runs no Pallas kernel in a tower either. `encode` returns HF
`hidden_states[select_layer]`; LLaVA-1.5 takes -2 with the cls token
dropped ("patch"). `interpolate_pos_embed` resizes the positional grid with
`jax.image.resize`'s bicubic (ops/resize.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from halva_tpu_torch.config import ViTConfig
from halva_tpu_torch.models.llama import dense, layer_slice, rms_norm
from halva_tpu_torch.ops.attention import attention_reference
from halva_tpu_torch.ops.resize import resize

Params = Dict[str, Any]


def layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics, result in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * p["scale"].float() + p["bias"].float()).to(dtype)


def _norm(cfg: ViTConfig, x: torch.Tensor, p: Params) -> torch.Tensor:
    """LayerNorm (CLIP, SigLIP, RADIO) or RMSNorm (InternViT), fp32
    statistics either way."""
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, p["scale"], cfg.layer_norm_eps)
    return layer_norm(x, p, cfg.layer_norm_eps)


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
    channel last inside a patch (the conv kernel's (kh, kw, in) order). A
    side that is no multiple of the patch loses its last pixels, as under
    the towers' stride-`patch` convolution: SigLIP-so400m/14 at 384 px
    takes 27 patches a side and drops 6 pixels (the reference's reshape
    raises there)."""
    b, c, h, w = images.shape
    gh, gw = h // patch, w // patch
    images = images[:, :, :gh * patch, :gw * patch]
    x = images.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 3, 5, 1)  # (B, gh, gw, ph, pw, C)
    return x.reshape(b, gh * gw, patch * patch * c)


def _vit_layer(cfg: ViTConfig, x: torch.Tensor, p: Params) -> torch.Tensor:
    b, n, d = x.shape
    h = cfg.num_heads
    act = _act(cfg.hidden_act)
    y = _norm(cfg, x, p["ln1"])
    q = dense(y, p["attn"]["wq"])
    k = dense(y, p["attn"]["wk"])
    v = dense(y, p["attn"]["wv"]).reshape(b, n, h, d // h)
    if cfg.qk_norm:  # InternViT: over the whole embed width, across heads
        q = rms_norm(q, p["attn"]["q_norm"]["scale"], cfg.layer_norm_eps)
        k = rms_norm(k, p["attn"]["k_norm"]["scale"], cfg.layer_norm_eps)
    q = q.reshape(b, n, h, d // h)
    k = k.reshape(b, n, h, d // h)
    attn = attention_reference(q, k, v, mask=None)  # bidirectional
    attn_out = dense(attn.reshape(b, n, d), p["attn"]["wo"])
    if cfg.layer_scale:
        attn_out = attn_out * p["ls1"]["scale"].to(attn_out.dtype)
    x = x + attn_out
    y = _norm(cfg, x, p["ln2"])
    mlp_out = dense(act(dense(y, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    if cfg.layer_scale:
        mlp_out = mlp_out * p["ls2"]["scale"].to(mlp_out.dtype)
    return x + mlp_out


def encode(
    params: Params,
    cfg: ViTConfig,
    images: torch.Tensor,  # (B, 3, H, W)
    select_layer: int = -2,
    select_feature: str = "patch",
) -> torch.Tensor:
    """The selected hidden state (B, N, D); HF indexing (0 = embeddings,
    i = output of layer i), "patch" drops the prefix tokens."""
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


def interpolate_pos_embed(params: Params, cfg: ViTConfig,
                          new_image_size: int) -> Tuple[Params, ViTConfig]:
    """Resize the positional grid to a new input resolution (VILA's
    vision_resolution_elevation) with jax.image.resize's bicubic, in fp32;
    the cls row, if any, is kept. Returns (new params, new config)."""
    old = params["pos_embed"]["embedding"]
    n_cls = 1 if cfg.use_cls_token else 0
    grid = old[n_cls:]
    side = math.isqrt(grid.shape[0])
    if side * side != grid.shape[0]:
        raise ValueError(f"interpolate_pos_embed: {grid.shape[0]} positions "
                         "are no square grid")
    new_side = new_image_size // cfg.patch_size
    d = grid.shape[-1]
    resized = resize(grid.reshape(side, side, d).float(),
                     (new_side, new_side, d), "bicubic")
    resized = resized.reshape(new_side * new_side, d).to(old.dtype)
    new_params = dict(params)
    new_params["pos_embed"] = {
        "embedding": torch.cat([old[:n_cls], resized]) if n_cls else resized}
    return new_params, dataclasses.replace(cfg, image_size=new_image_size)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def encode_radio(
    params: Params,
    cfg: ViTConfig,
    images: torch.Tensor,  # (B, 3, H, W), unnormalized [0, 1] pixels
    pixel_unshuffle: int = 0,  # 0 / 1 off; f folds f x f blocks
    skip_final_norm: bool = False,
    input_mean: Tuple[float, float, float] = IMAGENET_MEAN,
    input_std: Tuple[float, float, float] = IMAGENET_STD,
) -> torch.Tensor:
    """The RADIO tower (VILA's radio_encoder): the ImageNet input
    conditioner on unnormalized pixels, the last layer, then `post_ln`
    unless skip_final_norm, the cls and register tokens dropped; then, with
    pixel_unshuffle = f > 1, f x f spatial blocks folded into channels in
    torch PixelUnshuffle's channel order (C, fh, fw), which is not
    mlp_downsample's (fh, fw, C). An odd grid under an unshuffle raises, as
    PixelUnshuffle does."""
    mean = torch.tensor(input_mean, dtype=images.dtype,
                        device=images.device).reshape(1, 3, 1, 1)
    std = torch.tensor(input_std, dtype=images.dtype,
                       device=images.device).reshape(1, 3, 1, 1)
    x = encode(params, cfg, (images - mean) / std, select_layer=-1,
               select_feature="cls_patch")
    if not skip_final_norm:
        x = layer_norm(x, params["post_ln"], cfg.layer_norm_eps)
    x = x[:, cfg.num_prefix_tokens:]
    if pixel_unshuffle and pixel_unshuffle > 1:
        f = pixel_unshuffle
        b, n, c = x.shape
        side = cfg.image_size // cfg.patch_size
        if side % f:
            raise ValueError(
                f"encode_radio: pixel_unshuffle={f} needs a token grid "
                f"divisible by {f}; this tower's is {side} x {side}")
        g = x.reshape(b, side // f, f, side // f, f, c)
        g = g.permute(0, 1, 3, 5, 2, 4)  # (B, H/f, W/f, C, fh, fw)
        x = g.reshape(b, (side // f) ** 2, c * f * f)
    return x
