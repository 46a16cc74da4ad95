"""Plain CLIP ViT-L/14 tower and the LLaVA mlp2x_gelu projector, fp32.

As HF's CLIPVisionModel and LLaVA's projector compute them: a stride-p
convolution without bias makes the patch embeddings, the class token goes
first, position embeddings are added, pre_layrnorm, then pre-norm encoder
layers (LayerNorm, multi-head attention with biased q/k/v/o, LayerNorm,
fc1, quick_gelu, fc2). LLaVA takes hidden_states[select_layer] (-2: the
output of the second-to-last layer) without the class token, then
Linear -> GELU -> Linear.

Weights are read from the benchmark's tree: a patch kernel (p, p, 3, D),
stacked (L, in, out) layer kernels, (in, out) projector kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _layer_norm(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"].float(), p["bias"].float(),
                        eps)


def _lin(x, p, li=None):
    w = p["kernel"] if li is None else p["kernel"][li]
    y = x @ w.float()
    b = p.get("bias")
    if b is not None:
        y = y + (b if li is None else b[li]).float()
    return y


def encode(vision: dict, vcfg: dict, select_layer: int,
           images: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) -> (N, patches, D) fp32 patch features."""
    d, p = vcfg["hidden_size"], vcfg["patch_size"]
    heads = vcfg["num_heads"]
    eps = vcfg["layer_norm_eps"]
    weight = vision["patch_embed"]["kernel"].float().permute(3, 2, 0, 1)
    x = F.conv2d(images.float(), weight, stride=p)  # (N, D, g, g)
    x = x.flatten(2).transpose(1, 2)
    n = x.shape[0]
    cls = vision["cls_token"]["embedding"].float().expand(n, 1, d)
    x = torch.cat([cls, x], dim=1) + vision["pos_embed"]["embedding"].float()
    x = _layer_norm(x, vision["pre_ln"], eps)
    lay = vision["layers"]
    dh = d // heads
    for li in range(select_layer % (vcfg["num_layers"] + 1)):
        ln = {k: {kk: vv[li] for kk, vv in lay[k].items()}
              for k in ("ln1", "ln2")}
        y = _layer_norm(x, ln["ln1"], eps)
        t = y.shape[1]
        q, k, v = (_lin(y, lay["attn"][w], li).view(n, t, heads, dh)
                   .transpose(1, 2) for w in ("wq", "wk", "wv"))
        att = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        o = (att.softmax(-1) @ v).transpose(1, 2).reshape(n, t, d)
        x = x + _lin(o, lay["attn"]["wo"], li)
        y = _layer_norm(x, ln["ln2"], eps)
        y = _lin(y, lay["mlp"]["fc1"], li)
        y = y * torch.sigmoid(1.702 * y)
        x = x + _lin(y, lay["mlp"]["fc2"], li)
    return x[:, 1:]


def project(projector: dict, feats: torch.Tensor) -> torch.Tensor:
    first, second = projector["layers"]
    return _lin(F.gelu(_lin(feats, first)), second)


def image_features(weights: dict, model: dict, images: torch.Tensor,
                   chunk: int = 8) -> torch.Tensor:
    """(N, 3, H, W) -> (N, T, D_llm) fp32, `chunk` images at a time."""
    out = []
    for i in range(0, images.shape[0], chunk):
        f = encode(weights["vision"], model["vision"],
                   model["mm_vision_select_layer"], images[i:i + chunk])
        out.append(project(weights["projector"], f))
    return torch.cat(out)
