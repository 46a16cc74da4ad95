"""LLaVA: CLIP tower + projector + Llama, with the static image-token splice.

Counterpart of halva_tpu/models/llava.py (single-image rows). The splice is
a fixed-shape gather: output position j of a row whose image sentinel sits
at p (T patches) takes text token j (j < p), patch j - p (p <= j < p + T)
or text token j - T + 1 (j >= p + T). Output length S + T - 1.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from halva_tpu_torch import tree
from halva_tpu_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX, LlavaConfig
from halva_tpu_torch.models import llama, projector, vit

Params = Dict[str, Any]


class LlavaModel(nn.Module):
    """Owns a LLaVA param tree (the reference's nested names and layouts)
    as buffers, so `.to(device)` moves it; `params` gives the tree back.
    The math stays in this package's plain functions."""

    def __init__(self, cfg: LlavaConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self._skeleton = tree.map_tree(lambda _: None, params)
        self._names = []
        for path, leaf in tree.flatten(params):
            name = "__".join(str(k) for k in path)
            self.register_buffer(name, leaf)
            self._names.append(name)

    @property
    def params(self) -> Params:
        leaves = iter([getattr(self, name) for name in self._names])
        return tree.map_tree(lambda _: next(leaves), self._skeleton)


def encode_images(params: Params, cfg: LlavaConfig,
                  images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, T, D_llm): frozen tower, then the projector."""
    if cfg.vision_tower_type != "vit":
        raise NotImplementedError(
            "the RADIO tower is not ported yet (ROADMAP queue 1, alt "
            "backends)"
        )
    feats = vit.encode(
        params["vision"], cfg.vision, images,
        select_layer=cfg.mm_vision_select_layer,
        select_feature=cfg.mm_vision_select_feature,
    )
    return projector.apply(params["projector"], cfg, feats)


class Spliced(NamedTuple):
    embeds: torch.Tensor  # (B, S_out, D)
    labels: torch.Tensor  # (B, S_out)
    signs: torch.Tensor  # (B, S_out)
    segment_ids: torch.Tensor  # (B, S_out) 0 = padding/invalid
    positions: torch.Tensor  # (B, S_out)


def splice_image_tokens(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,  # (B, S) with one IMAGE_TOKEN_INDEX or none
    image_features: torch.Tensor,  # (B, T, D)
    segment_ids: Optional[torch.Tensor] = None,  # (B, S) 0 = padding
    labels: Optional[torch.Tensor] = None,
    signs: Optional[torch.Tensor] = None,
) -> Spliced:
    """Static-shape gather splice; integer fields are int32."""
    b, s = input_ids.shape
    t = image_features.shape[1]
    s_out = s + t - 1
    dev = input_ids.device
    i32 = torch.int32
    if segment_ids is None:
        segment_ids = torch.ones((b, s), dtype=i32, device=dev)
    if labels is None:
        labels = torch.full((b, s), IGNORE_INDEX, dtype=i32, device=dev)
    if signs is None:
        signs = torch.zeros((b, s), dtype=i32, device=dev)

    is_sentinel = input_ids == IMAGE_TOKEN_INDEX
    has_img = is_sentinel.any(dim=1)  # (B,)
    row_len = (segment_ids != 0).sum(dim=1)
    # first sentinel: argmax of a bool row is not defined to be the first
    # True in torch, so take the smallest index that holds one
    idx = torch.arange(s, device=dev).expand(b, s)
    first = torch.where(is_sentinel, idx, s).min(dim=1).values
    img_pos = torch.where(has_img, first, row_len)  # (B,)

    j = torch.arange(s_out, device=dev)[None, :]
    p = img_pos[:, None]
    in_img = (j >= p) & (j < p + t)
    after = j >= p + t
    text_idx = torch.where(after, j - (t - 1), j).clamp(0, s - 1)
    patch_idx = (j - p).clamp(0, t - 1)

    text_embeds = llama.embed(params["llm"], input_ids)  # (B, S, D)
    d = text_embeds.shape[-1]
    gathered_text = torch.gather(
        text_embeds, 1, text_idx[:, :, None].expand(b, s_out, d))
    gathered_img = torch.gather(
        image_features.to(text_embeds.dtype), 1,
        patch_idx[:, :, None].expand(b, s_out, d))
    embeds = torch.where(in_img[:, :, None], gathered_img, gathered_text)

    def gather_i32(x, fill):
        g = torch.gather(x.to(i32), 1, text_idx)
        return torch.where(in_img, torch.full_like(g, fill), g)

    out_seg = torch.where(
        in_img,
        has_img[:, None].to(i32).expand(b, s_out),
        torch.gather(segment_ids.to(i32), 1, text_idx),
    )
    positions = torch.arange(s_out, dtype=i32, device=dev).expand(b, s_out)
    return Spliced(embeds, gather_i32(labels, IGNORE_INDEX),
                   gather_i32(signs, 0), out_seg, positions)
