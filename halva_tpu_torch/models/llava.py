"""LLaVA: vision tower + projector + Llama, with the static image-token
splice.

Counterpart of halva_tpu/models/llava.py. The splice is a fixed-shape
gather: output position j of a row whose image sentinel sits at p (T
patches) takes text token j (j < p), patch j - p (p <= j < p + T) or text
token j - T + 1 (j >= p + T). Output length S + T - 1. Multi-image rows
(VILA) splice up to K sentinels a row the same way, S + K (T - 1) long; the
one-image splice is that splice at K = 1. `forward` is the training-style
forward: splice with labels and signs, then the decoder.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from halva_tpu_torch import tree
from halva_tpu_torch.config import LlavaConfig
from halva_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from halva_tpu_torch.models import llama, projector, vit
from halva_tpu_torch.parallel import partition
from halva_tpu_torch.parallel.mesh import DATA_AXIS

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
    """(B, 3, H, W) -> (B, T, D_llm): the frozen tower (ViT, or RADIO by
    cfg.vision_tower_type) under no_grad (the
    reference's stop_gradient), then the projector, also under no_grad
    unless one of its leaves requires grad (mm_projector_lr training)."""
    with torch.no_grad():
        if cfg.vision_tower_type == "radio":
            feats = vit.encode_radio(
                params["vision"], cfg.vision, images,
                pixel_unshuffle=cfg.radio_pixel_unshuffle,
                skip_final_norm=cfg.radio_skip_final_norm,
            )
        else:
            feats = vit.encode(
                params["vision"], cfg.vision, images,
                select_layer=cfg.mm_vision_select_layer,
                select_feature=cfg.mm_vision_select_feature,
            )
    trained = any(t.requires_grad
                  for _, t in tree.flatten(params["projector"]))
    with torch.set_grad_enabled(trained and torch.is_grad_enabled()):
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
    """Static-shape gather splice of one image a row (the first sentinel;
    a row without one keeps its text and gets a masked block after it):
    the multi-image splice at K = 1. Integer fields are int32."""
    return splice_image_tokens_multi(params, cfg, input_ids,
                                     image_features[:, None], segment_ids,
                                     labels, signs)


def splice_image_tokens_multi(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,  # (B, S) with up to K sentinels a row
    image_features: torch.Tensor,  # (B, K, T, D)
    segment_ids: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    signs: Optional[torch.Tensor] = None,
) -> Spliced:
    """Static-shape splice of multi-image rows (VILA's multi-image and
    video-as-frames samples), S + K (T - 1) long. Sentinel i of a row (in
    order) expands to feature block i. A row with n < K sentinels parks its
    missing blocks i >= n right after its real content (input position
    row_len + i - n), with segment id 0. All index arithmetic on tensors:
    nothing is read back to the host."""
    b, s = input_ids.shape
    k, t = image_features.shape[1:3]
    s_out = s + k * (t - 1)
    dev = input_ids.device
    i32 = torch.int32
    if segment_ids is None:
        segment_ids = torch.ones((b, s), dtype=i32, device=dev)
    if labels is None:
        labels = torch.full((b, s), IGNORE_INDEX, dtype=i32, device=dev)
    if signs is None:
        signs = torch.zeros((b, s), dtype=i32, device=dev)

    is_sent = input_ids == IMAGE_TOKEN_INDEX
    row_len = (segment_ids != 0).sum(dim=1)  # (B,)
    n_real = is_sent.sum(dim=1)  # (B,)
    rank = is_sent.long().cumsum(dim=1)  # 1-based rank of each sentinel
    blocks = torch.arange(k, device=dev)  # (K,)
    hit = is_sent[:, None, :] & (rank[:, None, :] == blocks[None, :, None] + 1)
    has = hit.any(dim=2)  # (B, K)
    idx = torch.arange(s, device=dev)
    first = torch.where(hit, idx, s).min(dim=2).values  # (B, K)
    pos = torch.where(has, first,
                      row_len[:, None] + blocks[None, :] - n_real[:, None])
    start = pos + blocks[None, :] * (t - 1)  # output start of each block

    j = torch.arange(s_out, device=dev)[None, None, :]  # (1, 1, S_out)
    q = start[:, :, None]  # (B, K, 1)
    inside = (j >= q) & (j < q + t)  # (B, K, S_out)
    in_img = inside.any(dim=1)  # (B, S_out)
    # a position lies in at most one block: sums pick that block's values
    patch_src = (inside * (blocks[None, :, None] * t + (j - q))).sum(dim=1)
    img_valid = (inside & has[:, :, None]).any(dim=1)
    blocks_before = (j >= q + t).sum(dim=1)
    text_idx = (j[0] - blocks_before * (t - 1)).clamp(0, s - 1)

    text_embeds = llama.embed(params["llm"], input_ids)  # (B, S, D)
    d = text_embeds.shape[-1]
    feats_flat = image_features.reshape(b, k * t, -1).to(text_embeds.dtype)
    g_text = torch.gather(text_embeds, 1,
                          text_idx[:, :, None].expand(b, s_out, d))
    g_img = torch.gather(feats_flat, 1, patch_src.clamp(0, k * t - 1)
                         [:, :, None].expand(b, s_out, d))
    embeds = torch.where(in_img[:, :, None], g_img, g_text)

    def gather_i32(x, fill):
        g = torch.gather(x.to(i32), 1, text_idx)
        return torch.where(in_img, torch.full_like(g, fill), g)

    out_seg = torch.where(in_img, img_valid.to(i32),
                          torch.gather(segment_ids.to(i32), 1, text_idx))
    positions = torch.arange(s_out, dtype=i32, device=dev).expand(b, s_out)
    return Spliced(embeds, gather_i32(labels, IGNORE_INDEX),
                   gather_i32(signs, 0), out_seg, positions)


def forward_packed(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,  # (R, S) packed docs, image blocks = pad ids
    images: torch.Tensor,  # (NI, 3, H, W) unique images
    img_src: torch.Tensor,  # (M,) feature index per placement
    img_row: torch.Tensor,  # (M,) target row; == R for padding entries
    img_col: torch.Tensor,  # (M,) target start column
    segment_ids: torch.Tensor,  # (R, S) per-document ids, 0 = padding
    positions: torch.Tensor,  # (R, S) restart at 0 per document
    attn_impl: str = "auto",
    remat: bool = False,
    return_hidden: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Forward over packed rows (train/pack.py): the image-token splice is
    a host-planned scatter instead of the per-row gather. Each unique image
    is encoded once and its (T, D) feature block is written at every
    placement (pos and neg documents share the sample's vision forward).
    Padding entries carry img_row == R: they are written into one extra row
    that is cut off after the scatter, so nothing is compacted on the host
    and nothing waits for the card. Segment ids keep the documents apart in
    attention; RoPE restarts through `positions`.

    On a train mesh (partition.shard_packed_batch) a rank holds its rows
    and its share of the unique-image stack, while the plans stay whole
    and index both globally. The rank encodes its share and all-gathers the
    features over "data" (gather_leaf: a trained projector's gradient comes
    back reduce-scattered), which costs one (NI, T, D) gather instead of
    every rank running the tower on every image; placements into other
    ranks' rows go to the spill row."""
    feats = encode_images(params, cfg, images)  # (NI, T, D)
    t = feats.shape[1]
    emb = llama.embed(params["llm"], input_ids)  # (R, S, D)
    r, s, d = emb.shape
    row_of = img_row.long()
    if mesh is not None and mesh.size(DATA_AXIS) > 1:
        feats = partition.gather_leaf(feats, (DATA_AXIS, None, None), mesh)
        r0 = mesh.index(DATA_AXIS) * r
        mine = (row_of >= r0) & (row_of < r0 + r)
        row_of = torch.where(mine, row_of - r0, torch.full_like(row_of, r))
    blocks = feats[img_src.long()].to(emb.dtype)  # (M, T, D)
    rows = row_of[:, None].expand(-1, t)
    cols = img_col.long()[:, None] + torch.arange(t, device=emb.device)
    # row R takes the dropped entries, whose columns are in range (0..T-1)
    spill = torch.cat([emb, emb.new_zeros(1, s, d)])
    emb = spill.index_put((rows, cols), blocks)[:r]
    hidden = llama.forward_embeds(
        params["llm"], cfg.llm, emb, segment_ids, positions,
        attn_impl=attn_impl, remat=remat,
    )
    if return_hidden:
        return hidden
    return llama.lm_logits(params["llm"], cfg.llm, hidden)


def forward(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,  # (B, S) with IMAGE_TOKEN_INDEX sentinels
    images: torch.Tensor,  # (B, 3, H, W), or (B, K, 3, H, W) multi-image
    segment_ids: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    signs: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    remat: bool = False,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Spliced]:
    """Splice, then the decoder stack: (fp32 logits (B, S_out, V), the
    spliced batch, whose labels and signs align with the logits).

    return_hidden: final hidden states (B, S_out, D) instead of logits, for
    the chunked loss (train/dpa.py), which never holds (B, S, V) logits."""
    if images.ndim == 5:
        b, k = images.shape[:2]
        feats = encode_images(params, cfg, images.flatten(0, 1))
        sp = splice_image_tokens_multi(
            params, cfg, input_ids, feats.reshape((b, k) + feats.shape[1:]),
            segment_ids, labels, signs)
    else:
        feats = encode_images(params, cfg, images)
        sp = splice_image_tokens(params, cfg, input_ids, feats, segment_ids,
                                 labels, signs)
    hidden = llama.forward_embeds(
        params["llm"], cfg.llm, sp.embeds, sp.segment_ids, sp.positions,
        attn_impl=attn_impl, remat=remat,
    )
    if return_hidden:
        return hidden, sp
    return llama.lm_logits(params["llm"], cfg.llm, hidden), sp
