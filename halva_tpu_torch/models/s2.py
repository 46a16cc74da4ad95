"""S2 multiscale vision encoding (Scaling-on-Scales).

Counterpart of halva_tpu/models/s2.py (VILA's VisionTowerS2): the image is
encoded at several scales; each larger scale is split into base-size tiles,
every tile of every scale goes through the same frozen tower in one batched
call, each scale's tile grids are stitched and area-pooled back to the base
token grid, and the scales concatenate on the channel axis. Output: (B,
base_tokens, D * num_scales). The scales resize with jax.image.resize's
bilinear (ops/resize.py), not F.interpolate's.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from halva_tpu_torch.config import ViTConfig
from halva_tpu_torch.models import vit
from halva_tpu_torch.ops.resize import resize

Params = Dict[str, Any]


def _resize_images(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 3, size, size), bilinear in fp32."""
    b, c = images.shape[:2]
    return resize(images, (b, c, size, size), "bilinear")


def _split_tiles(images: torch.Tensor, base: int) -> torch.Tensor:
    """(B, 3, g*base, g*base) -> (B*g*g, 3, base, base), tiles row-major."""
    b, c, h, _ = images.shape
    g = h // base
    x = images.reshape(b, c, g, base, g, base).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b * g * g, c, base, base)


def _stitch_and_pool(feats: torch.Tensor, batch: int, grid: int,
                     side: int) -> torch.Tensor:
    """(B*g*g, side*side, D) tile features -> one (g*side)^2 grid a row,
    average-pooled by g back to (B, side*side, D)."""
    d = feats.shape[-1]
    x = feats.reshape(batch, grid, grid, side, side, d).permute(
        0, 1, 3, 2, 4, 5)  # (B, g, side, g, side, D)
    x = x.reshape(batch, grid * side, grid * side, d)
    x = x.reshape(batch, side, grid, side, grid, d).mean(dim=(2, 4))
    return x.reshape(batch, side * side, d)


def encode_multiscale(
    params: Params,
    cfg: ViTConfig,
    images: torch.Tensor,  # (B, 3, H, W) at any resolution
    scales: Sequence[int] = (336, 672),
    select_layer: int = -2,
    select_feature: str = "patch",
) -> torch.Tensor:
    """(B, base_tokens, D * len(scales)): one tower call over the tiles of
    every scale."""
    base = cfg.image_size
    if any(s % base for s in scales):
        raise ValueError(f"S2 scales {tuple(scales)} must be multiples of "
                         f"the tower's {base}")
    b = images.shape[0]
    side = base // cfg.patch_size
    tiles, grids = [], []
    for s in scales:
        tiles.append(_split_tiles(_resize_images(images, s), base))
        grids.append(s // base)
    feats = vit.encode(params, cfg, torch.cat(tiles),
                       select_layer=select_layer,
                       select_feature=select_feature)
    outs, lo = [], 0
    for g in grids:
        n = b * g * g
        outs.append(_stitch_and_pool(feats[lo:lo + n], b, g, side))
        lo += n
    return torch.cat(outs, dim=-1)
