"""Multimodal projector: vision features -> LLM embedding space.

Counterpart of halva_tpu/models/projector.py: the LLaVA projectors linear,
mlpNx_gelu (exact, erf gelu between layers) and identity, and VILA's
mlp_downsample (a f x f spatial fold into channels, then a 2-layer gelu
MLP). Params: {"layers": [dense_params, ...]}.

On an odd token grid mlp_downsample zero-pads the last row and column
before folding, as VILA's DownSampleBlock does (SigLIP-384/14's 27 x 27
grid folds to 14 x 14); the reference's fold raises there. On even grids
the two agree exactly.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict

import torch
import torch.nn.functional as F

from halva_tpu_torch.config import LlavaConfig
from halva_tpu_torch.models.llama import dense

Params = Dict[str, Any]


def num_linears(projector_type: str) -> int:
    if projector_type == "identity":
        return 0
    if projector_type == "linear":
        return 1
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if m:
        return int(m.group(1))
    if projector_type == "mlp_downsample":
        return 2
    raise ValueError(f"unknown projector type: {projector_type!r}")


def downsample_2x2(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, N, D) -> (B, ceil(side / f)**2, f*f*D): fold f x f blocks of the
    square grid into channels, blocks row-major, channels ordered (row
    offset, column offset, d). An odd side gets zero rows and columns
    appended first."""
    b, n, d = x.shape
    side = math.isqrt(n)
    if side * side != n:
        raise ValueError(f"downsample_2x2: {n} tokens are no square grid")
    f = factor
    out = -(-side // f)
    x = x.reshape(b, side, side, d)
    if out * f != side:
        x = F.pad(x, (0, 0, 0, out * f - side, 0, out * f - side))
    x = x.reshape(b, out, f, out, f, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, out * out, f * f * d)


def apply(params: Params, cfg: LlavaConfig,
          features: torch.Tensor) -> torch.Tensor:
    """(B, N, mm_hidden) -> (B, N', llm_hidden); N' = N except under
    mlp_downsample (cfg.num_image_tokens)."""
    x = features
    if cfg.mm_projector_type == "mlp_downsample":
        x = downsample_2x2(x, cfg.downsample_factor)
    for i, p in enumerate(params["layers"]):
        if i > 0:
            x = F.gelu(x)
        x = dense(x, p)
    return x
