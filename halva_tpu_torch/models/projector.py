"""Multimodal projector: vision features -> LLM embedding space.

Counterpart of halva_tpu/models/projector.py for the LLaVA projectors:
linear, mlpNx_gelu (exact, erf gelu between layers) and identity.
Params: {"layers": [dense_params, ...]}.
"""

from __future__ import annotations

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


def apply(params: Params, cfg: LlavaConfig,
          features: torch.Tensor) -> torch.Tensor:
    """(B, N, mm_hidden) -> (B, N, llm_hidden)."""
    if cfg.mm_projector_type == "mlp_downsample":
        raise NotImplementedError(
            "mlp_downsample (VILA) is not ported yet (ROADMAP queue 1 item "
            "11, VILA and the other backends)"
        )
    if num_linears(cfg.mm_projector_type) == 0:  # identity
        return features
    x = features
    for i, p in enumerate(params["layers"]):
        if i > 0:
            x = F.gelu(x)
        x = dense(x, p)
    return x
