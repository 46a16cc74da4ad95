"""Image resize with the semantics of `jax.image.resize` (linear and cubic).

The reference resizes the positional grid (bicubic, models/vit.py
interpolate_pos_embed) and S2's scales (bilinear, models/s2.py) with
`jax.image.resize`, which is not `F.interpolate`: it samples at half-pixel
centres, its cubic is Keys' with a = -0.5 (torch's bicubic uses -0.75 and
clamps indices), each output's weights are renormalised to sum to 1 at the
edges, and when it shrinks it widens the kernel by the scale (antialiasing).
Here each resized axis is one (in, out) weight matrix built the same way,
applied by a contraction.
"""

from __future__ import annotations

from typing import Sequence

import torch

_EPS = 1000.0 * torch.finfo(torch.float32).eps


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp(min=0.0)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def weight_matrix(in_size: int, out_size: int, method: str,
                  device=None) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of one axis: output i samples the
    input at (i + 0.5) * in / out - 0.5, the kernel widened by in / out
    when shrinking, each column renormalised, a sample outside
    [-0.5, in - 0.5] zero."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = _KERNELS[method]((sample[None, :] - src[:, None]).abs()
                         / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > _EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, shape: Sequence[int], method: str
           ) -> torch.Tensor:
    """x resized to `shape` (same rank); every axis whose size changes is
    resampled, in fp32, and the result cast back to x's dtype."""
    if len(shape) != x.ndim:
        raise ValueError(f"resize: shape {tuple(shape)} for a {x.ndim}-d "
                         "input")
    out = x.float()
    for axis, n in enumerate(shape):
        m = out.shape[axis]
        if m == n:
            continue
        w = weight_matrix(m, n, method, device=x.device)
        out = torch.tensordot(out, w, dims=([axis], [0])).movedim(-1, axis)
    return out.to(x.dtype)
