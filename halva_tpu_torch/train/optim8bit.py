"""Block-wise 8-bit Adam moments (the reference's bitsandbytes
`adamw_bnb_8bit` option).

Counterpart of halva_tpu/train/optim8bit.py (`scale_by_adam8bit`), as a
torch.optim.Optimizer with param groups, so that LambdaLR and the per-group
clipping of trainer.DPAOptimizer work on it unchanged. The first moment is
stored as block-wise symmetric int8 (absmax / 127 scales), the second as
block-wise uint8 in the sqrt domain (max / 255 scales: sqrt compresses v's
dynamic range). Both are dequantized to fp32 for the update and quantized
again after it. Tensors smaller than `min_quant_size` keep fp32 moments.
Rounding is half to even, as jnp.round's. Every division is by a tensor
on the operand's device: PyTorch's CUDA kernels divide by a Python number
as a product with its reciprocal, an ulp off IEEE division, which would
move codes at rounding midpoints away from the reference's.

One step of a param, in the reference's optax chain order after the
clipping: the Adam direction in fp32, cast to the grad's dtype; plus
weight_decay * param (add_decayed_weights); times the group's lr (the
schedule); subtracted from the param. Bias corrections count updates.

Memory: ~2.03 bytes a param for both moments, against 8 for fp32 moments
(4 for bf16 ones).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from halva_tpu_torch.parallel import partition

BLOCK = 256
MIN_QUANT_SIZE = 4096

QUANTIZED = ("m_q", "m_s", "v_q", "v_s")  # a quantized leaf's state


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c in IEEE division on every device (see the module docstring)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _quantize_signed(x: torch.Tensor):
    """fp32 (n,) -> (int8 (nb, BLOCK), fp32 scales (nb, 1)); n % BLOCK == 0."""
    xb = x.reshape(-1, BLOCK)
    absmax = xb.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        _div(absmax, 127.0))
    q = torch.round(xb / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _dequantize_signed(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)


def _quantize_sqrt(x: torch.Tensor):
    """Nonnegative fp32 (n,) -> (uint8 (nb, BLOCK), fp32 scales (nb, 1)) of
    sqrt(x)."""
    r = torch.sqrt(x.reshape(-1, BLOCK))
    mx = r.amax(dim=1, keepdim=True)
    scale = torch.where(mx == 0.0, torch.ones_like(mx), _div(mx, 255.0))
    q = torch.round(r / scale).clamp_(0, 255).to(torch.uint8)
    return q, scale


def _dequantize_sqrt(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    r = q.float() * scale
    return (r * r).reshape(-1)


def init_state(p: torch.Tensor, min_quant_size: int = MIN_QUANT_SIZE) -> Dict[str, torch.Tensor]:
    """A param's zero moments: fp32 `m`/`v` under min_quant_size elements,
    else the quantized blocks (zero codes, unit scales), on p's device."""
    dev = p.device
    if p.numel() < min_quant_size:
        return {"m": torch.zeros(p.shape, dtype=torch.float32, device=dev),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=dev)}
    nb = -(-p.numel() // BLOCK)
    return {
        "m_q": torch.zeros((nb, BLOCK), dtype=torch.int8, device=dev),
        "m_s": torch.ones((nb, 1), dtype=torch.float32, device=dev),
        "v_q": torch.zeros((nb, BLOCK), dtype=torch.uint8, device=dev),
        "v_s": torch.ones((nb, 1), dtype=torch.float32, device=dev),
    }


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """1 - b ** count in fp32, as the reference computes them."""
    one, c = np.float32(1.0), np.float32(count)
    return (float(one - np.float32(b1) ** c),
            float(one - np.float32(b2) ** c))


def adam_direction(g: torch.Tensor, st: Dict[str, torch.Tensor], b1: float,
                   b2: float, eps: float, count: int) -> torch.Tensor:
    """The Adam direction (m / bc1) / (sqrt(v / bc2) + eps) of one leaf at
    update `count` (from 1), in g's dtype; updates the moments in `st` in
    place (new codes and scales for a quantized leaf)."""
    gf = g.float()
    bc1, bc2 = bias_corrections(b1, b2, count)
    if "m" in st:
        st["m"] = m = b1 * st["m"] + (1.0 - b1) * gf
        st["v"] = v = b2 * st["v"] + (1.0 - b2) * gf * gf
        return (_div(m, bc1) / (torch.sqrt(_div(v, bc2)) + eps)).to(g.dtype)
    n = gf.numel()
    flat = gf.reshape(-1)
    pad = (-n) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    m = _dequantize_signed(st["m_q"], st["m_s"])
    v = _dequantize_sqrt(st["v_q"], st["v_s"])
    m = b1 * m + (1.0 - b1) * flat
    v = b2 * v + (1.0 - b2) * flat * flat
    upd = _div(m, bc1) / (torch.sqrt(_div(v, bc2)) + eps)
    st["m_q"], st["m_s"] = _quantize_signed(m)
    st["v_q"], st["v_s"] = _quantize_sqrt(v)
    return upd[:n].reshape(g.shape).to(g.dtype)


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with block-quantized 8-bit moments over param groups.

    state[p]: "step" (a 0-d int64 CPU tensor, the updates so far) and the
    moments of `init_state`. A param without a grad is skipped, as the
    reference passes a None placeholder through.

    On a train mesh (`mesh`, and a group's "specs": each param's
    partition spec) a param is this rank's shard. The blocks of BLOCK run
    over the whole leaf's flattened order, which a shard's slice does not
    follow, so the moments are the whole leaf's on every rank (as the
    reference's param_shardings leave them: no rule matches their paths):
    a step gathers the whole gradient, updates the whole moments and
    applies this rank's slice of the direction."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 min_quant_size: int = MIN_QUANT_SIZE, mesh=None):
        defaults = dict(lr=lr, betas=betas, eps=eps,
                        weight_decay=weight_decay,
                        min_quant_size=min_quant_size)
        super().__init__(params, defaults)
        self.mesh = mesh

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            specs = group.get("specs") or [()] * len(group["params"])
            for p, spec in zip(group["params"], specs):
                if p.grad is None:
                    continue
                g = p.grad
                if self.mesh is not None:
                    g = partition.whole_leaf(g, spec, self.mesh)
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.int64)
                    st.update(init_state(g, group["min_quant_size"]))
                st["step"] += 1
                u = adam_direction(g, st, b1, b2, group["eps"],
                                   int(st["step"]))
                if self.mesh is not None:
                    u = partition.local_shard(u, spec, self.mesh)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.sub_(u * group["lr"])
        return loss


def state_bytes(opt: torch.optim.Optimizer) -> int:
    """Bytes of every tensor in the optimizer's per-param state."""
    return sum(t.numel() * t.element_size()
               for st in opt.state.values() for t in st.values()
               if isinstance(t, torch.Tensor))


# ---- the reference's ScaleByAdam8bitState leaves across the packages -------


def state_from_reference(leaf_state: Dict[str, np.ndarray], count: int,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """One leaf of the reference's ScaleByAdam8bitState (its `mu` dict:
    m_q/m_s/v_q/v_s or m/v, numpy arrays) and the state's count -> the
    port's state[p] on `device`."""
    st = {k: torch.from_numpy(np.array(v)).to(device)
          for k, v in leaf_state.items()}
    st["step"] = torch.tensor(int(count), dtype=torch.int64)
    return st


def state_to_reference(st: Dict[str, torch.Tensor]):
    """The port's state[p] -> (the reference's per-leaf `mu` dict as numpy
    arrays, the count)."""
    leaf = {k: v.detach().cpu().numpy() for k, v in st.items()
            if k != "step"}
    return leaf, int(st["step"])
