"""Plain AdamW as HALVA's recipe runs it (optax's chain), fp32.

- The learning rate of the n-th update (n from 0): a linear warm-up from 0
  over int(warmup_ratio * num_train_steps) updates (at least 1), then a
  cosine decay to 0 over the rest (optax's warmup_cosine_decay_schedule).
- Gradient accumulation (optax.MultiSteps): the running mean
  acc += (g - acc) / (n + 1) over the micro-steps of a cycle, then one
  update from it.
- Clipping by the global norm: the gradient times max_norm / norm where the
  norm is not below max_norm.
- AdamW with bias correction: p - lr * (m_hat / (sqrt(v_hat) + eps)
  + weight_decay * p).
- The parameters are stored in the dtype the configuration states: the
  updated values are rounded to it.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def learning_rate(job: dict, n: int) -> float:
    base = job["learning_rate"]
    warmup = max(int(job["warmup_ratio"] * job["num_train_steps"]), 1)
    total = max(job["num_train_steps"], warmup + 1)
    if n < warmup:
        return base * n / warmup
    t = min(n - warmup, total - warmup) / (total - warmup)
    return base * 0.5 * (1 + math.cos(math.pi * t))


def accumulate(acc: List[torch.Tensor], grads: List[torch.Tensor],
               n: int) -> List[torch.Tensor]:
    """The running mean after micro-step n (from 0) of a cycle."""
    return [a + (g - a) / (n + 1) for a, g in zip(acc, grads)]


def clip(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
    if norm < max_norm:
        return grads
    return [g * (max_norm / float(norm)) for g in grads]


def adamw(params: List[torch.Tensor], grads: List[torch.Tensor],
          state: Dict[str, list], lr: float, job: dict,
          dtype: torch.dtype) -> List[torch.Tensor]:
    """One update of fp32 `params` (values of `dtype`) from fp32 `grads`;
    `state` holds the moments ("m", "v", empty lists at the start) and the
    count ("t") and is updated. Returns the new parameters, rounded to
    `dtype` and given back in fp32."""
    b1, b2, eps = job["adam_b1"], job["adam_b2"], job["adam_eps"]
    wd = job["weight_decay"]
    t = state.get("t", 0) + 1
    if not state.get("m"):
        state["m"] = [torch.zeros_like(g) for g in grads]
        state["v"] = [torch.zeros_like(g) for g in grads]
    out = []
    for i, (p, g) in enumerate(zip(params, grads)):
        m = b1 * state["m"][i] + (1 - b1) * g
        v = b2 * state["v"][i] + (1 - b2) * g * g
        state["m"][i], state["v"][i] = m, v
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - b2 ** t)
        new = p - lr * (m_hat / (v_hat.sqrt() + eps) + wd * p)
        out.append(new.to(dtype).float())
    state["t"] = t
    return out
