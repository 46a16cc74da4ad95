"""LoRA as a param-tree transform.

Counterpart of halva_tpu/train/lora.py: `add_lora` inserts `lora_a`,
`lora_b` and `lora_scale` into the matched dense param dicts and
`models/llama.py:dense` applies them; `merge_lora` folds A @ B into the
kernel; `trainable_mask` gives the bool tree that `train/trainer.py` splits
by. Stacked `(L, in, out)` kernels get factors with the same leading dim and
a `(L,)` scale. A ~ kaiming-uniform, B = 0 (the adapter starts as identity).

The functions return new dicts around the same leaf tensors (the JAX
package's trees are immutable; here only the dicts are copied, never a
weight). State-dict keys are the reference's strings ("llm/layers/attn/wq/
lora_a", ...), so adapters cross-load between the two packages.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Sequence

import numpy as np
import torch

from halva_tpu_torch import tree

Params = Dict[str, Any]

DEFAULT_TARGETS = (
    r"llm/layers/attn/w[qkvo]$",
    r"llm/layers/mlp/(gate|up|down)$",
)
_KERNEL_KEYS = ("kernel", "kernel_q", "kernel_q4", "kernel_q4p")
_LORA_KEYS = ("lora_a", "lora_b", "lora_scale")


def _copy_dicts(params):
    """New dicts and lists, the same leaf tensors."""
    return tree.map_tree(lambda x: x, params)


def _iter_dense(params, prefix: str = ""):
    """(path, dense param dict) for every dict holding a kernel: float
    `kernel`, int8 `kernel_q`, NF4 `kernel_q4` or packed int4 `kernel_q4p`
    (the quantized ones are QLoRA-class bases)."""
    if isinstance(params, dict):
        if any(k in params for k in _KERNEL_KEYS):
            yield prefix.rstrip("/"), params
            return
        for k, v in params.items():
            yield from _iter_dense(v, f"{prefix}{k}/")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _iter_dense(v, f"{prefix}{i}/")


def add_lora(
    params: Params,
    generator: torch.Generator,
    rank: int = 128,
    alpha: float = 256.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype=None,
) -> Params:
    """A copy of `params` with LoRA factors on the matched denses, made on
    each kernel's device (the generator must live there too)."""
    params = _copy_dicts(params)
    matched = 0
    for path, p in _iter_dense(params):
        if not any(re.search(t, path) for t in targets):
            continue
        kern = next(p[k] for k in _KERNEL_KEYS if k in p)
        # a quantized base trains bf16 adapters on top of it
        quantized = kern.dtype in (torch.int8, torch.uint8)
        dt = dtype or (torch.bfloat16 if quantized else kern.dtype)
        *lead, d_in, d_out = kern.shape
        if "kernel_q4p" in p:
            d_out *= 2  # packed int4: two output nibbles per int8 byte
        bound = math.sqrt(3.0) / math.sqrt(d_in)  # kaiming-uniform, fan_in
        a = torch.rand((*lead, d_in, rank), generator=generator,
                       dtype=torch.float32, device=kern.device)
        p["lora_a"] = (a * (2 * bound) - bound).to(dt)
        p["lora_b"] = torch.zeros((*lead, rank, d_out), dtype=dt,
                                  device=kern.device)
        p["lora_scale"] = torch.full(tuple(lead), alpha / rank, dtype=dt,
                                     device=kern.device)
        matched += 1
    if matched == 0:
        raise ValueError(f"no dense params matched LoRA targets {targets}")
    return params


def merge_lora(params: Params) -> Params:
    """Fold the adapters into the float kernels and drop the factors. A
    quantized base has no float `kernel` to fold into: that raises KeyError
    here as in the reference (keep the adapters, or merge into the float
    tree the base was quantized from)."""
    params = _copy_dicts(params)
    for path, p in _iter_dense(params):
        if "lora_a" in p:
            if "kernel" not in p:
                raise KeyError(
                    f"merge_lora: {path} has a quantized base "
                    f"({next(k for k in _KERNEL_KEYS if k in p)}) and no "
                    "float 'kernel' to fold the adapter into")
            a = p["lora_a"].float()
            b = p["lora_b"].float()
            scale = p["lora_scale"].float()[..., None, None]
            delta = torch.einsum("...ir,...ro->...io", a, b) * scale
            p["kernel"] = (p["kernel"].float() + delta).to(p["kernel"].dtype)
            for k in _LORA_KEYS:
                del p[k]
    return params


def strip_lora(params: Params) -> Params:
    """Drop the adapters without merging (the frozen base)."""
    params = _copy_dicts(params)
    for _, p in _iter_dense(params):
        for k in _LORA_KEYS:
            p.pop(k, None)
    return params


def trainable_mask(params: Params,
                   extra_trainable: Sequence[str] = ()) -> Params:
    """Bool tree: True = trained. LoRA A and B (the scale stays fixed),
    plus every leaf whose "/"-joined path matches an `extra_trainable`
    regex (e.g. "^projector/" when mm_projector_lr is set)."""

    def mask(path, node):
        if isinstance(node, dict):
            return {k: mask(path + (str(k),), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [mask(path + (str(i),), v) for i, v in enumerate(node)]
        leaf = path[-1] if path else ""
        if leaf in ("lora_a", "lora_b"):
            return True
        if leaf == "lora_scale":
            return False
        joined = "/".join(path)
        return any(re.search(t, joined) for t in extra_trainable)

    return mask((), params)


def lora_state_dict(params: Params) -> Dict[str, np.ndarray]:
    """The adapters as a flat {"path/lora_a": array} dict of host numpy
    arrays; bf16 as `tree.bf16_array` gives it (ml_dtypes.bfloat16, as the
    reference's np.asarray gives it, or 2-byte void where ml_dtypes is not
    installed)."""
    out = {}
    for path, p in _iter_dense(params):
        for k in _LORA_KEYS:
            if k in p:
                t = p[k]
                out[f"{path}/{k}"] = (tree.bf16_array(t)
                                      if t.dtype == torch.bfloat16
                                      else t.detach().cpu().numpy().copy())
    return out


def load_lora_state_dict(params: Params,
                         sd: Dict[str, np.ndarray]) -> Params:
    """A copy of `params` with the adapters of `sd` in place, each on its
    dense's device. Raises KeyError for keys that match no dense."""
    params = _copy_dicts(params)
    seen = set()
    for path, p in _iter_dense(params):
        device = next(p[k] for k in _KERNEL_KEYS if k in p).device
        for k in _LORA_KEYS:
            full = f"{path}/{k}"
            if full in sd:
                p[k] = tree.to_torch(np.asarray(sd[full]), device=device)
                seen.add(full)
    missing = set(sd) - seen
    if missing:
        raise KeyError(f"unmatched adapter weights: {sorted(missing)[:5]}")
    return params
