"""Random weights from the seed, made on the device in a few large calls.

The tree has the layout the port takes (nested dicts of stacked (L, ...)
layer leaves and (in, out) dense kernels); its shapes come from the port's
own tree on the meta device, its values from one generator here:

- every kernel and embedding is a view of one buffer filled by normal
  draws of CHUNK elements, scaled in place:
  kernels N(0, 1 / fan_in), embeddings and tokens N(0, 0.02^2);
- norm scales are 1 and biases 0;
- LoRA factors (training cells) on the LLM's linear layers: A uniform in
  +-1 / sqrt(fan_in), as PEFT's kaiming init gives it, B N(0, b_std^2).

The reference reads the same tensors: they are inputs that the benchmark
made, not the program.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, List, Tuple

import torch

CHUNK = 1 << 30  # elements of one normal draw
LORA_TARGETS = (r"^llm/layers/attn/w[qkvo]$", r"^llm/layers/mlp/(gate|up|down)$")


def flatten(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, object]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_structure(v) for v in tree]
    return tree


def _std(path: Tuple, shape: Tuple[int, ...]) -> float:
    """The normal draw's scale for a kernel or an embedding leaf."""
    if path[-1] == "embedding":
        return 0.02
    stacked = "layers" in path and len(shape) == 3
    fan_in = shape[-2] if stacked else math.prod(shape[:-1])
    return fan_in ** -0.5


def make_weights(shapes: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """A tree like `shapes` (the port's tree on the meta device) with values
    from `seed`, on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = _copy_structure(shapes)
    normal: List[Tuple[Tuple, torch.Size]] = []
    for path, leaf in flatten(shapes):
        name = path[-1]
        if name in ("kernel", "embedding"):
            normal.append((path, leaf.shape))
        elif name == "scale":
            _set(out, path, torch.ones(leaf.shape, dtype=dtype, device=device))
        elif name == "bias":
            _set(out, path, torch.zeros(leaf.shape, dtype=dtype,
                                        device=device))
        else:
            raise ValueError(f"no rule for the leaf {'/'.join(map(str, path))}")
    total = sum(math.prod(s) for _, s in normal)
    flat = torch.empty(total, dtype=dtype, device=device)
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    offset = 0
    for path, shape in normal:
        n = math.prod(shape)
        leaf = flat[offset:offset + n].view(shape)
        leaf.mul_(_std(path, tuple(shape)))
        _set(out, path, leaf)
        offset += n
    return out


def lora_denses(tree: dict) -> List[Tuple[str, dict]]:
    """(path, dense dict) of every dense the LoRA targets match."""
    found = []

    def walk(node, prefix):
        if isinstance(node, dict):
            if "kernel" in node:
                if any(re.search(t, prefix) for t in LORA_TARGETS):
                    found.append((prefix, node))
                return
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))

    walk(tree, "")
    return found


def add_lora(tree: dict, seed: int, rank: int, alpha: float, b_std: float,
             device, dtype=torch.bfloat16) -> dict:
    """LoRA factors on every targeted dense of `tree`, in place: the
    adapter of a run part-way through training (B not zero, so that the KL
    term and the gradients of A are not nought)."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    for _, p in lora_denses(tree):
        *lead, d_in, d_out = p["kernel"].shape
        bound = d_in ** -0.5
        a = torch.rand((*lead, d_in, rank), generator=gen, dtype=dtype,
                       device=device)
        p["lora_a"] = a.mul_(2 * bound).sub_(bound)
        p["lora_b"] = torch.randn((*lead, rank, d_out), generator=gen,
                                  dtype=dtype, device=device).mul_(b_std)
        p["lora_scale"] = torch.full(tuple(lead), alpha / rank, dtype=dtype,
                                     device=device)
    return tree


def clone_lora(tree: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """Copies of the LoRA factors, keyed by dense path: what the reference
    starts from, whatever the program does to its own leaves."""
    return {path: {k: p[k].detach().clone() for k in ("lora_a", "lora_b",
                                                      "lora_scale")}
            for path, p in lora_denses(tree) if "lora_a" in p}
