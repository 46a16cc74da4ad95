"""Parameter trees between numpy and torch, and random init without JAX.

A param tree is nested dicts (and, for the projector, lists) of arrays with
the reference's names and layouts: stacked (L, ...) layer weights, dense
kernels (in, out). `to_torch` takes the tree as `jax.tree.map(np.asarray,
params)` gives it; bf16 arrives as `ml_dtypes.bfloat16`, which
`torch.from_numpy` refuses, so it crosses as its 16-bit pattern (bit-exact);
2-byte void, what np.savez writes for bf16 and what `bf16_array` gives where
ml_dtypes is missing, crosses the same way.
NF4 code indices arrive as `ml_dtypes.uint4` (what `jnp.uint4` is in numpy)
and cross by value into `torch.uint8`, one index per byte (torch has no
4-bit type); `to_numpy` gives `kernel_q4` leaves back as `ml_dtypes.uint4`.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

from halva_tpu_torch.config import LlamaConfig, LlavaConfig, ViTConfig
from halva_tpu_torch.models.projector import num_linears

Path = Tuple[Any, ...]


def flatten(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in a fixed order; dict keys and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, path + (i,))
    else:
        yield path, tree


def map_tree(fn, tree):
    """Apply fn to every leaf, keeping the structure (empty lists too)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def _array_to_torch(a) -> Any:
    if not isinstance(a, np.ndarray):
        return a
    if not a.flags.writeable:  # e.g. np.asarray of a jax array
        a = a.copy()
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name == "uint4":
        return torch.from_numpy(a.astype(np.uint8))
    return torch.from_numpy(a)


def bf16_array(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's host copy as numpy: ml_dtypes.bfloat16 where that
    package is installed (it comes with JAX), else 2-byte void. The bytes
    are the tensor's either way, and np.savez writes the same payload."""
    u = t.detach().cpu().contiguous().view(torch.int16).numpy()
    try:
        import ml_dtypes
    except ImportError:
        return u.view(np.dtype("V2"))
    return u.view(ml_dtypes.bfloat16)


def _tensor_to_numpy(t) -> Any:
    if not isinstance(t, torch.Tensor):
        return t
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only the round trip back to numpy needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree, device="cuda"):
    """numpy tree -> torch tree on `device`: the card by default (with no
    card that raises), `device="cpu"` to stay on the host, where the tree
    shares memory with writable arrays and copies read-only ones."""
    out = map_tree(_array_to_torch, tree)
    if torch.device(device).type == "cpu":
        return out
    return map_tree(
        lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, out
    )


def to_numpy(tree):
    """torch tree -> numpy tree (bf16 as ml_dtypes.bfloat16, the uint8 NF4
    indices of `kernel_q4` leaves as ml_dtypes.uint4)."""
    if isinstance(tree, dict):
        out = {k: to_numpy(v) for k, v in tree.items()}
        q4 = out.get("kernel_q4")
        if isinstance(q4, np.ndarray) and q4.dtype == np.uint8:
            import ml_dtypes

            out["kernel_q4"] = q4.astype(ml_dtypes.uint4)
        return out
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return _tensor_to_numpy(tree)


# --------------------------------------------------------------------------
# Random init (the card has no JAX): the tree structure, shapes and dtypes of
# halva_tpu/models/llava.py init_params, with values from a torch.Generator.
# --------------------------------------------------------------------------


class _Init:
    def __init__(self, generator: torch.Generator, dtype, device):
        self.gen, self.dtype, self.device = generator, dtype, device

    def normal(self, shape, std: float) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, dtype=self.dtype,
                        device=self.device)
        return t.mul_(std)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)


def _init_llama(ini: _Init, cfg: LlamaConfig):
    d, dh, n = cfg.hidden_size, cfg.head_size, cfg.num_layers
    h, kvh, f = cfg.num_heads, cfg.kv_heads, cfg.intermediate_size

    def dense(i, o):
        return {"kernel": ini.normal((n, i, o), i**-0.5)}

    params = {
        "embed": {"embedding": ini.normal((cfg.vocab_size, d), 0.02)},
        "layers": {
            "attn": {"wq": dense(d, h * dh), "wk": dense(d, kvh * dh),
                     "wv": dense(d, kvh * dh), "wo": dense(h * dh, d)},
            "mlp": {"gate": dense(d, f), "up": dense(d, f),
                    "down": dense(f, d)},
            "input_norm": {"scale": ini.full((n, d), 1.0)},
            "post_attn_norm": {"scale": ini.full((n, d), 1.0)},
        },
        "final_norm": {"scale": ini.full((d,), 1.0)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {
            "kernel": ini.normal((d, cfg.vocab_size), d**-0.5)
        }
    return params


def _init_vit(ini: _Init, cfg: ViTConfig):
    d, n, p = cfg.hidden_size, cfg.num_layers, cfg.patch_size

    def lin(i, o, bias=True):
        out = {"kernel": ini.normal((n, i, o), i**-0.5)}
        if bias:
            out["bias"] = ini.full((n, o), 0.0)
        return out

    def ln_stack():
        if cfg.norm_type == "rmsnorm":
            return {"scale": ini.full((n, d), 1.0)}
        return {"scale": ini.full((n, d), 1.0), "bias": ini.full((n, d), 0.0)}

    def ln():
        return {"scale": ini.full((d,), 1.0), "bias": ini.full((d,), 0.0)}

    params = {
        "patch_embed": {
            "kernel": ini.normal((p, p, 3, d), (p * p * 3) ** -0.5)
        },
        "pos_embed": {"embedding": ini.normal((cfg.num_positions, d), 0.02)},
        "layers": {
            "ln1": ln_stack(),
            "ln2": ln_stack(),
            "attn": {"wq": lin(d, d, cfg.qkv_bias), "wk": lin(d, d, cfg.qkv_bias),
                     "wv": lin(d, d, cfg.qkv_bias), "wo": lin(d, d)},
            "mlp": {"fc1": lin(d, cfg.intermediate_size),
                    "fc2": lin(cfg.intermediate_size, d)},
        },
        "post_ln": ln(),
    }
    if cfg.use_cls_token:
        params["cls_token"] = {"embedding": ini.normal((d,), 0.02)}
    if cfg.num_register_tokens:
        params["register_tokens"] = {
            "embedding": ini.normal((cfg.num_register_tokens, d), 0.02)
        }
    if cfg.use_pre_layernorm:
        params["pre_ln"] = ln()
    if cfg.qk_norm:
        params["layers"]["attn"]["q_norm"] = {"scale": ini.full((n, d), 1.0)}
        params["layers"]["attn"]["k_norm"] = {"scale": ini.full((n, d), 1.0)}
    if cfg.layer_scale:
        params["layers"]["ls1"] = {"scale": ini.full((n, d), 1.0)}
        params["layers"]["ls2"] = {"scale": ini.full((n, d), 1.0)}
    return params


def _init_projector(ini: _Init, cfg: LlavaConfig) -> dict:
    in_dim = cfg.vision_feature_size
    if cfg.mm_projector_type == "mlp_downsample":
        in_dim *= cfg.downsample_factor**2
    out_dim = cfg.llm.hidden_size
    layers: List[dict] = []
    for i in range(num_linears(cfg.mm_projector_type)):
        d_in = in_dim if i == 0 else out_dim
        layers.append({"kernel": ini.normal((d_in, out_dim), d_in**-0.5),
                       "bias": ini.full((out_dim,), 0.0)})
    return {"layers": layers}


def init_params(cfg: LlavaConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> dict:
    """Random LLaVA tree with the structure, shapes, dtypes and scales of
    halva_tpu/models/llava.py init_params (not its values: the generators
    differ), on the card unless `device` says otherwise; with no card the
    default raises."""
    ini = _Init(generator, dtype, device)
    return {
        "llm": _init_llama(ini, cfg.llm),
        "vision": _init_vit(ini, cfg.vision),
        "projector": _init_projector(ini, cfg),
    }


def init_vision_params(cfg: ViTConfig, generator: torch.Generator,
                       dtype=torch.float32, device="cuda") -> dict:
    """A random tower of `cfg` alone: the `vision` sub-tree init_params
    makes, for a tower run without an LLM (S2, a tower's encode)."""
    return _init_vit(_Init(generator, dtype, device), cfg)
