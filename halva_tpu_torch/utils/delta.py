"""Weight-delta distribution utilities (tree ops).

The reference ships three checkpoint-arithmetic CLIs for distributing
VILA weights on top of a base LLM license:

- ``vila/model/make_delta.py:16-53``  — delta = target − base, with
  (a) target-only tensors (mm_projector) passed through untouched and
  (b) vocab-extended 2D tensors (embed_tokens / lm_head) subtracted on
  the base-shaped top-left slab only;
- ``vila/model/apply_delta.py:16-49`` — the inverse (base + delta);
- ``vila/model/consolidate.py:14-21`` — load + re-save (format
  normalization).

Here the same arithmetic runs as host tree ops over the param trees of
train/checkpoint.save_params, leaves as CPU torch tensors (numpy leaves
are taken too, bf16 ones as ml_dtypes.bfloat16 or 2-byte void). The
values are those of halva_tpu/utils/delta.py on the same leaves: the
widening, the subtraction and the final rounding are the same IEEE
operations. Deltas are stored
one precision tier wider than the leaf (bf16/fp16 -> fp32, fp32 ->
fp64; see _delta_dtype), so apply(make(target, base), base)
round-trips the target bit-exactly in practice — the reference's
in-place fp16 arithmetic both differences AND re-rounds in fp16.

CLI (reference usage strings, make_delta.py:4-6):
    python -m halva_tpu_torch.utils.delta make  --base B --target T --delta D
    python -m halva_tpu_torch.utils.delta apply --base B --delta D --target T
    python -m halva_tpu_torch.utils.delta consolidate --src S --dst D
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]


def _flatten(tree: Params, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[tuple, np.ndarray]) -> Params:
    tree: Params = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _slab(idx_shape) -> tuple:
    return tuple(slice(0, s) for s in idx_shape)


def _tensor(x) -> torch.Tensor:
    """A leaf as a CPU tensor of its own dtype (a copy for numpy input)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    a = np.array(x)
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                  or a.dtype.name == "bfloat16"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _delta_dtype(dt: torch.dtype) -> torch.dtype:
    """One precision tier wider than the leaf: sub-fp32 floats -> fp32,
    fp32 -> fp64. The widening is what makes apply(make(t,b),b)
    round-trip t (bit-exactly in practice): with a same-width delta,
    fl(t-b) loses the low bits of the SMALLER operand whenever
    |t| << |b|, and the reconstruction error — up to ulp(b)/2 — can be
    many ulps of t (the reference's in-place fp16 arithmetic has
    exactly this hazard, apply_delta.py:38-44)."""
    if dt.is_floating_point and dt.itemsize < 4:
        return torch.float32
    if dt.is_floating_point and dt.itemsize == 4:
        return torch.float64
    return dt


def make_delta(target: Params, base: Params) -> Params:
    """delta such that apply_delta(delta, base) == target.

    Reference contract (make_delta.py:28-44): target-only tensors pass
    through; shape mismatches are legal only when every target dim >=
    the base dim (vocab extension) — the base-shaped slab is
    subtracted, the extension rows ride along verbatim. Base-only
    tensors are an error (the reference's assert, inverted)."""
    tf, bf = _flatten(target), _flatten(base)
    missing = set(bf) - set(tf)
    if missing:
        raise ValueError(f"base has tensors absent from target: {sorted(missing)}")
    out = {}
    for path, t in tf.items():
        t = _tensor(t)
        b = bf.get(path)
        if b is None:
            out[path] = t  # mm_projector-class: target-only, verbatim
            continue
        b = _tensor(b)
        if t.ndim != b.ndim or any(ts < bs for ts, bs in zip(t.shape, b.shape)):
            raise ValueError(
                f"{'/'.join(path)}: target {t.shape} does not extend base {b.shape}"
            )
        d = t.to(_delta_dtype(t.dtype), copy=True)
        sl = _slab(b.shape)
        d[sl] = t[sl].to(d.dtype) - b.to(d.dtype)[sl]
        out[path] = d
    return _unflatten(out)


def apply_delta(delta: Params, base: Params) -> Params:
    """base + delta → target (apply_delta.py:31-45): delta-only tensors
    pass through; extended tensors add the base on the top-left slab and
    keep the extension rows from the delta."""
    df, bf = _flatten(delta), _flatten(base)
    missing = set(bf) - set(df)
    if missing:
        raise ValueError(f"base has tensors absent from delta: {sorted(missing)}")
    out = {}
    for path, d in df.items():
        d = _tensor(d)
        b = bf.get(path)
        if b is None:
            out[path] = d
            continue
        b = _tensor(b)
        if d.ndim != b.ndim or any(ds < bs for ds, bs in zip(d.shape, b.shape)):
            raise ValueError(
                f"{'/'.join(path)}: delta {d.shape} does not extend base {b.shape}"
            )
        t = d.to(_delta_dtype(d.dtype), copy=True)
        sl = _slab(b.shape)
        t[sl] = d[sl].to(t.dtype) + b.to(t.dtype)[sl]
        # target leaves carry the BASE dtype (the delta may be fp32)
        out[path] = t.to(b.dtype)
    return _unflatten(out)


def consolidate(src: str, dst: str) -> None:
    """Load + re-save (consolidate.py:14-21): rewrites a save_params
    directory whole, on the host."""
    from halva_tpu_torch.train.checkpoint import load_params, save_params

    save_params(dst, load_params(src, device="cpu"))


def main(argv=None) -> None:
    from halva_tpu_torch.train.checkpoint import load_params, save_params

    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make")
    mk.add_argument("--base", required=True)
    mk.add_argument("--target", required=True)
    mk.add_argument("--delta", required=True)
    app = sub.add_parser("apply")
    app.add_argument("--base", required=True)
    app.add_argument("--delta", required=True)
    app.add_argument("--target", required=True)
    con = sub.add_parser("consolidate")
    con.add_argument("--src", required=True)
    con.add_argument("--dst", required=True)
    args = ap.parse_args(argv)
    def load(path):
        return load_params(path, device="cpu")

    if args.cmd == "make":
        save_params(args.delta, make_delta(load(args.target), load(args.base)))
    elif args.cmd == "apply":
        save_params(args.target, apply_delta(load(args.delta), load(args.base)))
    else:
        consolidate(args.src, args.dst)


if __name__ == "__main__":
    main()
