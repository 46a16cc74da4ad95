"""Quantized param-tree disk cache.

Counterpart of halva_tpu/utils/treecache.py, in the same file format: one
npz written by either package loads in the other. The quantized tree is a
pure function of the checkpoint files and the quantization config, so the
loader (models/builder.py) persists it once and later starts read it back
instead of converting, merging and quantizing again.

Cache layout: one .npz per key under the cache dir. Leaves are stored
as a0..aN (bfloat16 via a uint16 view — np.savez has no bf16), with a
JSON `__meta__` record holding the tree skeleton, per-leaf dtypes and
the model config. Keys hash the quantization config plus (relpath,
size, mtime_ns) of every checkpoint file involved, so touching a
checkpoint invalidates its entries (reference counterpart: the eval
loader re-quantizes from scratch per process, llava/model/builder.py:43).
Leaves here are torch tensors; the bf16 view goes through int16.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from halva_tpu_torch.config import (
    LlavaConfig,
    config_to_dict,
    llava_config_from_dict,
)

SCHEMA = 1

_WEIGHT_EXTS = (".safetensors", ".bin", ".npz", ".json", ".model")


def _file_stats(root: Optional[str]) -> list:
    """(relpath, size, mtime_ns) for every checkpoint-relevant file under
    root (or the file itself), sorted for determinism."""
    if not root:
        return []
    root = os.path.abspath(root)
    if os.path.isfile(root):
        st = os.stat(root)
        return [(os.path.basename(root), st.st_size, st.st_mtime_ns)]
    out = []
    for dirpath, _, names in os.walk(root):
        for n in names:
            if not n.endswith(_WEIGHT_EXTS):
                continue
            p = os.path.join(dirpath, n)
            st = os.stat(p)
            out.append((os.path.relpath(p, root), st.st_size, st.st_mtime_ns))
    return sorted(out)


def cache_key(
    quant: str,
    quant_tp: int,
    dtype,
    paths: Iterable[Optional[str]],
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    manifest = {
        "schema": SCHEMA,
        "quant": quant,
        "quant_tp": quant_tp,
        "dtype": dtype_name(dtype),
        "files": {
            str(p): _file_stats(p) for p in paths if p
        },
        "extra": extra or {},
    }
    blob = json.dumps(manifest, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


def dtype_name(dtype) -> str:
    """A torch (or numpy) dtype's numpy name, "bfloat16" for bf16: the
    reference's `str(jnp.dtype(...))`, so that keys and dtype records
    agree between the packages."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _leaves(node) -> list:
    """Tensor leaves in the order `_skeleton` numbers them (dict keys
    sorted, as jax.tree.leaves flattens them)."""
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in _leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [x for v in node for x in _leaves(v)]
    return [node]


def _skeleton(node, counter) -> Any:
    if isinstance(node, dict):
        # jax.tree.leaves flattens dicts in SORTED key order — the
        # skeleton's leaf indices must follow the same order or the
        # rebuilt tree comes back with permuted leaves.
        return {
            "t": "d",
            "k": {k: _skeleton(v, counter) for k, v in sorted(node.items())},
        }
    if isinstance(node, (list, tuple)):
        return {
            "t": "l" if isinstance(node, list) else "u",
            "v": [_skeleton(v, counter) for v in node],
        }
    i = counter[0]
    counter[0] += 1
    return {"t": "x", "i": i}


def _rebuild(spec, leaves):
    t = spec["t"]
    if t == "d":
        return {k: _rebuild(v, leaves) for k, v in spec["k"].items()}
    if t in ("l", "u"):
        seq = [_rebuild(v, leaves) for v in spec["v"]]
        return seq if t == "l" else tuple(seq)
    return leaves[spec["i"]]


def write_tree(path: str, params, **meta) -> None:
    """The tree file: a JSON `__meta__` record (schema, skeleton, per-leaf
    dtypes and any `meta` entries) and one npz entry per leaf, a0..aN,
    bfloat16 through a uint16 view. Atomic (tmp + rename): a crashed save
    never leaves a half-written file under `path`. Leaves are torch
    tensors on any device, copied to the host one at a time."""
    leaves = _leaves(params)
    counter = [0]
    spec = _skeleton(params, counter)
    assert counter[0] == len(leaves)
    meta = {
        "schema": SCHEMA,
        "skeleton": spec,
        "dtypes": [dtype_name(l.dtype) for l in leaves],
        **meta,
    }

    def arrays():
        for i, l in enumerate(leaves):
            t = l.detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                yield f"a{i}", t.view(torch.int16).numpy().view(np.uint16)
            else:
                yield f"a{i}", t.numpy()

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        # np.savez's layout, an entry at a time: the host holds one leaf
        _zip_array(zf, "__meta__", np.frombuffer(
            json.dumps(meta).encode(), np.uint8))
        for name, a in arrays():
            _zip_array(zf, name, a)
    os.replace(tmp, path)


def _zip_array(zf: zipfile.ZipFile, name: str, a: np.ndarray) -> None:
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array(f, np.asanyarray(a), allow_pickle=False)


def read_tree(path: str, put=None) -> Tuple[Any, Dict[str, Any]]:
    """The tree of a `write_tree` file (or the reference's treecache npz)
    as torch tensors, and its meta record. With `put` (tensor -> tensor,
    e.g. a copy to the card), each leaf is handed to it right after its
    npz entry is read, so that the host holds one leaf at a time."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("schema") != SCHEMA:
            raise ValueError(f"treecache schema {meta.get('schema')} != {SCHEMA}")
        leaves = []
        for i, dt in enumerate(meta["dtypes"]):
            a = z[f"a{i}"]
            if dt == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            leaves.append(put(t) if put is not None else t)
            del a, t
    return _rebuild(meta["skeleton"], leaves), meta


def save_tree(path: str, params, cfg: LlavaConfig) -> None:
    """The quantized tree and its model config, in one atomic write."""
    write_tree(path, params, config=config_to_dict(cfg))


def load_tree(path: str, put=None) -> Tuple[Any, LlavaConfig]:
    """Rebuild the cached tree as torch tensors on the CPU, or handed to
    `put` a leaf at a time (see read_tree)."""
    params, meta = read_tree(path, put)
    return params, llava_config_from_dict(meta["config"])


def cache_dir() -> Optional[str]:
    """HALVA_QUANT_CACHE: unset -> halva_quant_cache under the system's
    temporary directory; "off"/"0"/"" -> disabled; else the given
    directory."""
    import tempfile

    v = os.environ.get(
        "HALVA_QUANT_CACHE",
        os.path.join(tempfile.gettempdir(), "halva_quant_cache"))
    if v.lower() in ("off", "0", ""):
        return None
    return v
