"""Parameter partitioning: the reference's specs, and this rank's shards.

Counterpart of halva_tpu/parallel/partition.py. The rules map each leaf's
"/"-joined path to logical axes, and the logical axes to mesh axes, as the
reference's do, in the same order (the vision rule first). A spec is a
tuple with one mesh axis name or None per dim, `tuple()` of the reference's
PartitionSpec: `param_pspecs` (FSDP over "data", TP over "model"),
`eval_param_pspecs` (the serving plan: TP over "model" only),
`eval_shmap_pspecs` (manual TP: the layer stacks split the Megatron way),
with `replication_fallbacks`, `manual_tp_ready` and `manual_tp_route` as in
the reference. They read only a mesh's sizes (`mesh.MeshShape`).

Placement: where the reference `device_put`s a global array with a
sharding, a rank here keeps its own shard, a contiguous slice of the leaf
on its device (`local_shard`): `shard_params`, `eval_shard_params`,
`eval_shmap_shard_params`, `shard_batch`, `shard_packed_batch`.

Training places a tree by `param_pspecs` (`TrainLayout`: FSDP's "embed" over
"data", TP's heads / mlp / vocab over "model") and computes on
gather-at-use with a backward (`gather_leaf`, `TrainGatheredLayers`): a leaf
is all-gathered over every axis of its spec where it is used, and its
gradient comes back to the rank's shard summed over "data" and sliced, not
summed, over "model".

Serving places a tree once for its route (`place_serving`, the rule of the
reference's BatchedGenerator) and hands the result, a `Placed`, to every
decode call:
- "data" (model axis 1): the whole tree on every rank;
- "manual_tp": `eval_shmap_pspecs` shards; the model computes on its local
  heads and all-reduces the outputs of wo and down (models/llama.py);
- "gather": the reference's propagation route becomes gather-at-use. A rank
  stores its `eval_param_pspecs` shards; `gather_at_use` all-gathers the
  leaves outside the layer stacks (vocab tables, projector: ~4 % of a 7B
  tree) once a call, and wraps the LLM stack in `GatheredLayers`, whose
  layer `li` is all-gathered over "model" just before it runs. The layer
  then runs the single-device code on this rank's data rows.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from halva_tpu_torch.parallel.mesh import (
    AXIS_NAMES,
    DATA_AXIS,
    MODEL_AXIS,
    MeshShape,
    all_gather,
    all_reduce,
    reduce_scatter,
)

Params = Dict[str, Any]
Spec = Tuple[Optional[str], ...]

# (path regex, logical axes per dim). Paths are "/"-joined key paths; the
# order is the reference's and matters: the first match decides.
LLM_RULES = [
    # the vision tower is replicated; first, or the token-embed rule below
    # would also take vision/pos_embed/embedding
    (r"^vision/", None),
    (r"embed/embedding(_q)?$", ("vocab", "embed_replicated")),
    (r"embed/embedding_scale$", ("vocab", "none")),
    # quantized kernels share the plain kernel's logical axes: _q (int8),
    # _q4 (NF4 codes: replicated in the reference), _q4p (packed int4: the
    # last dim holds output-channel pairs)
    (r"kernel_q4$", ("layers", "none", "none")),
    (r"attn/w[qkv]/kernel(_q|_q4p)?$", ("layers", "embed", "heads")),
    (r"attn/w[qkv]/kernel_scale4?$", ("layers", "none", "heads")),
    (r"attn/w[qkv]/kernel_scale4p$", ("layers", "none", "none", "heads")),
    (r"attn/wo/kernel(_q|_q4p)?$", ("layers", "heads", "embed")),
    (r"attn/wo/kernel_scale4?$", ("layers", "none", "embed")),
    (r"attn/wo/kernel_scale4p$", ("layers", "none", "heads", "none")),
    (r"attn/w[qkv]/lora_a$", ("layers", "embed", "lora")),
    (r"attn/w[qkv]/lora_b$", ("layers", "lora", "heads")),
    (r"attn/wo/lora_a$", ("layers", "heads", "lora")),
    (r"attn/wo/lora_b$", ("layers", "lora", "embed")),
    (r"mlp/(gate|up)/kernel(_q|_q4p)?$", ("layers", "embed", "mlp")),
    (r"mlp/(gate|up)/kernel_scale4?$", ("layers", "none", "mlp")),
    (r"mlp/(gate|up)/kernel_scale4p$", ("layers", "none", "none", "mlp")),
    (r"mlp/down/kernel(_q|_q4p)?$", ("layers", "mlp", "embed")),
    (r"mlp/down/kernel_scale4?$", ("layers", "none", "embed")),
    (r"mlp/down/kernel_scale4p$", ("layers", "none", "mlp", "none")),
    (r"mlp/(gate|up)/lora_a$", ("layers", "embed", "lora")),
    (r"mlp/(gate|up)/lora_b$", ("layers", "lora", "mlp")),
    (r"mlp/down/lora_a$", ("layers", "mlp", "lora")),
    (r"mlp/down/lora_b$", ("layers", "lora", "embed")),
    (r"(input_norm|post_attn_norm)/scale$", ("layers", "embed")),
    (r"final_norm/scale$", ("embed",)),
    (r"lm_head/kernel(_q)?$", ("embed_replicated", "vocab")),
    (r"lm_head/kernel_scale$", ("none", "vocab")),
    (r"projector/.*kernel(_q)?$", ("embed", "heads")),
    (r"projector/.*kernel_scale$", ("none", "heads")),
]

LOGICAL_TO_MESH = {
    "embed": DATA_AXIS,
    "embed_replicated": None,
    "heads": MODEL_AXIS,
    "mlp": MODEL_AXIS,
    "vocab": MODEL_AXIS,
    "layers": None,
    "lora": None,
    "patch": None,
    "none": None,
}

# serving: no FSDP (a decode step reads every weight), TP over "model"
EVAL_LOGICAL_TO_MESH = dict(LOGICAL_TO_MESH, embed=None)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", np.shape(leaf)))


def map_with_paths(fn, tree, path: str = ""):
    """fn(path, leaf) on every leaf, keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_paths(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _map2(fn, a, b):
    """fn over the leaves of two trees of one structure."""
    if isinstance(a, dict):
        return {k: _map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def logical_axes_for_path(path: str, ndim: int) -> Optional[Tuple]:
    for pat, axes in LLM_RULES:
        if re.search(pat, path):
            if axes is not None and len(axes) == ndim:
                return axes
            return None
    return None


def pspec_for(path: str, shape: Tuple[int, ...], mesh: MeshShape,
              logical_to_mesh: Optional[Dict[str, Any]] = None) -> Spec:
    axes = logical_axes_for_path(path, len(shape))
    if axes is None:
        return ()
    mapping = logical_to_mesh or LOGICAL_TO_MESH
    spec = []
    for dim, logical in zip(shape, axes):
        mesh_axis = mapping.get(logical)
        if mesh_axis is None or dim % mesh.shape[mesh_axis]:
            spec.append(None)  # unmapped, or indivisible: replicate
        else:
            spec.append(mesh_axis)
    return tuple(spec)


def replication_fallbacks(params: Params, mesh: MeshShape):
    """Paths where a rule matched but a dim of size > 1 fell back to
    replication for not dividing its mesh axis; real-model meshes must
    return []. Works on meta tensors."""
    out = []

    def check(path, leaf):
        shape = _shape(leaf)
        for dim, logical in zip(shape,
                                logical_axes_for_path(path, len(shape)) or ()):
            mesh_axis = LOGICAL_TO_MESH.get(logical)
            if mesh_axis is None or dim == 1:
                continue
            n = mesh.shape[mesh_axis]
            if n > 1 and dim % n != 0:
                out.append(f"{path}: dim {dim} (logical {logical!r}) % "
                           f"{mesh_axis}={n} != 0")

    map_with_paths(check, params)
    return out


def param_pspecs(params: Params, mesh: MeshShape,
                 logical_to_mesh: Optional[Dict[str, Any]] = None) -> Params:
    """The spec tree matching the param tree."""
    return map_with_paths(
        lambda path, leaf: pspec_for(path, _shape(leaf), mesh,
                                     logical_to_mesh), params)


def eval_param_pspecs(params: Params, mesh: MeshShape) -> Params:
    """Serving plan: replicated over "data", TP over "model"."""
    return param_pspecs(params, mesh, EVAL_LOGICAL_TO_MESH)


def manual_tp_ready(params: Params, cfg, tp: int) -> bool:
    """True when manual tensor parallelism (eval_shmap_pspecs + the two
    all-reduces a layer) takes this tree: head and mlp dims divide tp, no
    ALiBi (the kernels derive a head's slope from its index), and the LLM
    layer kernels are float, per-channel int8, or packed int4 packed for
    this tp (`w4_pack_tp`; the row-split wo/down need grouped scales that
    divide tp); no NF4, no wo/down bias (an all-reduce would add it tp
    times)."""
    llm = cfg.llm
    if (llm.num_heads % tp or llm.kv_heads % tp
            or llm.intermediate_size % tp):
        return False
    if getattr(llm, "position_embedding", "rope") == "alibi":
        return False
    pack_tp = int(params.get("w4_pack_tp", 1))
    layers = params.get("llm", {}).get("layers", {})
    try:
        for blk, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("gate", "up", "down"))):
            grp = layers.get(blk, {})
            for name in names:
                if name not in grp:
                    continue
                d = grp[name]
                if "kernel_q4" in d:
                    return False
                if "kernel_q4p" in d:
                    if name in ("wo", "down"):
                        ng = d["kernel_scale4p"].shape[2]
                        if ng > 1 and ng % tp:
                            return False
                    elif pack_tp != tp:
                        return False
                if name in ("wo", "down") and "bias" in d:
                    return False
    except AttributeError:
        return False
    return True


_N_SPLIT = re.compile(
    r"llm/layers/(attn/w[qkv]|mlp/(gate|up))/"
    r"(kernel(_q)?|kernel_q4p|kernel_scale(4p)?|lora_b|bias)$")
_K_SPLIT = re.compile(
    r"llm/layers/(attn/wo|mlp/down)/(kernel(_q)?|kernel_q4p|lora_a)$")
# wo/down grouped int4 scales: groups run along K, so they split with the
# rows (dim 2 of (L, 2, G, N/2)); per-channel (G = 1) scales replicate
_K_SCALE4 = re.compile(r"llm/layers/(attn/wo|mlp/down)/kernel_scale4p$")


def eval_shmap_pspecs(params: Params, mesh: MeshShape) -> Params:
    """Specs for manual tensor-parallel decode: the LLM layer stacks split
    over "model" (wq/wk/wv/gate/up by output columns, wo/down by input
    rows, int8 scales following their kernel's column split), everything
    else replicated; nothing over "data". W8A8's per-token activation scale
    is then taken over the local K shard of wo/down: a finer grid than one
    device's, so outputs differ by about one activation quantization step
    (tests/test_torch_mesh_generate.py holds the bound)."""
    m = mesh.shape.get(MODEL_AXIS, 1)

    def make(path: str, leaf) -> Spec:
        shape = _shape(leaf)
        nd = len(shape)
        if m == 1:
            return ()
        if _N_SPLIT.search(path):
            return (None,) * (nd - 1) + (MODEL_AXIS,)
        if _K_SCALE4.search(path):
            ng = shape[2]
            if ng > 1 and ng % m == 0:
                return (None, None, MODEL_AXIS, None)
            return ()
        if _K_SPLIT.search(path):
            return (None, MODEL_AXIS) + (None,) * (nd - 2)
        return ()

    return map_with_paths(make, params)


def manual_tp_route(params: Params, cfg, mesh: Optional[MeshShape]) -> bool:
    """The one routing decision for tensor-parallel serving: True = manual
    TP (eval_shmap_pspecs), False = gather-at-use (eval_param_pspecs).
    HALVA_TP_IMPL=propagate forces the latter, as in the reference."""
    if mesh is None or mesh.shape.get(MODEL_AXIS, 1) <= 1:
        return False
    if os.environ.get("HALVA_TP_IMPL", "shmap") != "shmap":
        return False
    return manual_tp_ready(params, cfg, mesh.shape[MODEL_AXIS])


# --------------------------------------------------------------------------
# Placement: this rank's shard of every leaf, on its device.
# --------------------------------------------------------------------------


def local_shard(x, spec: Spec, mesh: MeshShape) -> torch.Tensor:
    """The contiguous slice of `x` (a tensor or numpy array) that the rank
    at mesh.coords holds under `spec`, on mesh.device."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"the {axis} axis ({n})")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * size, size)
    return x.contiguous().to(mesh.device)


def _place(params: Params, specs: Params, mesh: MeshShape) -> Params:
    return _map2(lambda x, sp: local_shard(x, sp, mesh), params, specs)


def shard_params(params: Params, mesh: MeshShape) -> Params:
    """This rank's shards under the FSDP/TP plan (param_pspecs)."""
    return _place(params, param_pspecs(params, mesh), mesh)


def eval_shard_params(params: Params, mesh: MeshShape) -> Params:
    """This rank's shards under the serving plan (eval_param_pspecs)."""
    return _place(params, eval_param_pspecs(params, mesh), mesh)


def eval_shmap_shard_params(params: Params, mesh: MeshShape) -> Params:
    """This rank's shards under the manual-TP plan (eval_shmap_pspecs)."""
    return _place(params, eval_shmap_pspecs(params, mesh), mesh)


def shard_batch(batch, mesh: MeshShape):
    """This rank's rows of every array of a batch (dim 0 over "data")."""
    return _map2(lambda x, sp: local_shard(x, sp, mesh), batch,
                 map_with_paths(lambda p, x: (DATA_AXIS,), batch))


def shard_packed_batch(batch, mesh: MeshShape):
    """A packed DPA batch (train/pack.py): every array of 2+ dims whose
    leading dim divides "data" splits over it (the token rows and the
    unique-image stack); scalars and the scatter plans replicate."""
    n = mesh.size(DATA_AXIS)

    def spec(path, x) -> Spec:
        shape = _shape(x)
        return (DATA_AXIS,) if len(shape) >= 2 and shape[0] % n == 0 else ()

    return _place(batch, map_with_paths(spec, batch), mesh)


# --------------------------------------------------------------------------
# Serving placement and gather-at-use.
# --------------------------------------------------------------------------


def w4_pack_stamp(params) -> int:
    """The tp an int4 tree was nibble-packed for (`w4_pack_tp`); 1 for
    others."""
    return int(params.get("w4_pack_tp", 1)) if isinstance(params,
                                                          dict) else 1


def check_pack_stamp(params: Params, manual_tp: bool,
                     mesh: Optional[MeshShape]) -> None:
    """A tp-packed int4 tree dequantizes to block-permuted output channels
    anywhere but in its own manual-TP shards: refuse it elsewhere."""
    stamp = w4_pack_stamp(params)
    if stamp > 1 and not (manual_tp and mesh is not None
                          and mesh.size(MODEL_AXIS) == stamp):
        raise ValueError(
            f"params are int4-packed for manual TP={stamp} (w4_pack_tp) but "
            f"this call would run "
            f"{'gather-at-use' if mesh is not None else 'single-device'} — "
            f"requantize with quantize_params_int4(tp=1) or pass a mesh with "
            f"model={stamp} and HALVA_TP_IMPL=shmap")


class Placed(NamedTuple):
    """This rank's shards of a serving tree (`params`), the route they are
    laid out for ("data", "manual_tp" or "gather") and, for "gather", the
    spec tree of the layout."""
    params: Params
    route: str
    specs: Optional[Params] = None


def place_serving(params: Params, cfg, mesh: MeshShape) -> Placed:
    """Lay a whole serving tree out once for its route (the reference
    runner's rule, manual_tp_route): model axis 1 or manual TP take
    eval_shmap_shard_params, the rest eval_shard_params for
    gather-at-use."""
    manual = manual_tp_route(params, cfg, mesh)
    check_pack_stamp(params, manual, mesh)
    if mesh.size(MODEL_AXIS) == 1:
        return Placed(eval_shmap_shard_params(params, mesh), "data")
    if manual:
        return Placed(eval_shmap_shard_params(params, mesh), "manual_tp")
    specs = eval_param_pspecs(params, mesh)
    return Placed(_place(params, specs, mesh), "gather", specs)


def _gather_leaf(x: torch.Tensor, spec: Spec, group, offset: int = 0):
    """All-gather a leaf along its model-axis dim (`offset` dims of its
    spec already indexed away)."""
    if MODEL_AXIS not in spec:
        return x
    return all_gather(x, group, spec.index(MODEL_AXIS) - offset)


class GatheredLayers(dict):
    """A stacked layer tree of this rank's eval_param_pspecs shards (the
    dict holds them, so structure tests read as on the whole tree) whose
    layer `li` is all-gathered over the model group by `layer(li)`
    (models/llama.layer_slice), just before it runs. `gather(lp)` takes one
    layer's shards (views of the stack's, as models/llama.forward_embeds
    unbinds them) to the whole layer."""

    def __init__(self, local: Params, specs: Params, group):
        super().__init__(local)
        self.specs, self.group = specs, group

    def gather(self, lp: Params) -> Params:
        return _map2(lambda x, sp: _gather_leaf(x, sp, self.group, 1), lp,
                     self.specs)

    def layer(self, li: int) -> Params:
        return self.gather(_map2(lambda x, _: x[li], dict(self), self.specs))


def gather_at_use(placed: Placed, group) -> Params:
    """The compute tree of a "gather" placement: the leaves outside the
    LLM layer stack gathered now, the stack as GatheredLayers."""
    local, specs = placed.params, placed.specs
    out = {}
    for key, sub in local.items():
        if key == "llm":
            llm = {k: (GatheredLayers(v, specs["llm"][k], group)
                       if k == "layers" else
                       _map2(lambda x, sp: _gather_leaf(x, sp, group), v,
                             specs["llm"][k]))
                   for k, v in sub.items()}
            out[key] = llm
        else:
            out[key] = _map2(lambda x, sp: _gather_leaf(x, sp, group), sub,
                             specs[key])
    return out


# --------------------------------------------------------------------------
# Training: FSDP/TP placement and the differentiable gather-at-use.
# --------------------------------------------------------------------------


def _check_train_spec(spec: Spec, ndim: int) -> None:
    axes = [a for a in spec if a is not None]
    if (len(spec) not in (0, ndim) or any(a not in AXIS_NAMES for a in axes)
            or len(set(axes)) != len(axes)):
        raise ValueError(f"the train gather cannot take spec {spec} of a "
                         f"{ndim}-dim leaf")


def _gather_all(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            x = all_gather(x, mesh.group(axis), dim)
    return x


class _GatherLeaf(torch.autograd.Function):
    """All-gather of a trainable shard over every axis of its spec. The
    backward gives the rank its shard's gradient: summed over "data", whose
    ranks ran other rows (a reduce-scatter where "data" splits a dim, an
    all-reduce where the leaf is replicated over it), and sliced without a
    sum over "model", whose ranks of one data shard ran the same rows on the
    whole leaf (a sum there would count every gradient `model` times)."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _gather_all(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.spec, ctx.mesh
        if MODEL_AXIS in spec and mesh.size(MODEL_AXIS) > 1:
            dim = spec.index(MODEL_AXIS)
            size = g.shape[dim] // mesh.size(MODEL_AXIS)
            g = g.narrow(dim, mesh.index(MODEL_AXIS) * size, size)
        if mesh.size(DATA_AXIS) > 1:
            group = mesh.group(DATA_AXIS)
            if DATA_AXIS in spec:
                g = reduce_scatter(g, group, spec.index(DATA_AXIS))
            else:
                g = all_reduce(g.clone(), group)
        return g.contiguous(), None, None


def gather_leaf(x, spec: Spec, mesh):
    """The whole leaf of this rank's shard `x` under `spec`, all-gathered
    over each axis of the spec; differentiable (`_GatherLeaf`) where `x`
    takes a gradient, a plain gather (nothing saved, no backward) where it
    does not. A spec this gather cannot take raises ValueError."""
    if not isinstance(x, torch.Tensor):
        return x
    _check_train_spec(spec, x.ndim)
    if x.requires_grad and torch.is_grad_enabled():
        if mesh.size(DATA_AXIS) == 1 and not any(
                a is not None and mesh.size(a) > 1 for a in spec):
            return x
        return _GatherLeaf.apply(x, spec, mesh)
    return _gather_all(x, spec, mesh)


def whole_leaf(x, spec: Spec, mesh):
    """The whole leaf of this rank's shard, gathered without autograd (a
    checkpoint's save, the 8-bit moments' update)."""
    if not isinstance(x, torch.Tensor):
        return x
    _check_train_spec(spec, x.ndim)
    with torch.no_grad():
        return _gather_all(x.detach(), spec, mesh)


def _map_like(fn, tree, specs):
    """fn(leaf, spec) over `tree`, whose keys are a subset of the spec
    tree's (a trainable or frozen half, a reference model)."""
    if isinstance(tree, dict):
        return {k: _map_like(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_like(fn, v, sp) for v, sp in zip(tree, specs)]
    return fn(tree, specs)


class TrainGatheredLayers(GatheredLayers):
    """The LLM layer stack of a train tree: this rank's param_pspecs shards,
    whose layer models/llama.forward_embeds gathers with `gather_leaf`
    inside its remat region, so the backward gathers the layer again and
    no gathered layer lives from the forward to the backward."""

    def __init__(self, local: Params, specs: Params, mesh):
        super().__init__(local, specs, None)
        self.mesh = mesh

    def gather(self, lp: Params) -> Params:
        return _map2(lambda x, sp: gather_leaf(x, sp[1:], self.mesh), lp,
                     self.specs)


class TrainLayout:
    """The training layout of a param tree on a mesh: `specs`, the
    reference's param_pspecs of the whole tree (FSDP over "data", TP over
    "model", replication where a dim does not divide its axis). `place`
    cuts a tree laid out like it (the whole tree, a trainable or frozen
    half with None placeholders) into this rank's shards; `gather` is the
    compute tree of those shards (gather-at-use); `whole` gathers them back
    without autograd."""

    def __init__(self, params: Params, mesh):
        self.mesh = mesh
        self.specs = param_pspecs(params, mesh)

    def spec(self, path) -> Spec:
        node = self.specs
        for k in path:
            node = node[k]
        return node

    def place(self, tree: Params) -> Params:
        return _map_like(lambda x, sp: local_shard(x.detach(), sp, self.mesh)
                         if isinstance(x, torch.Tensor) else x, tree,
                         self.specs)

    def whole(self, tree: Params) -> Params:
        return _map_like(lambda x, sp: whole_leaf(x, sp, self.mesh), tree,
                         self.specs)

    def gather(self, tree: Params) -> Params:
        """The leaves outside the LLM layer stack gathered now (vocab
        tables, final norm, projector; the tower is replicated), the stack
        as TrainGatheredLayers."""
        def leaves(sub, specs):
            return _map_like(lambda x, sp: gather_leaf(x, sp, self.mesh),
                             sub, specs)

        out = {}
        for key, sub in tree.items():
            if key == "llm":
                out[key] = {
                    k: (TrainGatheredLayers(v, self.specs[key][k], self.mesh)
                        if k == "layers" else leaves(v, self.specs[key][k]))
                    for k, v in sub.items()}
            else:
                out[key] = leaves(sub, self.specs[key])
        return out


def check_train_rows(batch, mesh: MeshShape, packed: bool = False) -> None:
    """A train step on a mesh takes each rank's rows: the batch's rows (a
    packed batch's token rows, its 2-dim arrays) must divide the data axis,
    or ValueError names it. shard_packed_batch would replicate rows that do
    not, and the loss would count them `data` times. (A packed image stack
    that does not divide is replicated, and llava.forward_packed's gather
    still finds each image at its global index.)"""
    n = mesh.size(DATA_AXIS)
    for key, x in batch.items():
        shape = _shape(x)
        rows = len(shape) == 2 if packed else bool(shape)
        if rows and shape[0] % n:
            raise ValueError(f"batch {key!r} has {shape[0]} rows, which do "
                             f"not divide the mesh data axis size ({n})")
