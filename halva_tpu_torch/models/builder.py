"""Model loading for eval: HF checkpoints, PEFT adapters, merging,
quantization and the quantized-tree disk cache.

Counterpart of halva_tpu/models/builder.py (which replaces the reference
eval builder, llava/model/builder.py:11-109: base model ->
non_lora_trainables -> PEFT adapter -> merge_and_unload) with pure tree ops
over the same param format. Three sources are supported:

- HF-format LLaVA checkpoint dirs (pytorch_model*.bin, or *.safetensors
  where the safetensors package is installed: the released
  liuhaotian/llava-v1.5-* and pritamqu/halva*-lora layouts), converted
  through models/convert_hf.py;
- VILA component checkpoints (llm/ vision_tower/ mm_projector/ and a
  config.json, written by the train CLI under save_component_dirs;
  train/vila.py);
- native dirs written by train/checkpoint.save_params (where the reference
  reads its orbax dirs).

PEFT adapter weights
(adapter_model.bin / .safetensors with base_model.model.* keys,
lora_A/lora_B) are translated into lora_a/lora_b factors so released HALVA
adapters load directly; the reference's own adapter.npz loads too.

Where the reference holds the checkpoint as fp32 numpy on the host and
quantizes there, this loader keeps the file's dtype, moves one shard at a
time to the device and quantizes there. The values it quantizes are the
same: an fp32 copy is made only where the reference computes in fp32 on
something that is not the file's value (a LoRA merge, a vocab extension),
so the tree equals the reference's leaf for leaf, bit for bit.

`quant_tp` > 1 packs an int4 tree for a quant_tp-way manual-TP mesh
(w4_matmul.quantize_params_int4(tp=)), where the tree and config qualify
for that route (parallel/partition.manual_tp_ready), as the reference
does.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from halva_tpu_torch import tree
from halva_tpu_torch.config import LLAVA_V15_13B, LLAVA_V15_7B, LlavaConfig
from halva_tpu_torch.models import convert_hf
from halva_tpu_torch.train import lora as lora_lib

Params = Dict[str, Any]

QUANTS = ("none", "int8", "int4", "int4g")


def load_hf_state_dict(model_dir: str,
                       device="cpu") -> Dict[str, torch.Tensor]:
    """All weight shards of an HF checkpoint dir as one flat dict of
    tensors in the file's dtype, each shard moved to `device` as it is
    read, so that the host holds one shard at a time."""
    sd: Dict[str, torch.Tensor] = {}
    sts = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    bins = sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin")))
    if sts:
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(
                f"{model_dir} holds .safetensors shards and the safetensors "
                "package is not installed") from e
        for p in sts:
            sd.update(load_file(p, device=str(torch.device(device))))
    elif bins:
        for p in bins:
            shard = torch.load(p, map_location="cpu", weights_only=True)
            sd.update({k: v.to(device) for k, v in shard.items()})
            del shard
    else:
        raise FileNotFoundError(f"no weight shards in {model_dir}")
    return sd


def config_from_hf(model_dir: str) -> LlavaConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    cfg = LLAVA_V15_13B if hf.get("hidden_size") == 5120 else LLAVA_V15_7B
    return dataclasses.replace(
        cfg,
        mm_use_im_start_end=bool(hf.get("mm_use_im_start_end", False)),
        mm_use_im_patch_token=bool(hf.get("mm_use_im_patch_token", False)),
    )


def llava_params_from_hf(sd: Dict[str, torch.Tensor],
                         cfg: LlavaConfig) -> Params:
    """Full LLaVA checkpoint (LLM + vision tower + projector) -> tree.

    The released llava-v1.5 checkpoints store the CLIP tower under
    model.vision_tower.vision_tower.vision_model.*; some exports omit it
    (tower loaded from the CLIP repo): the tree then has no vision entry
    and `attach_vision_tower` fills it."""
    params: Params = {
        "llm": convert_hf.llama_from_hf(sd, cfg.llm),
        "projector": convert_hf.projector_from_hf(sd, cfg.mm_projector_type),
    }
    tower_prefix = "model.vision_tower.vision_tower.vision_model."
    if any(k.startswith(tower_prefix) for k in sd):
        params["vision"] = convert_hf.clip_vit_from_hf(
            sd, cfg.vision, prefix=tower_prefix)
    return params


def attach_vision_tower(params: Params, tower_dir: str, cfg: LlavaConfig,
                        device="cpu") -> Params:
    """Load a standalone CLIP/SigLIP tower checkpoint dir (HF format)."""
    sd = load_hf_state_dict(tower_dir, device)
    params = dict(params)
    params["vision"] = convert_hf.clip_vit_from_hf(
        sd, cfg.vision, prefix="vision_model.")
    return params


# ---- PEFT adapter translation --------------------------------------------

_PEFT_NAME_MAP = {
    "q_proj": ("attn", "wq"),
    "k_proj": ("attn", "wk"),
    "v_proj": ("attn", "wv"),
    "o_proj": ("attn", "wo"),
    "gate_proj": ("mlp", "gate"),
    "up_proj": ("mlp", "up"),
    "down_proj": ("mlp", "down"),
}

_PEFT_KEY_RE = re.compile(
    r"model\.layers\.(\d+)\.(self_attn|mlp)\.(\w+)\.lora_([AB])\.weight$")


def peft_adapter_to_lora(
    adapter_sd: Dict[str, Any],
    num_layers: int,
    lora_alpha: float,
    lora_r: int,
) -> Dict[str, Dict[str, np.ndarray]]:
    """PEFT adapter_model dict -> {module_path: {lora_a, lora_b,
    lora_scale}} as fp32 numpy, stacked over layers. PEFT stores lora_A
    (r, in) and lora_B (out, r); ours are (in, r) and (r, out)."""
    per_module: Dict[Tuple[str, str], Dict[str, Dict[int, np.ndarray]]] = {}
    for key, val in adapter_sd.items():
        m = _PEFT_KEY_RE.search(key)
        if not m:
            continue
        layer, _, proj, ab = m.groups()
        if proj not in _PEFT_NAME_MAP:
            continue
        slot = per_module.setdefault(_PEFT_NAME_MAP[proj],
                                     {"A": {}, "B": {}})
        if isinstance(val, torch.Tensor):
            val = val.detach().float().cpu().numpy()
        slot[ab][int(layer)] = np.asarray(val, np.float32)

    out: Dict[str, Dict[str, np.ndarray]] = {}
    scale = np.asarray(lora_alpha / lora_r, np.float32)
    for (group, name), slot in per_module.items():
        out[f"layers/{group}/{name}"] = {
            "lora_a": np.stack(
                [slot["A"][i].T for i in range(num_layers)], axis=0),
            "lora_b": np.stack(
                [slot["B"][i].T for i in range(num_layers)], axis=0),
            "lora_scale": np.full((num_layers,), scale, np.float32),
        }
    return out


def _read_adapter_weights(adapter_dir: str) -> Dict[str, torch.Tensor]:
    st_path = os.path.join(adapter_dir, "adapter_model.safetensors")
    if os.path.exists(st_path):
        from safetensors.torch import load_file

        return load_file(st_path)
    return torch.load(os.path.join(adapter_dir, "adapter_model.bin"),
                      map_location="cpu", weights_only=True)


def apply_peft_adapter(params: Params, adapter_dir: str,
                       cfg: LlavaConfig) -> Params:
    """Load a PEFT adapter (adapter_model.bin or .safetensors +
    adapter_config.json) into a copy of the tree: fp32 factors on each
    kernel's device."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    modules = peft_adapter_to_lora(
        _read_adapter_weights(adapter_dir), cfg.llm.num_layers,
        acfg["lora_alpha"], acfg["r"])
    params = tree.map_tree(lambda x: x, params)
    for path, factors in modules.items():
        node = params["llm"]
        for part in path.split("/"):
            node = node[part]
        device = node["kernel"].device
        node.update({k: torch.from_numpy(v).to(device)
                     for k, v in factors.items()})
    return params


def apply_non_lora_trainables(params: Params, sd: Dict[str, Any],
                              cfg: LlavaConfig) -> Params:
    """non_lora_trainables.bin: extra full weights trained alongside LoRA
    (reference builder.py:50-65), typically mm_projector."""
    params = tree.map_tree(lambda x: x, params)
    norm = {}
    for k, v in sd.items():
        if "mm_projector" in k:
            # "base_model.model.model.mm_projector.0.weight" etc.
            norm["model." + k[k.index("mm_projector"):]] = v
    if norm:
        params["projector"] = convert_hf.projector_from_hf(
            norm, cfg.mm_projector_type)
    return params


def params_dir_config(directory: str, params: Params) -> LlavaConfig:
    """The config of a save_params dir: its config.json (the train CLI's
    {"halva_tpu_config": ...} record or an HF config), else the llava-v1.5
    preset of the tree's width, as config_from_hf picks it."""
    path = os.path.join(directory, "config.json")
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        if "halva_tpu_config" in d:
            from halva_tpu_torch.config import llava_config_from_dict

            return llava_config_from_dict(d["halva_tpu_config"])
        return config_from_hf(directory)
    width = params["llm"]["embed"]["embedding"].shape[-1]
    return LLAVA_V15_13B if width == 5120 else LLAVA_V15_7B


def _merge_lora_fp32(params: Params) -> None:
    """merge_lora in place, into fp32 kernels: the reference merges into its
    fp32 host copy of the checkpoint (the same expression), and the merged
    value must not be rounded to the file's dtype before it is quantized or
    cast. In place on the loader's own tree, so that each file-dtype kernel
    is freed as its merged fp32 one is made (a 7B tree holds ~26 GB of
    those)."""
    for _, p in lora_lib._iter_dense(params):
        if "lora_a" in p:
            a, b, scale = (p.pop(k).float()
                           for k in ("lora_a", "lora_b", "lora_scale"))
            delta = torch.einsum("...ir,...ro->...io", a, b)
            p["kernel"] = p["kernel"].float() + delta * scale[..., None, None]


def _vocab_tables_fp32(params: Params) -> Params:
    """The embedding table and lm_head kernel in fp32, where the
    reference's extension computes them (its tree is fp32 there)."""
    llm = dict(params["llm"])
    llm["embed"] = dict(llm["embed"], embedding=llm["embed"][
        "embedding"].float())
    if "lm_head" in llm:
        llm["lm_head"] = dict(llm["lm_head"],
                              kernel=llm["lm_head"]["kernel"].float())
    return dict(params, llm=llm)


def _fence(device) -> None:
    """Make a phase's time include its device work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    dtype=torch.bfloat16,
    vision_tower_path: Optional[str] = None,
    quant: str = "none",  # none | int8 | int4 | int4g
    tokenizer=None,
    quant_tp: int = 1,
    device="cuda",
) -> Tuple[Params, LlavaConfig]:
    """The reference's eval loader contract (builder.py:11):

    - model_path is a per-component dir (llm/ vision_tower/
      mm_projector/ + config.json, written by train with
      save_component_dirs=True): the config from the saved metadata, each
      component loaded, the LoRA factors training saved merged
      (merge_lora, in the kernels' dtype, as the reference's);
    - model_path is a save_params dir: the tree as saved, any LoRA factors
      merged the same way;
    - model_base given (LoRA checkpoint): load the base, apply
      non_lora_trainables and the PEFT adapter (or an adapter.npz of
      either package), merge;
    - else: a plain full checkpoint.

    With `tokenizer` given, checkpoints whose config records
    mm_use_im_start_end / mm_use_im_patch_token get the reference eval
    loader's token re-add and mean-init embedding resize
    (llava/model/builder.py:89-96 -> models/vocab.py), before any
    quantization. quant "int8" is per-channel int8 (quant.quantize_params),
    "int4" / "int4g" the packed-int4 serving tree with per-channel or
    128-row group scales (w4_matmul.quantize_params_int4); float leaves end
    in `dtype`, int8 payloads and bf16 scales keep theirs.

    Quantized loads are cached on disk (utils/treecache.py, keyed by the
    checkpoint files and the quant config; HALVA_QUANT_CACHE=off disables):
    a warm load reads the npz and copies it to `device`, a leaf at a time.
    `device` is the card unless the caller names the CPU."""
    from halva_tpu_torch.utils.phases import phase

    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")

    def put_leaf(x: torch.Tensor) -> torch.Tensor:
        # int8 payloads, bf16 scales and integer metadata keep their dtype
        if x.dtype in (torch.int8, torch.int32, torch.bfloat16):
            return x.to(device)
        return x.to(device=device, dtype=dtype)

    cache_path = None
    if quant != "none":
        from halva_tpu_torch.utils import treecache

        cdir = treecache.cache_dir()
        if cdir is not None:
            key = treecache.cache_key(
                quant, quant_tp, dtype,
                [model_path, model_base, vision_tower_path],
                extra={"tok_len": len(tokenizer) if tokenizer is not None
                       else None})
            cache_path = os.path.join(cdir, f"qtree_{key}.npz")
            if os.path.exists(cache_path):
                with phase("qtree_stream_to_device"):
                    params, cfg = treecache.load_tree(cache_path,
                                                      put=put_leaf)
                    _fence(device)
                return params, cfg

    from halva_tpu_torch.train import checkpoint as ckpt_lib
    from halva_tpu_torch.train import vila as vila_lib

    with phase("checkpoint_load"):
        if vila_lib.is_component_checkpoint(model_path):
            cfg = vila_lib.load_component_config(model_path)
            params = vila_lib.load_components(model_path, device=device)
            # training saves UNMERGED LoRA factors; eval merges them
            # (merge_and_unload semantics) — the fused decode paths read
            # kernels only, so unmerged adapters would be silently dropped
            params = lora_lib.merge_lora(params)
        elif ckpt_lib.is_params_dir(model_path):
            params = lora_lib.merge_lora(
                ckpt_lib.load_params(model_path, device=device))
            cfg = params_dir_config(model_path, params)
        elif model_base is not None:
            cfg = config_from_hf(model_base)
            params = llava_params_from_hf(
                load_hf_state_dict(model_base, device), cfg)
            nlt = os.path.join(model_path, "non_lora_trainables.bin")
            if os.path.exists(nlt):
                sd = torch.load(nlt, map_location=device, weights_only=True)
                params = apply_non_lora_trainables(params, sd, cfg)
            ours = os.path.join(model_path, "adapter.npz")
            if os.path.exists(ours):
                from halva_tpu_torch.train.checkpoint import load_adapter

                params = lora_lib.load_lora_state_dict(
                    params, load_adapter(ours))
            else:
                params = apply_peft_adapter(params, model_path, cfg)
            _merge_lora_fp32(params)
        else:
            cfg = config_from_hf(model_path)
            params = llava_params_from_hf(
                load_hf_state_dict(model_path, device), cfg)
        if "vision" not in params:
            if vision_tower_path is None:
                raise FileNotFoundError(
                    "checkpoint has no vision tower; pass vision_tower_path")
            params = attach_vision_tower(params, vision_tower_path, cfg,
                                         device)
        _fence(device)
    if tokenizer is not None and (cfg.mm_use_im_start_end
                                  or cfg.mm_use_im_patch_token):
        from halva_tpu_torch.models.vocab import (
            extend_tokenizer_and_embeddings,
        )

        params, cfg, _ = extend_tokenizer_and_embeddings(
            _vocab_tables_fp32(params), cfg, tokenizer,
            mm_use_im_patch_token=cfg.mm_use_im_patch_token,
            mm_use_im_start_end=cfg.mm_use_im_start_end)
    if quant == "none":
        with phase("device_put"):
            params = tree.map_tree(
                lambda x: x.to(device=device, dtype=dtype), params)
            _fence(device)
        return params, cfg
    with phase("quantize"):
        # no autograd graph: the tree is an eval tree
        with torch.no_grad():
            if quant in ("int4", "int4g"):
                from halva_tpu_torch.ops.w4_matmul import quantize_params_int4

                from halva_tpu_torch.parallel.partition import (
                    manual_tp_ready,
                )

                # tp-packed only where the manual-TP route will take the
                # tree: anywhere else its channels are block-permuted
                eff_tp = quant_tp
                if eff_tp > 1 and not manual_tp_ready(params, cfg, eff_tp):
                    eff_tp = 1
                params = quantize_params_int4(
                    params, group_size=128 if quant == "int4g" else None,
                    tp=eff_tp)
            else:
                from halva_tpu_torch.ops.quant import quantize_params

                params = quantize_params(params)
            params = tree.map_tree(put_leaf, params)
        _fence(device)
    if cache_path is not None:
        from halva_tpu_torch.utils import treecache

        with phase("qtree_cache_npz_save"):
            treecache.save_tree(cache_path, params, cfg)
    return params, cfg
