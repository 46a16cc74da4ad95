"""VILA-variant training surface.

Covers what the VILA stack adds over the LLaVA flagship path
(SURVEY.md §2.2):
- component-wise tuning flags tune_language_model / tune_vision_tower /
  tune_mm_projector (vila/train/train_halva.py:340-346) -> a trainable
  mask over the (llm, vision, projector) sub-trees, composable with LoRA;
- RoPE linear context-length extension when model_max_length exceeds the
  base max_position_embeddings (vila/model/language_model/builder.py:43-51);
- per-component checkpoint layout (llm/ vision_tower/ mm_projector/,
  vila/model/llava_arch.py:138-182);
- the published VILA-13B/384 DPA recipe (src_vila/halva_vila_13b.sh).

The model itself is the same functional LLaVA assembly — the VILA tower
(SigLIP-384) and projector (mlp_downsample) are config choices.

Counterpart of halva_tpu/train/vila.py. The component directories are
train/checkpoint.save_params directories of this package, and config.json
is the reference's file, key and text.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from halva_tpu_torch.config import (
    LlamaConfig,
    LlavaConfig,
    VILA_13B_384,
)
from halva_tpu_torch.train import checkpoint as ckpt_lib
from halva_tpu_torch.train.lora import trainable_mask

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TuningFlags:
    tune_language_model: bool = False
    tune_vision_tower: bool = False
    tune_mm_projector: bool = False
    lora_llm: bool = True  # VILA HALVA: LoRA on model.llm only (:395-404)


def component_trainable_mask(
    params: Params, flags: TuningFlags
) -> Params:
    """Bool tree combining LoRA-factor training with full-component
    unfreezing per the VILA flags."""
    extra = []
    if flags.tune_language_model:
        extra.append(r"^llm/")
    if flags.tune_vision_tower:
        extra.append(r"^vision/")
    if flags.tune_mm_projector:
        extra.append(r"^projector/")
    mask = trainable_mask(params, extra_trainable=tuple(extra))
    if not flags.lora_llm:
        # strip LoRA-only trainability when adapters are disabled
        def strip(node, name=""):
            if isinstance(node, dict):
                return {k: strip(v, str(k)) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [strip(v) for v in node]
            if name in ("lora_a", "lora_b") and not flags.tune_language_model:
                return False
            return node

        mask = strip(mask)
    return mask


def context_length_extension(
    cfg: LlamaConfig, model_max_length: Optional[int]
) -> LlamaConfig:
    """Linear RoPE scaling when the target length exceeds the base
    (vila builder.py:43-51: factor = ceil-free float ratio)."""
    if (
        model_max_length is None
        or model_max_length <= cfg.max_position_embeddings
    ):
        return cfg
    factor = float(model_max_length) / cfg.max_position_embeddings
    return dataclasses.replace(
        cfg,
        rope_scaling=factor,
        max_position_embeddings=model_max_length,
    )


_COMPONENT_DIRS = {
    "llm": "llm",
    "vision": "vision_tower",
    "projector": "mm_projector",
}


def save_components(
    directory: str, params: Params, cfg: Optional[LlavaConfig] = None
) -> None:
    """Per-component dirs llm/ vision_tower/ mm_projector/ (the VILA
    save layout, vila/model/llava_arch.py:138-182) plus a config.json
    so eval can reconstruct the model WITHOUT a pre-built param tree
    (the reference's prepare_config_for_eval role,
    vila/model/builder_halva.py:260)."""
    for key, sub in _COMPONENT_DIRS.items():
        if key in params:
            ckpt_lib.save_params(
                os.path.join(directory, sub), params[key]
            )
    if cfg is not None:
        import json

        from halva_tpu_torch.config import config_to_dict

        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(
                {"halva_tpu_config": config_to_dict(cfg)}, f, indent=1
            )


def is_component_checkpoint(directory: str) -> bool:
    return os.path.isdir(os.path.join(directory, "llm")) and os.path.isdir(
        os.path.join(directory, "mm_projector")
    )


def load_component_config(directory: str) -> LlavaConfig:
    import json

    from halva_tpu_torch.config import llava_config_from_dict

    with open(os.path.join(directory, "config.json")) as f:
        d = json.load(f)
    return llava_config_from_dict(d["halva_tpu_config"])


def load_components(
    directory: str, like: Optional[Params] = None, device="cuda"
) -> Params:
    """like=None restores exactly as saved (the tree file keeps the tree
    structure + dtypes) — the eval loader path needs no template. Leaves
    go to `device`, the card unless the caller names the CPU."""
    out: Params = {}
    for key, sub in _COMPONENT_DIRS.items():
        p = os.path.join(directory, sub)
        if os.path.isdir(p):
            out[key] = ckpt_lib.load_params(
                p, like[key] if like else None, device=device
            )
    return out


# Published VILA-13B/384 HALVA recipe (src_vila/halva_vila_13b.sh:8-17,41-47)
VILA_13B_RECIPE = dict(
    model_cfg=VILA_13B_384,
    loss_alpha=0.2,
    learning_rate=2.5e-5,
    model_max_length=4096,
    lora_r=128,
    lora_alpha=256.0,
    tuning=TuningFlags(tune_mm_projector=True, lora_llm=True),
    warmup_ratio=0.03,
    epochs=1,
)


def main(argv=None):
    """Dedicated VILA-HALVA train CLI (the reference train_halva_vila.py
    entry): the shared DPA loop with the published VILA-13B/384 recipe
    defaults — SigLIP-384 tower + mlp_downsample projector preset,
    alpha=0.2, lr=2.5e-5, RoPE extension to 4096, tune_mm_projector,
    per-component checkpoint export. Any flag can be overridden."""
    from halva_tpu_torch.train import run as run_lib

    defaults = {
        "--model": "vila-13b-384",
        "--loss-alpha": "0.2",
        "--learning-rate": "2.5e-5",
        "--max-length": "4096",
        "--model-max-length": "4096",
        "--tune-mm-projector": "true",
        "--save-component-dirs": "true",
        "--output-dir": "out/halva-vila",
    }
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    for flag, value in defaults.items():
        if flag not in argv:
            argv += [flag, value]
    run_lib.main(argv)


if __name__ == "__main__":
    main()
