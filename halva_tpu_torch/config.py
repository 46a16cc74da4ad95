"""Model/architecture configuration dataclasses and presets.

One config system for the whole framework (replaces the reference's scatter
of HF config.json mutations, e.g. llava/train/train_halva.py:1139-1160).
Configs are frozen dataclasses, so they are hashable and compare by value
(own copy of halva_tpu/config.py: the port imports nothing of that package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Decoder-only LLM (Llama family) architecture.

    Reference architecture parity: llava/model/language_model/modelling_llama.py
    (vendored HF Llama). GQA-ready via num_kv_heads.
    """

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None => MHA
    head_dim: Optional[int] = None  # None => hidden_size // num_heads
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: Optional[float] = None  # linear scaling factor (VILA ctx ext)
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    # alt-backend knobs (VILA's llava_mistral / llava_mpt / llava_gemma):
    sliding_window: Optional[int] = None  # Mistral local attention
    position_embedding: str = "rope"  # rope | alibi (MPT)
    mlp_act: str = "silu"  # silu | gelu_tanh (Gemma) | gelu (MPT)
    rmsnorm_unit_offset: bool = False  # Gemma: scale is (1 + w)
    embed_scale: bool = False  # Gemma: embeddings * sqrt(hidden)
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm (MPT)
    gated_mlp: bool = True  # False: up -> act -> down (MPT)
    qkv_bias: bool = False

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Vision transformer (CLIP/SigLIP tower) architecture."""

    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    use_cls_token: bool = True  # CLIP has a class embedding; SigLIP doesn't
    use_pre_layernorm: bool = True  # CLIP pre_layrnorm; SigLIP doesn't
    hidden_act: str = "quick_gelu"  # CLIP: quick_gelu; SigLIP: gelu_tanh
    # InternViT variants (vila/model/multimodal_encoder/intern/
    # modeling_intern_vit.py): RMSNorm blocks, RMSNorm over the FULL embed
    # dim on q/k ("qk_normalization"), per-channel LayerScale ls1/ls2,
    # bias-free qkv
    norm_type: str = "layernorm"  # layernorm | rmsnorm (InternViT)
    qk_norm: bool = False  # InternViT qk_normalization
    layer_scale: bool = False  # InternViT ls1/ls2
    qkv_bias: bool = True  # InternViT-6B sets False
    # RADIO (timm ViT backbone, vila/model/multimodal_encoder/
    # radio_encoder.py): learnable register tokens after cls, excluded
    # from output features
    num_register_tokens: int = 0

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.use_cls_token else 0) + self.num_register_tokens

    @property
    def num_positions(self) -> int:
        return self.num_patches + self.num_prefix_tokens


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    """Full multimodal VLM: vision tower + projector + LLM.

    mm_vision_select_layer=-2 and select_feature="patch" match the LLaVA-1.5
    recipe (reference llava/model/multimodal_encoder/clip_encoder.py:27-35).
    """

    llm: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    mm_projector_type: str = "mlp2x_gelu"  # linear | mlpNx_gelu | mlp_downsample | identity
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"  # patch | cls_patch
    image_aspect_ratio: str = "pad"
    downsample_factor: int = 2  # for mlp_downsample (VILA 2x2 fold)
    # RADIO tower wrapper knobs (vila radio_encoder.py): unnormalized
    # pixels in, final-norm'd last-layer patch features out, optional
    # pixel-unshuffle token fold
    vision_tower_type: str = "vit"  # vit (CLIP/SigLIP/Intern) | radio
    radio_pixel_unshuffle: int = 0  # 0/1 off; 2 = 4x token reduction
    radio_skip_final_norm: bool = False
    # vocab-extension flags recorded in the checkpoint config (upstream
    # LLaVA's model loader re-adds these tokens at eval load;
    # models/vocab.py holds the mean-init resize)
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False

    @property
    def vision_feature_size(self) -> int:
        """Per-token feature dim delivered to the projector."""
        d = self.vision.hidden_size
        if self.vision_tower_type == "radio" and self.radio_pixel_unshuffle > 1:
            d *= self.radio_pixel_unshuffle**2
        return d

    @property
    def num_image_tokens(self) -> int:
        n = self.vision.num_patches
        if self.mm_vision_select_feature == "cls_patch":
            n += 1
        if self.vision_tower_type == "radio" and self.radio_pixel_unshuffle > 1:
            n //= self.radio_pixel_unshuffle**2
        if self.mm_projector_type == "mlp_downsample":
            n //= self.downsample_factor**2
        return n


# --------------------------------------------------------------------------
# Presets
# --------------------------------------------------------------------------

LLAMA_7B = LlamaConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=11008,
    num_layers=32,
    num_heads=32,
    max_position_embeddings=4096,
)

LLAMA_13B = LlamaConfig(
    vocab_size=32000,
    hidden_size=5120,
    intermediate_size=13824,
    num_layers=40,
    num_heads=40,
    max_position_embeddings=4096,
)

MISTRAL_7B = LlamaConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    max_position_embeddings=32768,
    rope_theta=10000.0,
    sliding_window=4096,
)

MPT_7B = LlamaConfig(
    vocab_size=50432,
    hidden_size=4096,
    intermediate_size=16384,
    num_layers=32,
    num_heads=32,
    max_position_embeddings=2048,
    tie_word_embeddings=True,
    position_embedding="alibi",
    mlp_act="gelu",
    norm_type="layernorm",
    gated_mlp=False,
)

GEMMA_2B = LlamaConfig(
    vocab_size=256000,
    hidden_size=2048,
    intermediate_size=16384,
    num_layers=18,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    max_position_embeddings=8192,
    rms_norm_eps=1e-6,
    tie_word_embeddings=True,
    mlp_act="gelu_tanh",
    rmsnorm_unit_offset=True,
    embed_scale=True,
)

CLIP_VIT_L_336 = ViTConfig()

SIGLIP_SO400M_384 = ViTConfig(
    image_size=384,
    patch_size=14,
    hidden_size=1152,
    intermediate_size=4304,
    num_layers=27,
    num_heads=16,
    layer_norm_eps=1e-6,
    use_cls_token=False,
    use_pre_layernorm=False,
    hidden_act="gelu_tanh",
)

INTERNVIT_6B_448 = ViTConfig(
    image_size=448,
    patch_size=14,
    hidden_size=3200,
    intermediate_size=12800,
    num_layers=48,
    num_heads=25,
    layer_norm_eps=1e-6,
    use_cls_token=True,
    use_pre_layernorm=False,
    hidden_act="gelu",
    norm_type="rmsnorm",
    qk_norm=True,
    layer_scale=True,
    qkv_bias=False,
)

# RADIO ViT-H/16 backbone (NVlabs/RADIO; loaded via torch.hub in the
# reference, radio_encoder.py:168-173). timm ViT: LayerNorm, cls token +
# register tokens, gelu.
RADIO_VIT_H_432 = ViTConfig(
    image_size=432,
    patch_size=16,
    hidden_size=1280,
    intermediate_size=5120,
    num_layers=32,
    num_heads=16,
    layer_norm_eps=1e-6,
    use_cls_token=True,
    use_pre_layernorm=False,
    hidden_act="gelu",
    num_register_tokens=4,
)

LLAVA_V15_7B = LlavaConfig(llm=LLAMA_7B, vision=CLIP_VIT_L_336)
LLAVA_V15_13B = LlavaConfig(llm=LLAMA_13B, vision=CLIP_VIT_L_336)
VILA_13B_384 = LlavaConfig(
    llm=LLAMA_13B,
    vision=SIGLIP_SO400M_384,
    mm_projector_type="mlp_downsample",
)

# Tiny configs for tests / CI (CPU-mesh runnable).
LLAMA_TINY = LlamaConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    max_position_embeddings=512,
)

VIT_TINY = ViTConfig(
    image_size=28,
    patch_size=14,
    hidden_size=32,
    intermediate_size=64,
    num_layers=2,
    num_heads=2,
)

LLAVA_TINY = LlavaConfig(llm=LLAMA_TINY, vision=VIT_TINY)

PRESETS = {
    "llama-7b": LLAMA_7B,
    "llama-13b": LLAMA_13B,
    "mistral-7b": MISTRAL_7B,
    "gemma-2b": GEMMA_2B,
    "mpt-7b": MPT_7B,
    "llava-v1.5-7b": LLAVA_V15_7B,
    "llava-v1.5-13b": LLAVA_V15_13B,
    "vila-13b-384": VILA_13B_384,
    "llava-tiny": LLAVA_TINY,
}


# --------------------------------------------------------------------------
# Serialization (per-component checkpoint metadata)
#
# The reference's VILA eval loader reconstructs a model from a saved
# composite config (upstream VILA's HALVA loader and its
# prepare_config_for_eval: nested llm_cfg/vision_tower_cfg/
# mm_projector_cfg dicts in config.json). Here the whole LlavaConfig
# round-trips through one JSON dict.
# --------------------------------------------------------------------------


def config_to_dict(cfg: LlavaConfig) -> dict:
    return dataclasses.asdict(cfg)


def llava_config_from_dict(d: dict) -> LlavaConfig:
    d = dict(d)
    llm = LlamaConfig(**d.pop("llm"))
    vision = ViTConfig(**d.pop("vision"))
    return LlavaConfig(llm=llm, vision=vision, **d)
