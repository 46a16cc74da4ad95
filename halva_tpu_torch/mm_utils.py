"""Host-side multimodal preprocessing: images and image-token tokenization.

Replaces the reference's torch/PIL helpers (llava/mm_utils.py)
with numpy equivalents.  Everything here runs on the host CPU — device code
never sees a ragged or dynamic shape, so all outputs are plain numpy arrays
the caller pads/buckets before shipping to the device.

Bit-parity notes:
- `preprocess_clip` reproduces HF `CLIPImageProcessor.preprocess` exactly
  (shortest-edge bicubic resize via PIL, center crop, 1/255 rescale, mean/std
  normalize) because the eval-metric parity target requires bit-exact pixel
  inputs (SURVEY.md §7 hard part #1).
- `tokenizer_image_token` reproduces the reference contract
  (llava/mm_utils.py:43-62): split the prompt on "<image>", keep a single
  leading BOS, and join chunks with the IMAGE_TOKEN_INDEX sentinel.
"""

from __future__ import annotations

import base64
from io import BytesIO
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from halva_tpu_torch.constants import IMAGE_TOKEN_INDEX

# OpenAI CLIP normalization constants (match HF CLIPImageProcessor defaults
# for openai/clip-vit-large-patch14-336).
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# SigLIP normalization (VILA tower, google/siglip-so400m-patch14-384).
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def load_image_from_base64(image: str) -> Image.Image:
    return Image.open(BytesIO(base64.b64decode(image)))


def expand2square(pil_img: Image.Image, background_color) -> Image.Image:
    """Pad the shorter side with `background_color`, centering the image."""
    width, height = pil_img.size
    if width == height:
        return pil_img
    if width > height:
        result = Image.new(pil_img.mode, (width, width), background_color)
        result.paste(pil_img, (0, (width - height) // 2))
        return result
    result = Image.new(pil_img.mode, (height, height), background_color)
    result.paste(pil_img, ((height - width) // 2, 0))
    return result


def _resize_shortest_edge(img: Image.Image, size: int) -> Image.Image:
    """HF get_resize_output_image_size(size={"shortest_edge": size})."""
    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    if short == size:
        new_short, new_long = size, long
    else:
        new_short = size
        new_long = int(size * long / short)
    new_w, new_h = (new_short, new_long) if w <= h else (new_long, new_short)
    return img.resize((new_w, new_h), resample=Image.BICUBIC)


def _center_crop(arr: np.ndarray, crop: int) -> np.ndarray:
    """Center-crop HWC array to (crop, crop); pads if smaller (HF semantics)."""
    h, w = arr.shape[:2]
    top = (h - crop) // 2
    left = (w - crop) // 2
    if top >= 0 and left >= 0:
        return arr[top : top + crop, left : left + crop]
    out = np.zeros((crop, crop, arr.shape[2]), dtype=arr.dtype)
    dst_top = max(-top, 0)
    dst_left = max(-left, 0)
    src_top = max(top, 0)
    src_left = max(left, 0)
    h_eff = min(h, crop)
    w_eff = min(w, crop)
    out[dst_top : dst_top + h_eff, dst_left : dst_left + w_eff] = arr[
        src_top : src_top + h_eff, src_left : src_left + w_eff
    ]
    return out


class ImageProcessor:
    """Functional stand-in for HF CLIPImageProcessor / SiglipImageProcessor.

    CLIP mode: shortest-edge resize -> center crop -> rescale -> normalize.
    SigLIP mode (square_resize=True): direct resize to (size, size).
    """

    def __init__(
        self,
        size: int = 336,
        crop_size: Optional[int] = None,
        mean: Sequence[float] = OPENAI_CLIP_MEAN,
        std: Sequence[float] = OPENAI_CLIP_STD,
        square_resize: bool = False,
    ):
        self.size = size
        self.crop_size = crop_size if crop_size is not None else size
        self.image_mean = tuple(mean)
        self.image_std = tuple(std)
        self.square_resize = square_resize

    def __call__(self, image: Image.Image) -> np.ndarray:
        """Returns CHW float32 pixel values."""
        if image.mode != "RGB":
            image = image.convert("RGB")
        if self.square_resize:
            image = image.resize((self.size, self.size), resample=Image.BICUBIC)
            arr = np.asarray(image, dtype=np.float32)
        else:
            image = _resize_shortest_edge(image, self.size)
            arr = np.asarray(image, dtype=np.float32)
            arr = _center_crop(arr, self.crop_size)
        arr = arr * (1.0 / 255.0)
        mean = np.asarray(self.image_mean, dtype=np.float32)
        std = np.asarray(self.image_std, dtype=np.float32)
        arr = (arr - mean) / std
        return arr.transpose(2, 0, 1)  # CHW

    def preprocess(self, image: Image.Image) -> np.ndarray:
        return self(image)


def clip_vit_l_336_processor() -> ImageProcessor:
    return ImageProcessor(size=336, crop_size=336)


def processor_for_vision(vision_cfg) -> ImageProcessor:
    """Build the preprocessing that matches a ViTConfig: CLIP-family
    towers get shortest-edge resize + center crop with OpenAI stats;
    SigLIP-family (no cls token, no pre-LN) gets square resize with
    SigLIP stats. Sized from the config so tiny test presets and
    resolution-elevated towers preprocess consistently."""
    if not vision_cfg.use_cls_token and not vision_cfg.use_pre_layernorm:
        return ImageProcessor(
            size=vision_cfg.image_size,
            mean=SIGLIP_MEAN,
            std=SIGLIP_STD,
            square_resize=True,
        )
    return ImageProcessor(
        size=vision_cfg.image_size, crop_size=vision_cfg.image_size
    )


def siglip_384_processor() -> ImageProcessor:
    return ImageProcessor(
        size=384, mean=SIGLIP_MEAN, std=SIGLIP_STD, square_resize=True
    )


def process_images(
    images: Sequence[Image.Image],
    image_processor: ImageProcessor,
    image_aspect_ratio: Optional[str] = None,
) -> np.ndarray:
    """Batch preprocess; `pad` mode squares each image with the mean color.

    Mirrors reference llava/mm_utils.py:28-40. Returns (N, C, H, W) float32.
    """
    out: List[np.ndarray] = []
    for image in images:
        if image_aspect_ratio == "pad":
            bg = tuple(int(x * 255) for x in image_processor.image_mean)
            image = expand2square(image.convert("RGB"), bg)
        out.append(image_processor(image))
    return np.stack(out, axis=0)


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """Tokenize a prompt containing "<image>" markers.

    Each marker becomes a single `image_token_index` sentinel; a single BOS
    is kept at the front if the tokenizer emits one. Matches reference
    llava/mm_utils.py:43-62 token-for-token.
    """
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    joined: List[List[int]] = []
    for i, ch in enumerate(chunks):
        joined.append(ch)
        if i != len(chunks) - 1:
            joined.append(sep)
    for x in joined:
        ids.extend(x[offset:])
    return ids


def get_model_name_from_path(model_path: str) -> str:
    parts = model_path.strip("/").split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


def find_stop(
    text: str, stop_strs: Sequence[str]
) -> Tuple[str, bool]:
    """Truncate `text` at the first occurrence of any stop string."""
    cut = len(text)
    hit = False
    for s in stop_strs:
        idx = text.find(s)
        if idx != -1 and idx < cut:
            cut = idx
            hit = True
    return text[:cut], hit
