"""Configuration dataclasses, presets and token constants.

Shared with halva_tpu rather than copied: `halva_tpu.config` and
`halva_tpu.constants` import no JAX, so both packages read one definition.
"""

from halva_tpu.config import (  # noqa: F401
    LLAVA_TINY,
    LLAVA_V15_7B,
    LLAVA_V15_13B,
    PRESETS,
    LlamaConfig,
    LlavaConfig,
    ViTConfig,
)
from halva_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX  # noqa: F401
