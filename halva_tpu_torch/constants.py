"""Model-level constants shared across the framework.

Parity notes: mirrors the constant contract of the reference
(llava/constants.py:7-14) — the sentinel values are part of
the data format (token id -200 marks the image splice point in token
streams; -100 marks ignored label positions) and must match for checkpoint
and dataset compatibility.
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"

# DPA phrase-mask span tags as they appear in HALVA training data
# (reference: llava/train/train_halva.py MASK_PLACEHOLDER_{START,END}).
MASK_PLACEHOLDER_START = "<MASK>"
MASK_PLACEHOLDER_END = "</MASK>"
