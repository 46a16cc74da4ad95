"""Adapter export: the flat `lora_state_dict` as one npz file.

Counterpart of halva_tpu/train/checkpoint.py:save_adapter/load_adapter, the
same file format, so an adapter saved by either package loads in the other.
np.savez writes a bfloat16 array as 2-byte void ("|V2"), which np.load gives
back as such; `load_adapter` reads those as bfloat16 (the only 2-byte float
an adapter holds). The orbax CheckpointManager of the reference comes with
the port of train/run.py.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def save_adapter(path: str, adapter_sd: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in adapter_sd.items()})


def load_adapter(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with np.load(path) as z:
        for k in z.files:
            a = z[k]
            if a.dtype.kind == "V" and a.dtype.itemsize == 2:
                import ml_dtypes  # only a bf16 adapter needs it

                a = a.view(ml_dtypes.bfloat16)
            out[k] = a
    return out
