"""Plain LLaVA over the benchmark's weights, fp32 with TF32 off.

One row at a time and one layer at a time, so that it fits beside the
bf16 weights on the card: each layer's weights are made fp32 when they are
used. A row is the text of one request with one image sentinel (-200):
its tokens before the sentinel, the image's patch features through the
projector, its tokens after; positions count from 0 over that sequence.
The decoder layer comes from the module the configuration names
(reference/<name>.py). Nothing here reads the program: no module of it is
imported and no tensor it made is used.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import clip

IMAGE_SENTINEL = -200
DENSES = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("gate", "up", "down")}


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Reference:
    def __init__(self, weights: dict, config: dict,
                 lora: Optional[Dict[str, dict]] = None):
        """weights: the benchmark's tree; config: the configuration file;
        lora: {dense path: {lora_a, lora_b, lora_scale}} as the benchmark
        made them, or None."""
        no_tf32()
        self.w = weights
        self.model = config["model"]
        self.llm = self.model["llm"]
        self.arch = importlib.import_module(
            f"portbench.reference.{config['reference']}")
        self.lora: Dict[str, Tuple[torch.Tensor, torch.Tensor, float]] = {}
        for path, p in (lora or {}).items():
            self.lora[path.rsplit("/", 1)[-1]] = (
                p["lora_a"].float(), p["lora_b"].float(),
                float(p["lora_scale"].flatten()[0]))
        self._head = None

    # ---------------------------------------------------------------- inputs

    def features(self, images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return clip.image_features(self.w, self.model, images)

    def embed_row(self, ids: Sequence[int], feats: torch.Tensor
                  ) -> torch.Tensor:
        """(n, D) fp32 input embeddings of one row's valid tokens."""
        ids = np.asarray(ids)
        table = self.w["llm"]["embed"]["embedding"]
        at = np.flatnonzero(ids == IMAGE_SENTINEL)
        parts = []
        start = 0
        if at.size:
            i = int(at[0])
            parts.append(table[torch.as_tensor(ids[:i], device=table.device,
                                               dtype=torch.long)].float())
            parts.append(feats.float())
            start = i + 1
        parts.append(table[torch.as_tensor(ids[start:], device=table.device,
                                           dtype=torch.long)].float())
        return torch.cat(parts)

    # ----------------------------------------------------------------- layers

    def layer_weights(self, li: int) -> dict:
        lay = self.w["llm"]["layers"]
        out = {}
        for group, names in DENSES.items():
            for name in names:
                if name in lay[group]:
                    out[name] = lay[group][name]["kernel"][li].float()
        for norm in ("input_norm", "post_attn_norm"):
            out[norm] = lay[norm]["scale"][li].float()
        return out

    def _layer_lora(self, li: int, leaves=None):
        if not self.lora:
            return None
        src = leaves if leaves is not None else self.lora
        return {name: (a[li], b[li], s) for name, (a, b, s) in src.items()}

    def hidden(self, rows: List[torch.Tensor], lora: bool) -> List[torch.Tensor]:
        """Final-normed hidden states of each row, without gradients, layer
        by layer over all rows."""
        xs = list(rows)
        with torch.no_grad():
            for li in range(self.llm["num_layers"]):
                lw = self.layer_weights(li)
                lo = self._layer_lora(li) if lora else None
                xs = [self.arch.layer(x, lw, lo, self.llm) for x in xs]
                del lw
            return [self.arch.final_norm(x, self.w["llm"], self.llm)
                    for x in xs]

    def hidden_grad(self, rows: List[torch.Tensor], leaves: dict
                    ) -> List[torch.Tensor]:
        """Final-normed hidden states with the LoRA branches, recording
        gradients into `leaves` ({name: (A, B, scale)}, fp32 leaves that
        require grad); each layer of each row is a checkpointed region
        that makes its fp32 weights anew, so only layer inputs stay."""
        names = list(leaves)
        flat = [t for n in names for t in leaves[n][:2]]
        scales = [leaves[n][2] for n in names]

        def run(x, li, *ab):
            lora = {n: (ab[2 * i][li], ab[2 * i + 1][li], scales[i])
                    for i, n in enumerate(names)}
            return self.arch.layer(x, self.layer_weights(li), lora, self.llm)

        xs = list(rows)
        for li in range(self.llm["num_layers"]):
            xs = [checkpoint(run, x, li, *flat, use_reentrant=False,
                             preserve_rng_state=False) for x in xs]
        return [self.arch.final_norm(x, self.w["llm"], self.llm) for x in xs]

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        if self._head is None:
            self._head = self.arch.head(self.w["llm"]).float()
        return h @ self._head

    def release(self) -> None:
        self._head = None
