"""Batched evaluation generation, single-device greedy path.

Counterpart of halva_tpu/evals/runner.py's BatchedGenerator for greedy
decode: prompts are tokenized with the conversation template, sorted by
length, batched, right-padded to a bucket, and tail batches are filled with
dead rows (prompt length 0, zero image) that the decode marks done at step
0. Answers are written as JSONL rows with the reference's schema.

Quantized trees (int8, int4) and quantized KV caches (`kv_quant`) run.
Not ported yet (they raise NotImplementedError): sampling, beam search,
device meshes, continuous batching, speculative decode and the prefetch
pool. PIL and halva_tpu.mm_utils are imported where an image or a prompt
is processed, so importing this module needs neither.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from halva_tpu_torch import tree
from halva_tpu_torch.config import LlavaConfig
from halva_tpu_torch.ops.generate import decode_tokens, generate_greedy

CHAIR_PROMPT = "Describe the image in detail."


@dataclasses.dataclass
class EvalRequest:
    question_id: Any
    text: str  # raw question text (no image marker)
    image_path: Optional[str]  # None = text-only
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def build_prompt(text: str, template_name: str = "v1",
                 mm_use_im_start_end: bool = False,
                 with_image: bool = True) -> str:
    from halva_tpu.constants import DEFAULT_IMAGE_TOKEN
    from halva_tpu.conversation import get_template

    qs = text
    if with_image:
        marker = DEFAULT_IMAGE_TOKEN
        if mm_use_im_start_end:
            marker = "<im_start>" + marker + "<im_end>"
        qs = marker + "\n" + qs
    return get_template(template_name).prompt(qs)


class BatchedGenerator:
    """Length-bucketed batched greedy decode over a prepared model. The
    device is the device of the params' LLM tensors."""

    def __init__(
        self,
        params: Dict,
        cfg: LlavaConfig,
        tokenizer,
        image_processor,
        image_aspect_ratio: str = "pad",
        template_name: str = "v1",
        batch_size: int = 8,
        max_new_tokens: int = 1024,
        prompt_bucket: int = 64,
        attn_impl: str = "auto",
        kv_quant=False,  # False | True | "int8" | "int4"
        **unported,
    ):
        if unported:
            raise NotImplementedError(
                f"BatchedGenerator: {sorted(unported)} not ported yet "
                "(ROADMAP queue 1: the port runs greedy single-device decode)"
            )
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        self.proc = image_processor
        self.aspect = image_aspect_ratio
        self.template = template_name
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.bucket = prompt_bucket
        self.attn_impl = attn_impl
        self.kv_quant = kv_quant
        self.eos_id = tokenizer.eos_token_id
        # any tensor leaf: a quantized tree has embedding_q, not embedding
        self.device = next(t for _, t in tree.flatten(params["llm"])
                           if isinstance(t, torch.Tensor)).device
        self.last_stats: Dict = {}

    def _tokenize(self, req: EvalRequest) -> List[int]:
        from halva_tpu.mm_utils import tokenizer_image_token

        prompt = build_prompt(
            req.text,
            self.template,
            mm_use_im_start_end=self.cfg.mm_use_im_start_end,
            with_image=req.image_path is not None,
        )
        return tokenizer_image_token(prompt, self.tok)

    def _load_image(self, req: EvalRequest) -> np.ndarray:
        if req.image_path is None:
            # text-only: zero image; the splice masks the image block of
            # rows without the sentinel
            sz = self.proc.crop_size
            return np.zeros((3, sz, sz), np.float32)
        from PIL import Image

        from halva_tpu.mm_utils import process_images

        with Image.open(req.image_path) as im:
            img = im.convert("RGB")
        return process_images([img], self.proc, self.aspect)[0]

    def _build_batch(self, requests, ids_all, idxs):
        """Host work for one batch: image decode and padding; tail batches
        are padded with dead rows."""
        imgs = np.stack([self._load_image(requests[i]) for i in idxs])
        ids_list = [ids_all[i] for i in idxs]
        lens = np.array([len(x) for x in ids_list], np.int32)
        tgt = -(-int(lens.max()) // self.bucket) * self.bucket
        batch_ids = np.zeros((self.batch_size, tgt), np.int32)
        for j, ids in enumerate(ids_list):
            batch_ids[j, : len(ids)] = ids
        pad = self.batch_size - len(idxs)
        imgs = np.concatenate(
            [imgs.astype(np.float32),
             np.zeros((pad,) + imgs.shape[1:], np.float32)])
        lens = np.concatenate([lens, np.zeros(pad, np.int32)])
        return batch_ids, imgs, lens

    def run(
        self,
        requests: Sequence[EvalRequest],
        on_result: Optional[Callable[[EvalRequest, str], None]] = None,
    ) -> List[str]:
        """Greedy-decode all requests; returns the text of each, in input
        order. Timing lands in self.last_stats."""
        from halva_tpu.conversation import get_template

        ids_all = [self._tokenize(r) for r in requests]
        order = sorted(range(len(requests)), key=lambda i: len(ids_all[i]))
        results: List[str] = [""] * len(requests)
        stop = get_template(self.template).stop_str()
        host_s = device_s = 0.0
        for s in range(0, len(order), self.batch_size):
            idxs = order[s : s + self.batch_size]
            t0 = time.perf_counter()
            batch_ids, imgs, lens = self._build_batch(requests, ids_all, idxs)
            t1 = time.perf_counter()
            with torch.inference_mode():
                tokens, num = generate_greedy(
                    self.params,
                    self.cfg,
                    torch.from_numpy(batch_ids).to(self.device),
                    torch.from_numpy(imgs).to(self.device),
                    torch.from_numpy(lens).to(self.device),
                    max_new_tokens=self.max_new_tokens,
                    eos_id=self.eos_id,
                    attn_impl=self.attn_impl,
                    kv_quant=self.kv_quant,
                )
            tokens = tokens.cpu().numpy()  # host readback = fence
            host_s += t1 - t0
            device_s += time.perf_counter() - t1
            texts = decode_tokens(tokens, num.cpu().numpy(), self.tok,
                                  self.eos_id, stop_strs=(stop,))
            for j, i in enumerate(idxs):
                results[i] = texts[j]
                if on_result:
                    on_result(requests[i], texts[j])
        n = max(1, len(requests))
        self.last_stats = {
            "host_ms_per_img": host_s / n * 1e3,
            "device_ms_per_img": device_s / n * 1e3,
        }
        return results


def write_answers_jsonl(path: str, requests: Sequence[EvalRequest],
                        texts: Sequence[str], model_id: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for req, text in zip(requests, texts):
            row = {
                "question_id": req.question_id,
                "prompt": req.text,
                "text": text,
                "answer_id": uuid.uuid4().hex[:22],
                "model_id": model_id,
                "metadata": {},
            }
            row.update(req.extra)
            f.write(json.dumps(row) + "\n")
            f.flush()
