"""Batched evaluation generation, single-device deterministic decode.

Counterpart of halva_tpu/evals/runner.py's BatchedGenerator for greedy
decode, beam search (`num_beams`) and speculative greedy decode (`spec_k`):
prompts are tokenized with the conversation template, sorted by
length, batched, right-padded to a bucket, and tail batches are filled with
dead rows (prompt length 0, zero image) that the decode marks done at step
0. Answers are written as JSONL rows with the reference's schema.

Quantized trees (int8, int4) and quantized KV caches (`kv_quant`) run.
The constructor takes the reference's arguments; sampling (`temperature >
0`, `top_p < 1`), device meshes, continuous batching and the prefetch pool
are not ported yet: their neutral values pass, any other raises
NotImplementedError naming its ROADMAP item. PIL and mm_utils are imported
where an image or a prompt is processed, so importing this module needs
neither.
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
from halva_tpu_torch.ops.beam import generate_beam
from halva_tpu_torch.ops.generate import decode_tokens, generate_greedy
from halva_tpu_torch.ops.speculative import generate_speculative

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
    from halva_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
    from halva_tpu_torch.conversation import get_template

    qs = text
    if with_image:
        marker = DEFAULT_IMAGE_TOKEN
        if mm_use_im_start_end:
            marker = "<im_start>" + marker + "<im_end>"
        qs = marker + "\n" + qs
    return get_template(template_name).prompt(qs)


class BatchedGenerator:
    """Length-bucketed batched decode over a prepared model: greedy, beam
    search (num_beams > 1, HF semantics) or speculative greedy (spec_k >= 2,
    the verify width). The device is the device of the params' LLM
    tensors."""

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
        temperature: float = 0.0,
        top_p: float = 1.0,
        num_beams: int = 1,
        length_penalty: float = 1.0,
        seed: int = 0,  # sampling only: greedy, beams and drafts use none
        mesh=None,
        prefetch_workers: int = 0,
        kv_quant=False,  # False | True | "int8" | "int4"
        continuous: bool = False,
        spec_k: int = 0,  # >= 2: speculative greedy decode
    ):
        unported = {
            "temperature / top_p (sampling)": (
                temperature > 0 or top_p != 1.0, "item 9"),
            "continuous (ContinuousEngine)": (continuous, "item 9"),
            "mesh (multi-GPU)": (mesh is not None, "item 10"),
            "prefetch_workers (the host prefetch pool)": (
                prefetch_workers > 0, "item 12"),
        }
        asked = [f"{name}: ROADMAP queue 1 {item}"
                 for name, (on, item) in unported.items() if on]
        if asked:
            raise NotImplementedError(
                "BatchedGenerator: not ported yet: " + "; ".join(asked)
                + " (the port runs deterministic single-device decode: "
                "greedy, beams, speculative)"
            )
        if spec_k >= 2 and num_beams > 1:
            raise ValueError(
                "spec_k is single-device greedy decode (ops/speculative.py); "
                "drop num_beams"
            )
        if spec_k == 1 or spec_k < 0 or num_beams < 1:
            raise ValueError(
                f"spec_k must be 0 or >= 2 and num_beams >= 1, got "
                f"spec_k={spec_k} num_beams={num_beams}"
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
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.spec_k = spec_k
        self.eos_id = tokenizer.eos_token_id
        # any tensor leaf: a quantized tree has embedding_q, not embedding
        self.device = next(t for _, t in tree.flatten(params["llm"])
                           if isinstance(t, torch.Tensor)).device
        self.last_stats: Dict = {}

    def _tokenize(self, req: EvalRequest) -> List[int]:
        from halva_tpu_torch.mm_utils import tokenizer_image_token

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

        from halva_tpu_torch.mm_utils import process_images

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
        """Decode all requests; returns the text of each, in input order.
        Timing (and the speculative counts) land in self.last_stats."""
        from halva_tpu_torch.conversation import get_template

        ids_all = [self._tokenize(r) for r in requests]
        order = sorted(range(len(requests)), key=lambda i: len(ids_all[i]))
        results: List[str] = [""] * len(requests)
        stop = get_template(self.template).stop_str()
        host_s = device_s = 0.0
        first_batch_s = None  # batch 0: first-use set-up + prefill + decode
        spec_steps = spec_emitted = 0
        for s in range(0, len(order), self.batch_size):
            idxs = order[s : s + self.batch_size]
            t0 = time.perf_counter()
            batch_ids, imgs, lens = self._build_batch(requests, ids_all, idxs)
            t1 = time.perf_counter()
            args = (
                self.params,
                self.cfg,
                torch.from_numpy(batch_ids).to(self.device),
                torch.from_numpy(imgs).to(self.device),
                torch.from_numpy(lens).to(self.device),
            )
            kwargs = dict(
                max_new_tokens=self.max_new_tokens,
                eos_id=self.eos_id,
                attn_impl=self.attn_impl,
                kv_quant=self.kv_quant,
            )
            with torch.inference_mode():
                if self.spec_k >= 2:
                    tokens, num, sstats = generate_speculative(
                        *args, draft_k=self.spec_k, **kwargs)
                    spec_steps += sstats["verify_steps"]
                    spec_emitted += sstats["emitted_tokens"]
                elif self.num_beams > 1:
                    tokens, num = generate_beam(
                        *args, num_beams=self.num_beams,
                        length_penalty=self.length_penalty, **kwargs)
                else:
                    tokens, num = generate_greedy(*args, **kwargs)
            tokens = tokens.cpu().numpy()  # host readback = fence
            host_s += t1 - t0
            batch_s = time.perf_counter() - t1
            device_s += batch_s
            if first_batch_s is None:
                first_batch_s = batch_s
            texts = decode_tokens(tokens, num.cpu().numpy(), self.tok,
                                  self.eos_id, stop_strs=(stop,))
            for j, i in enumerate(idxs):
                results[i] = texts[j]
                if on_result:
                    on_result(requests[i], texts[j])
        n = max(1, len(requests))
        # the reference's keys and rounding; `overlapped` says whether a
        # prefetch pool hid the host work (never: not ported)
        self.last_stats = {
            "host_ms_per_img": round(host_s / n * 1e3, 2),
            "device_ms_per_img": round(device_s / n * 1e3, 2),
            "host_s": round(host_s, 3),
            "device_s": round(device_s, 3),
            "first_batch_s": round(first_batch_s or 0.0, 3),
            "overlapped": False,
        }
        if self.spec_k >= 2:
            self.last_stats["spec_verify_steps"] = spec_steps
            self.last_stats["spec_emitted_tokens"] = spec_emitted
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
