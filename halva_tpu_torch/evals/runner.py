"""Batched evaluation generation on one device or a device mesh.

Counterpart of halva_tpu/evals/runner.py's BatchedGenerator for greedy
decode, nucleus sampling (`temperature` > 0, `top_p`), beam search
(`num_beams`), speculative greedy decode (`spec_k`) and continuous batching
(`continuous`, ops/continuous.py): prompts are tokenized with the
conversation template, sorted by length, batched, right-padded to a bucket,
and tail batches are filled with dead rows (prompt length 0, zero image)
that the decode marks done at step 0. Answers are written as JSONL rows
with the reference's schema.

Quantized trees (int8, int4) and quantized KV caches (`kv_quant`) run.
With `prefetch_workers` > 0 the host work of each batch (image decode on a
thread pool, padding) runs in a lookahead thread (utils/prefetch.py) while
the device decodes the batch before. The constructor takes the
reference's arguments. With a `mesh` (parallel/mesh.py, one process a
GPU) every rank builds the same batches, places the weights once for their
route (parallel/partition.place_serving), decodes the rows of its data
index and gets every row's text back; the reference's refusals hold
(continuous, speculative, beams with a model axis, a batch that does not
divide the data axis). PIL and mm_utils are imported where an image or a
prompt is processed, so importing this module needs neither.

The request builders of the reference's loader scripts (`chair_requests`,
`vqa_requests`, `amber_requests`, `mmhal_requests`, `hallusion_requests`)
and `split_chunk` are copies of halva_tpu/evals/runner.py's.
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
from halva_tpu_torch.ops.generate import decode_tokens, generate
from halva_tpu_torch.ops.speculative import generate_speculative
from halva_tpu_torch.parallel import partition
from halva_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

CHAIR_PROMPT = "Describe the image in detail."
_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def chair500_image_list() -> List[str]:
    with open(os.path.join(_DATA_DIR, "chair500.json")) as f:
        return json.load(f)


def split_chunk(lst: Sequence, num_chunks: int, chunk_idx: int) -> List:
    """Reference get_chunk (model_vqa_loader.py:19-27)."""
    import math

    size = math.ceil(len(lst) / num_chunks)
    chunks = [
        list(lst[i : i + size]) for i in range(0, len(lst), size)
    ]
    while len(chunks) < num_chunks:
        chunks.append([])
    return chunks[chunk_idx]


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
    """Length-bucketed batched decode over a prepared model: greedy by
    default, nucleus sampling when temperature > 0, beam search (num_beams >
    1, HF semantics), speculative greedy (spec_k >= 2, the verify width) or
    continuous batching. The device is the device of the params' LLM
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
        # sampling only: batch bi draws from seed + bi * B (+ d * B / dp on
        # data shard d of a mesh: ops/generate.py)
        seed: int = 0,
        mesh=None,
        prefetch_workers: int = 0,
        kv_quant=False,  # False | True | "int8" | "int4"
        continuous: bool = False,
        spec_k: int = 0,  # >= 2: speculative greedy decode
    ):
        if spec_k >= 2 and (num_beams > 1 or temperature > 0 or continuous
                            or mesh is not None):
            raise ValueError(
                "spec_k is single-device greedy decode (ops/speculative.py); "
                "drop num_beams / temperature / continuous / mesh"
            )
        if continuous and (num_beams > 1 or temperature > 0):
            raise ValueError(
                "continuous is greedy single-beam decode "
                "(ops/continuous.py); drop num_beams / temperature")
        if continuous and mesh is not None:
            raise ValueError(
                "continuous runs single-device; drop mesh or use "
                "num_chunks fanout")
        if num_beams > 1 and mesh is not None and mesh.size(MODEL_AXIS) > 1:
            raise ValueError(
                "num_beams > 1 supports {data: N} meshes only (ops/beam.py); "
                "drop the model axis or use num_chunks fanout")
        if num_beams > 1 and temperature > 0:
            raise ValueError("beam search is deterministic; drop "
                             "temperature or num_beams")
        if spec_k == 1 or spec_k < 0 or num_beams < 1:
            raise ValueError(
                f"spec_k must be 0 or >= 2 and num_beams >= 1, got "
                f"spec_k={spec_k} num_beams={num_beams}"
            )
        if mesh is not None:
            if batch_size % mesh.size(DATA_AXIS):
                raise ValueError(
                    f"batch_size {batch_size} must be a multiple of the "
                    f"mesh data axis size ({mesh.size(DATA_AXIS)})")
            # placed once, in the layout every generate call expects
            params = partition.place_serving(params, cfg, mesh)
        self.mesh = mesh
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
        self.temperature = temperature
        self.top_p = top_p
        self.seed = seed
        self.continuous = continuous
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.spec_k = spec_k
        self.prefetch_workers = prefetch_workers
        self.eos_id = tokenizer.eos_token_id
        # any tensor leaf: a quantized tree has embedding_q, not embedding
        local = params.params if mesh is not None else params
        self.device = next(t for _, t in tree.flatten(local["llm"])
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

    def _build_batch(self, requests, ids_all, idxs, pool):
        """Host work for one batch: image decode (on `pool` when given)
        and padding; tail batches are padded with dead rows."""
        t0 = time.perf_counter()
        if pool is not None:
            imgs_l = list(pool.map(
                lambda i: self._load_image(requests[i]), idxs))
        else:
            imgs_l = [self._load_image(requests[i]) for i in idxs]
        imgs = np.stack(imgs_l)
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
        return idxs, batch_ids, imgs, lens, time.perf_counter() - t0

    def _run_continuous(self, requests, on_result):
        """Rows freed by EOS refill from the queue (ops/continuous.py), so
        the longest caption no longer gates the batch. Images load lazily,
        ahead of the engine on the prefetch pool; budget exits are trimmed
        as EOS."""
        from concurrent.futures import ThreadPoolExecutor

        from halva_tpu_torch.conversation import get_template
        from halva_tpu_torch.ops.continuous import ContinuousEngine, Request

        t_all = time.perf_counter()
        ids_all = [self._tokenize(r) for r in requests]
        max_len = max((len(x) for x in ids_all), default=1)
        pad = -(-max_len // self.bucket) * self.bucket
        pool = None
        futures = {}
        if self.prefetch_workers > 0:
            pool = ThreadPoolExecutor(max_workers=self.prefetch_workers)
            ahead = 2 * self.batch_size

            def image_for(i):
                # serve from the lookahead window; top it up as we go
                for j in range(i, min(i + ahead, len(requests))):
                    if j not in futures:
                        futures[j] = pool.submit(self._load_image,
                                                 requests[j])
                return futures.pop(i).result()
        else:
            def image_for(i):
                return self._load_image(requests[i])

        engine = ContinuousEngine(
            self.params, self.cfg, batch=self.batch_size,
            max_new_tokens=self.max_new_tokens, eos_id=self.eos_id,
            prompt_pad=pad, chunk=int(os.environ.get("HALVA_CB_CHUNK", "16")),
            kv_quant=self.kv_quant, attn_impl=self.attn_impl)
        reqs = [Request(ids=np.asarray(ids_all[i], np.int32),
                        image=(lambda i=i: image_for(i)),
                        budget=self.max_new_tokens)
                for i in range(len(requests))]
        try:
            with torch.inference_mode():
                out = engine.run(reqs)
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        stop = get_template(self.template).stop_str()
        results = []
        for i, (toks, n) in enumerate(out):
            toks = toks.copy()
            toks[n:] = self.eos_id  # budget exits carry no eos marker
            text = decode_tokens(toks[None], np.asarray([n]), self.tok,
                                 self.eos_id, stop_strs=(stop,))[0]
            results.append(text)
            if on_result:
                on_result(requests[i], text)
        self.last_stats = {
            "continuous": True,
            "wall_s": round(time.perf_counter() - t_all, 3),
            **engine.stats,
        }
        return results

    def run(
        self,
        requests: Sequence[EvalRequest],
        on_result: Optional[Callable[[EvalRequest, str], None]] = None,
    ) -> List[str]:
        """Decode all requests; returns the text of each, in input order.
        Timing (and the speculative counts) land in self.last_stats."""
        from concurrent.futures import ThreadPoolExecutor

        from halva_tpu_torch.conversation import get_template
        from halva_tpu_torch.utils.prefetch import prefetch

        if self.continuous:
            return self._run_continuous(requests, on_result)

        ids_all = [self._tokenize(r) for r in requests]
        order = sorted(range(len(requests)), key=lambda i: len(ids_all[i]))
        results: List[str] = [""] * len(requests)
        stop = get_template(self.template).stop_str()
        host_s = device_s = 0.0
        first_batch_s = None  # batch 0: first-use set-up + prefill + decode
        spec_steps = spec_emitted = 0
        pool = None
        if self.prefetch_workers > 0:
            pool = ThreadPoolExecutor(max_workers=self.prefetch_workers)
        batches = [order[s : s + self.batch_size]
                   for s in range(0, len(order), self.batch_size)]
        it = (self._build_batch(requests, ids_all, idxs, pool)
              for idxs in batches)
        if pool is not None:
            it = prefetch(it, depth=2)
        try:
            for bi, (idxs, batch_ids, imgs, lens, bh) in enumerate(it):
                host_s += bh
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
                    mesh=self.mesh,
                )
                with torch.inference_mode():
                    if self.spec_k >= 2:
                        kwargs.pop("mesh")
                        tokens, num, sstats = generate_speculative(
                            *args, draft_k=self.spec_k, **kwargs)
                        spec_steps += sstats["verify_steps"]
                        spec_emitted += sstats["emitted_tokens"]
                    elif self.num_beams > 1:
                        tokens, num = generate_beam(
                            *args, num_beams=self.num_beams,
                            length_penalty=self.length_penalty, **kwargs)
                    else:
                        tokens, num = generate(
                            *args, temperature=self.temperature,
                            top_p=self.top_p,
                            seed=self.seed + bi * self.batch_size, **kwargs)
                tokens = tokens.cpu().numpy()  # host readback = fence
                batch_s = time.perf_counter() - t1
                device_s += batch_s
                if first_batch_s is None:
                    first_batch_s = batch_s
                    from halva_tpu_torch.utils.phases import record

                    # startup attribution: batch 0 carries the kernel
                    # build and the first-use set-up
                    record("first_batch_generate", batch_s)
                texts = decode_tokens(tokens, num.cpu().numpy(), self.tok,
                                      self.eos_id, stop_strs=(stop,))
                for j, i in enumerate(idxs):
                    results[i] = texts[j]
                    if on_result:
                        on_result(requests[i], texts[j])
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
        n = max(1, len(requests))
        # the reference's keys and rounding; `overlapped` says whether a
        # prefetch pool hid the host work
        self.last_stats = {
            "host_ms_per_img": round(host_s / n * 1e3, 2),
            "device_ms_per_img": round(device_s / n * 1e3, 2),
            "host_s": round(host_s, 3),
            "device_s": round(device_s, 3),
            "first_batch_s": round(first_batch_s or 0.0, 3),
            "overlapped": self.prefetch_workers > 0,
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


# ---- request builders (the reference's loader scripts) -------------------


def vqa_requests(
    question_file: str,
    image_folder: str,
    num_chunks: int = 1,
    chunk_idx: int = 0,
    additional_input_prompt: str = "",
) -> List[EvalRequest]:
    """model_vqa_loader (POPE/MME/generic VQA question JSONL)."""
    questions = [json.loads(l) for l in open(question_file)]
    questions = split_chunk(questions, num_chunks, chunk_idx)
    return [
        EvalRequest(
            question_id=q["question_id"],
            text=q["text"] + additional_input_prompt,
            image_path=os.path.join(image_folder, q["image"]),
        )
        for q in questions
    ]


def chair_requests(
    image_folder: str, num_chunks: int = 1, chunk_idx: int = 0
) -> List[EvalRequest]:
    """model_chair_loader: fixed 500 COCO val2014 images, detail prompt."""
    images = split_chunk(chair500_image_list(), num_chunks, chunk_idx)
    return [
        EvalRequest(
            question_id=int(name.split("_")[-1].split(".")[0]),
            text=CHAIR_PROMPT,
            image_path=os.path.join(image_folder, name),
            extra={"image_id": int(name.split("_")[-1].split(".")[0])},
        )
        for name in images
    ]


def amber_requests(
    query_file: str, image_folder: str
) -> List[EvalRequest]:
    """model_amber_loader: AMBER query json (id/image/query)."""
    with open(query_file) as f:
        queries = json.load(f)
    return [
        EvalRequest(
            question_id=q["id"],
            text=q["query"],
            image_path=os.path.join(image_folder, q["image"]),
            extra={"id": q["id"]},
        )
        for q in queries
    ]


def mmhal_requests(
    data: Sequence[dict], image_folder: str
) -> List[EvalRequest]:
    """model_vqa_mmhal: MMHal-Bench records (96 questions). `data` is the
    loaded dataset rows (HF datasets dict or the response_template json);
    images must be pre-downloaded into image_folder keyed by the url
    basename (the reference also uses pre-downloaded images)."""
    reqs = []
    for i, row in enumerate(data):
        url = row.get("image_src") or row.get("image_path", "")
        fname = row.get("image_id") or os.path.basename(url)
        if not os.path.splitext(str(fname))[1]:
            fname = f"{fname}.jpg"
        reqs.append(
            EvalRequest(
                question_id=i,
                text=row["question"],
                image_path=os.path.join(image_folder, str(fname)),
                extra={
                    "question_type": row.get("question_type"),
                    "image_content": row.get("image_content"),
                    "gt_answer": row.get("gt_answer"),
                },
            )
        )
    return reqs


def hallusion_requests(
    data: Sequence[dict], image_folder: str
) -> List[EvalRequest]:
    """hallusion_bench/random_guess generate step: VD rows and VS rows
    with visual_input>0 carry an image; visual_input==0 is text-only."""
    reqs = []
    for i, row in enumerate(data):
        if int(row.get("visual_input", 0)) > 0:
            image_path = os.path.join(
                image_folder, row["filename"][2:]
            )
        else:
            image_path = None
        reqs.append(
            EvalRequest(
                question_id=i,
                text=row["question"],
                image_path=image_path,
                extra={
                    k: row.get(k)
                    for k in (
                        "category", "subcategory", "set_id",
                        "figure_id", "question_id", "visual_input",
                        "gt_answer", "gt_answer_details",
                    )
                },
            )
        )
    return reqs
