"""Interactive single-image chat (the reference try_halva.ipynb, L6).

    python -m halva_tpu_torch.chat --model-path pritamqu/halva7b-lora \
        --model-base liuhaotian/llava-v1.5-7b --image cat.jpg

Counterpart of scripts/chat.py, with its flags plus `--device` (the card
unless the caller names the CPU). Loads and merges the model once, then
answers questions about the image, one at a time: each question is
tokenized with the image marker, the image re-encoded and the prompt
prefilled anew (no KV is kept across questions), then decoded greedily, or
by beam search with `--num-beams` > 1.

The device half is `ChatSession` (torch only); `main` is the host half:
arguments, the load, the tokenizer, the image decode and the question
loop. Pillow and transformers are imported inside `main`, so the session
runs where neither is installed.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from halva_tpu_torch import tree
from halva_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
from halva_tpu_torch.mm_utils import tokenizer_image_token
from halva_tpu_torch.ops.beam import generate_beam
from halva_tpu_torch.ops.generate import decode_tokens, generate_greedy


class ChatSession:
    """Answers questions about one image with a loaded tree: the prompt of
    `template` around the image marker and the question, greedy decode or
    beam search (`beam_route="auto"`) of up to `max_new_tokens`, the text
    cut at the template's stop string. `pixels` is the processed image,
    (1, C, H, W). The device is the device of the params' LLM tensors.
    After each answer, `last` holds its prompt ids, tokens (1, max_new) and
    count of generated tokens."""

    def __init__(self, params, cfg, tokenizer, pixels, template,
                 max_new_tokens: int = 512, num_beams: int = 1):
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        self.template = template
        self.max_new_tokens = max_new_tokens
        self.num_beams = num_beams
        # any tensor leaf: a quantized tree has embedding_q, not embedding
        self.device = next(t for _, t in tree.flatten(params["llm"])
                           if isinstance(t, torch.Tensor)).device
        self.pixels = torch.as_tensor(np.asarray(pixels, np.float32)).to(
            self.device)
        self.last = {}

    def prompt_ids(self, question: str) -> List[int]:
        prompt = self.template.prompt(DEFAULT_IMAGE_TOKEN + "\n" + question)
        return tokenizer_image_token(prompt, self.tok)

    def answer(self, question: str) -> str:
        ids = self.prompt_ids(question)
        batch = torch.tensor([ids], dtype=torch.int32, device=self.device)
        lens = torch.tensor([len(ids)], dtype=torch.int32, device=self.device)
        eos = self.tok.eos_token_id
        with torch.inference_mode():
            if self.num_beams > 1:
                toks, num = generate_beam(
                    self.params, self.cfg, batch, self.pixels, lens,
                    max_new_tokens=self.max_new_tokens, eos_id=eos,
                    num_beams=self.num_beams, beam_route="auto")
            else:
                toks, num = generate_greedy(
                    self.params, self.cfg, batch, self.pixels, lens,
                    max_new_tokens=self.max_new_tokens, eos_id=eos)
        toks, num = toks.cpu(), num.cpu()
        self.last = {"ids": ids, "tokens": toks, "num": num}
        return decode_tokens(toks.numpy(), num.numpy(), self.tok, eos,
                             stop_strs=(self.template.stop_str(),))[0]


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="halva_tpu_torch.chat")
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-base", default=None)
    p.add_argument("--vision-tower-path", default=None)
    p.add_argument("--image", required=True)
    p.add_argument("--conv-mode", default="v1")
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="int8: per-channel int8 weights, every dense W8A8 "
                        "(torch._int_mm) unless HALVA_W8A8=0, which sends "
                        "them to the weight-only int8 GEMM kernel")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--question", default=None, help="one-shot question")
    p.add_argument("--num-beams", type=int, default=1,
                   help="beam search (HF semantics, ops/beam.py); "
                        "1 = greedy")
    p.add_argument("--device", default="cuda",
                   help="the device that holds the model (cpu: the "
                        "kernels' plain versions)")
    args = p.parse_args(argv)

    from PIL import Image
    from transformers import AutoTokenizer

    from halva_tpu_torch.conversation import get_template
    from halva_tpu_torch.mm_utils import process_images, processor_for_vision
    from halva_tpu_torch.models.builder import load_pretrained_model

    params, cfg = load_pretrained_model(
        args.model_path,
        args.model_base,
        vision_tower_path=args.vision_tower_path,
        quant=args.quant,
        device=args.device,
    )
    tok_dir = args.tokenizer or args.model_base or args.model_path
    try:
        # reference loaders use the slow (sentencepiece) tokenizer
        tok = AutoTokenizer.from_pretrained(tok_dir, use_fast=False)
    except Exception:
        # fast-only tokenizer dirs (no sentencepiece model) still load
        tok = AutoTokenizer.from_pretrained(tok_dir, use_fast=True)
    # the processor of the loaded tower (CLIP-336 for llava-1.5, SigLIP-384
    # for VILA)
    proc = processor_for_vision(cfg.vision)
    image = Image.open(args.image).convert("RGB")
    pixels = process_images([image], proc, cfg.image_aspect_ratio)
    session = ChatSession(params, cfg, tok, pixels,
                          get_template(args.conv_mode),
                          max_new_tokens=args.max_new_tokens,
                          num_beams=args.num_beams)

    if args.question:
        print(session.answer(args.question))
        return
    print("Ask about the image (empty line to quit).")
    while True:
        try:
            q = input("USER: ").strip()
        except EOFError:
            break
        if not q:
            break
        print("ASSISTANT:", session.answer(q))


if __name__ == "__main__":
    main()
