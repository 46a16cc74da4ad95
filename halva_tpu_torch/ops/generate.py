"""Batched KV-cached greedy decoding.

Counterpart of halva_tpu/ops/generate.py, greedy single-device path. The
prefill encodes the images, splices them into the prompts, fills the
head-major prompt cache and takes the first token; the decode loop then
emits one token per step from a small generated-token cache until every row
hit EOS or the budget. Rows with prompt length 0 are dead rows: done at
step 0, they emit eos_id.

The reference compiles both phases into one XLA program with a
`lax.while_loop`; here the loop runs on the host, and testing `done.all()`
syncs the host once per step.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from halva_tpu_torch.config import IMAGE_TOKEN_INDEX, LlavaConfig
from halva_tpu_torch.models import llama, llava

Params = Dict[str, Any]


def _prefill_impl(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,  # (B, S) right-padded, -200 image sentinel
    images: torch.Tensor,  # (B, 3, H, W)
    prompt_lengths: torch.Tensor,  # (B,) valid tokens before the splice
    attn_impl: str = "auto",
):
    """Returns (first token (B,) int32, first logits (B, V) fp32, spliced
    lengths (B,), prompt cache, spliced segment ids (B, S + T - 1))."""
    b, s = input_ids.shape
    dev = input_ids.device
    seg = (torch.arange(s, device=dev)[None, :]
           < prompt_lengths[:, None]).to(torch.int32)
    feats = llava.encode_images(params, cfg, images)
    sp = llava.splice_image_tokens(params, cfg, input_ids, feats, seg)
    hidden, prompt_cache = llama.prefill(
        params["llm"], cfg.llm, sp.embeds, sp.segment_ids, sp.positions,
        cache_dtype=torch.bfloat16, attn_impl=attn_impl,
    )
    has_img = (input_ids == IMAGE_TOKEN_INDEX).any(dim=1)
    spliced_len = prompt_lengths + has_img.to(prompt_lengths.dtype) * (
        cfg.num_image_tokens - 1)
    last_idx = (spliced_len - 1).clamp(0, hidden.shape[1] - 1).long()
    last_hidden = hidden[torch.arange(b, device=dev), last_idx][:, None]
    first_logits = llama.lm_logits(params["llm"], cfg.llm, last_hidden)[:, 0]
    first_tok = first_logits.argmax(dim=-1).to(torch.int32)
    return first_tok, first_logits, spliced_len, prompt_cache, sp.segment_ids


def init_gen_cache_like(cfg_llm, rows: int, max_new_tokens: int,
                        prompt_cache: Params) -> Params:
    """Generated-token cache in the prompt cache's dtype and device."""
    if "k_scale" in prompt_cache or "k4" in prompt_cache:
        raise NotImplementedError(
            "int8/int4 caches are not ported yet (ROADMAP queue 2, K4 "
            "int8/int4 modes)"
        )
    k = prompt_cache["k"]
    return llama.init_gen_cache(cfg_llm, rows, max_new_tokens,
                                dtype=k.dtype, device=k.device)


def _decode_impl(
    params: Params,
    cfg: LlavaConfig,
    first_tok: torch.Tensor,
    spliced_len: torch.Tensor,
    prompt_cache: Params,
    prompt_seg: torch.Tensor,
    max_new_tokens: int,
    eos_id: int,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Greedy loop: (tokens (B, max_new) int32, num_generated (B,), steps).
    Slots past the last step hold 0; tokens after a row's EOS are eos_id."""
    b = first_tok.shape[0]
    dev = first_tok.device
    gen_cache = init_gen_cache_like(cfg.llm, b, max_new_tokens, prompt_cache)
    tokens = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)
    cur = first_tok
    done = spliced_len == 0  # dead rows
    step = 0
    while step < max_new_tokens and not bool(done.all()):
        tok = torch.where(done, torch.full_like(cur, eos_id), cur)
        tokens[:, step] = tok
        done = done | (tok == eos_id)
        pos = spliced_len + step
        embeds = llama.embed(params["llm"], tok[:, None])
        logits, gen_cache = llama.decode_step(
            params["llm"], cfg.llm, embeds, pos, prompt_cache, prompt_seg,
            gen_cache, step, attn_impl=attn_impl,
        )
        cur = logits.argmax(dim=-1).to(torch.int32)
        step += 1
    written = torch.arange(max_new_tokens, device=dev)[None, :] < step
    num = ((tokens != eos_id) & written).sum(dim=1).to(torch.int32)
    return tokens, num, step


def generate_greedy(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,
    images: torch.Tensor,
    prompt_lengths: torch.Tensor,
    max_new_tokens: int,
    eos_id: int,
    attn_impl: str = "auto",
    kv_quant=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding: (tokens (B, max_new) int32, num_generated (B,))."""
    if kv_quant:
        raise NotImplementedError(
            "int8/int4 KV caches are not ported yet (ROADMAP queue 2, K4 "
            "int8/int4 modes)"
        )
    first_tok, _, spliced_len, prompt_cache, prompt_seg = _prefill_impl(
        params, cfg, input_ids, images, prompt_lengths, attn_impl)
    tokens, num, _ = _decode_impl(
        params, cfg, first_tok, spliced_len, prompt_cache, prompt_seg,
        max_new_tokens, eos_id, attn_impl)
    return tokens, num


def decode_tokens(tokens, num_generated, tokenizer, eos_id: int,
                  stop_strs=()):
    """Host-side detokenize + stop-string trim (the reference's
    KeywordsStoppingCriteria semantics)."""
    outs = []
    for row in np.asarray(tokens):
        ids = []
        for tid in row.tolist():
            if tid == eos_id:
                break
            ids.append(tid)
        text = tokenizer.decode(ids, skip_special_tokens=True)
        for sstr in stop_strs:
            idx = text.find(sstr)
            if idx != -1:
                text = text[:idx]
        outs.append(text.strip())
    return outs
