"""Speculative greedy decoding with prompt-lookup (n-gram) drafts.

Counterpart of halva_tpu/ops/speculative.py. Each iteration verifies K
candidate tokens per row in one pass over the model (`llama.verify_step`,
K5's shared gen stage), so the prompt KV cache is read once per accepted run
of tokens instead of once per token.

Exact by construction where verify logits equal decode logits: a draft is
accepted only when it equals the model's own argmax at its position, and
every verify step yields at least one token (the argmax at the first
position). Drafts are the tokens that followed the most recent earlier
occurrence of the current (previous, current) bigram in [prompt || emitted
tokens]; rows without a match repeat the current token. Greedy only; RoPE
configs without a sliding window.

The reference runs the loop as one `lax.while_loop`; here it runs on the
host: testing the stop condition syncs the host once per verify step, and
the counts in `stats` are read once at the end.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from halva_tpu_torch.config import LlavaConfig
from halva_tpu_torch.models import llama
from halva_tpu_torch.ops.generate import _prefill_impl, init_gen_cache_like

Params = Dict[str, Any]


def ngram_draft(
    hist: torch.Tensor,  # (B, T) [prompt ids || out buffer]
    valid: torch.Tensor,  # (B, T) bool, positions holding real tokens
    prev: torch.Tensor,  # (B,) token before cur in the context
    cur: torch.Tensor,  # (B,) current (not yet cached) token
    self_pos: torch.Tensor,  # (B,) index of cur's bigram start, -1 if none
    n_draft: int,
) -> torch.Tensor:
    """(B, n_draft) int32 proposed continuations: the tokens that followed
    the most recent earlier occurrence of the (prev, cur) bigram in `hist`.
    Rows with no match, and continuation slots that hold no real token,
    repeat `cur` (always sound, only ever a question of speed)."""
    t = hist.shape[1]
    dev = hist.device
    pos = torch.arange(t - 1, device=dev)[None, :]
    hit = (
        (hist[:, :-1] == prev[:, None])
        & (hist[:, 1:] == cur[:, None])
        & valid[:, :-1]
        & valid[:, 1:]
        & (pos != self_pos[:, None])  # the query bigram itself
    )
    best = torch.where(hit, pos, -1).amax(dim=1)  # (B,) latest match
    idx = best[:, None] + 2 + torch.arange(n_draft, device=dev)[None, :]
    idx_c = idx.clamp(0, t - 1)
    cont = torch.gather(hist, 1, idx_c)
    cont_ok = torch.gather(valid, 1, idx_c) & (idx <= t - 1)
    return torch.where((best >= 0)[:, None] & cont_ok, cont,
                       cur[:, None]).to(torch.int32)


def _spec_decode_impl(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,  # (B, S) pre-splice ids (draft history)
    prompt_lengths: torch.Tensor,  # (B,)
    first_tok: torch.Tensor,
    spliced_len: torch.Tensor,
    prompt_cache: Params,
    prompt_seg: torch.Tensor,
    max_new_tokens: int,
    eos_id: int,
    draft_k: int,
    attn_impl: str = "auto",
):
    """The verify loop: (tokens (B, max_new), num (B,), verify steps (int),
    emitted (0-d tensor))."""
    b, s = input_ids.shape
    dev = input_ids.device
    kq = draft_k  # tokens verified per step = 1 (cur) + (K - 1) drafts
    out_pad = max_new_tokens + kq
    # init_gen_cache rounds the slots up to a multiple of 128, as the
    # reference does; validity derives from out_count
    gen_cache = init_gen_cache_like(cfg.llm, b, out_pad, prompt_cache)
    input_ids = input_ids.to(torch.int32)
    out = torch.full((b, out_pad), eos_id, dtype=torch.int32, device=dev)
    out_count = torch.zeros((b,), dtype=torch.int32, device=dev)
    cur = first_tok.to(torch.int32)
    done = spliced_len == 0  # dead rows
    steps = 0
    prompt_valid = (torch.arange(s, device=dev)[None, :]
                    < prompt_lengths[:, None]) & (input_ids >= 0)
    iota_out = torch.arange(out_pad, device=dev)[None, :]
    acc_i = torch.arange(kq - 1, device=dev)[None, :]
    last_prompt = torch.gather(
        input_ids, 1, (prompt_lengths - 1).clamp(0, s - 1).long()[:, None])[:, 0]
    eos = torch.full((b,), eos_id, dtype=torch.int32, device=dev)

    while steps < max_new_tokens and not bool(
            (done | (out_count >= max_new_tokens)).all()):
        live = ~done
        tok0 = torch.where(live, cur, eos)
        # emit cur at out_count (done rows: the buffer already holds eos)
        w0 = (iota_out == out_count[:, None]) & live[:, None]
        out = torch.where(w0, tok0[:, None], out)
        done0 = done | (tok0 == eos_id)

        # draft K-1 continuations of [.., prev, cur]
        hist = torch.cat([input_ids, out], dim=1)
        valid = torch.cat([prompt_valid, iota_out <= out_count[:, None]],
                          dim=1)  # out slot out_count now holds cur
        prev_out = torch.gather(
            out, 1, (out_count - 1).clamp(0, out_pad - 1).long()[:, None])[:, 0]
        prev = torch.where(out_count > 0, prev_out, last_prompt)
        self_pos = torch.where(out_count > 0, s + out_count - 1,
                               torch.full_like(out_count, -1))
        draft = ngram_draft(hist, valid, prev, tok0, self_pos, kq - 1)

        # one verify pass over [cur, draft...]
        cand = torch.cat([tok0[:, None], draft], dim=1)  # (B, K)
        embeds = llama.embed(params["llm"], cand)
        logits, gen_cache = llama.verify_step(
            params["llm"], cfg.llm, embeds, spliced_len + out_count,
            prompt_cache, prompt_seg, gen_cache, out_count,
            attn_impl=attn_impl)
        g = logits.argmax(dim=-1).to(torch.int32)  # (B, K)

        # longest accepted prefix
        match = draft == g[:, :-1]  # (B, K-1)
        m = match.to(torch.int32).cumprod(dim=1).sum(dim=1)
        is_eos = (draft == eos_id) & (acc_i < m[:, None])
        has_eos = is_eos.any(dim=1)
        first_eos = is_eos.to(torch.int32).argmax(dim=1)
        m_eff = torch.where(has_eos, first_eos + 1, m)  # keep the eos draft

        # emit accepted drafts at out_count+1 .. out_count+m_eff: one
        # scatter, with what is not kept (and any position past the buffer,
        # for rows beyond their budget) sent to a spare last column
        wpos = out_count[:, None] + 1 + acc_i  # (B, K-1)
        keep = (acc_i < m_eff[:, None]) & live[:, None] & (wpos < out_pad)
        spare = torch.full_like(wpos, out_pad)
        out = F.pad(out, (0, 1)).scatter_(
            1, torch.where(keep, wpos, spare), draft)[:, :out_pad]
        bonus = torch.gather(g, 1, m.long()[:, None])[:, 0]
        cur = torch.where(has_eos | done0, eos, bonus)
        adv = torch.where(live & (tok0 != eos_id), 1 + m_eff,
                          torch.zeros_like(m_eff))
        out_count = out_count + adv.to(torch.int32)
        done = done0 | (has_eos & live)
        steps += 1

    tokens = out[:, :max_new_tokens]
    # num: tokens before the first eos (after a row's eos every later slot
    # holds eos, so this is greedy's count)
    num = (tokens != eos_id).to(torch.int32).cumprod(dim=1).sum(dim=1)
    emitted = out_count.clamp(max=max_new_tokens).sum()
    return tokens, num.to(torch.int32), steps, emitted


def generate_speculative(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,
    images: torch.Tensor,
    prompt_lengths: torch.Tensor,
    max_new_tokens: int,
    eos_id: int,
    draft_k: int = 4,
    attn_impl: str = "auto",
    kv_quant=False,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Prompt-lookup speculative greedy decode: (tokens (B, max_new) int32,
    num_generated (B,), stats) with stats {"verify_steps", "emitted_tokens"};
    emitted / steps is the mean accepted run length (1.0 = no gain).
    draft_k is the verify width: the current token plus draft_k - 1 lookup
    continuations."""
    if draft_k < 2:
        raise ValueError("draft_k must be >= 2 (1 means plain greedy)")
    if (cfg.llm.position_embedding != "rope"
            or cfg.llm.sliding_window is not None):
        raise NotImplementedError(
            "speculative decode: RoPE / no-sliding-window configs only, as "
            "in the reference; use ops.generate.generate_greedy")
    first_tok, _, spliced_len, prompt_cache, prompt_seg = _prefill_impl(
        params, cfg, input_ids, images, prompt_lengths, attn_impl, kv_quant)
    tokens, num, steps, emitted = _spec_decode_impl(
        params, cfg, input_ids, prompt_lengths, first_tok, spliced_len,
        prompt_cache, prompt_seg, max_new_tokens, eos_id, draft_k, attn_impl)
    stats = {"verify_steps": steps, "emitted_tokens": int(emitted)}
    return tokens, num, stats
