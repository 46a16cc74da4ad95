"""Batched beam search over the split KV cache.

Counterpart of halva_tpu/ops/beam.py (HF beam-search semantics:
transformers' vectorized `_beam_search`, do_sample=False,
early_stopping=False), single device:

- B items expand to B*K rows after one shared prefill; candidates are the
  top 2K of the (K*V) frontier; finished hypotheses live in a (B, K) set
  kept sorted by penalized score;
- the prompt KV cache is computed once at batch B and stays at B item rows:
  `llama.decode_step(beam_k=K)` maps beam row r to prompt row r // K, and K5
  reads the item's prompt cache once for its K beams. Only the generated
  cache lives at B*K rows, reordered every step by parent beam (an
  `index_select` of the whole cache along its row axis);
- initial frontier scores are [0, -1e9, ...], so step 1 fans out of beam 0
  only; a candidate finishes when its token is eos or it reaches the token
  budget, and only candidates ranked < K may finish; a finished hypothesis
  includes its final token and scores sum_logprobs / len**length_penalty;
  the next frontier is the candidate top K after finished candidates are
  demoted by -1e9; an item is done when its K finished slots are full and
  the best running score cannot strictly beat the worst finished one.

The reference runs the loop as one `lax.while_loop`; here it runs on the
host, and testing `done.all()` syncs the host once per step.

Ties: scores of -1e9 absorb any log-probability in fp32, so the frontier,
the finished set and the demoted candidates hold many exactly equal values
by design. `jax.lax.top_k` returns the lowest index first among equals and
`torch.topk` promises no order, so every selection here is a stable
descending sort.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from halva_tpu_torch.config import LlavaConfig
from halva_tpu_torch.models import llama
from halva_tpu_torch.ops.generate import _prefill_impl, init_gen_cache_like

Params = Dict[str, Any]

NEG_INF = -1.0e9


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, equal values
    in index order (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, ...) gathered along axis 1 by idx (B, M)."""
    shape = idx.shape + (1,) * (t.dim() - 2)
    return torch.gather(t, 1, idx.reshape(shape).expand(
        idx.shape + t.shape[2:]))


class BeamState(NamedTuple):
    """The search state between two model steps."""
    seqs: torch.Tensor  # (B, K, max_new) int32 running hypotheses
    scores: torch.Tensor  # (B, K) fp32 running sum of log-probs
    fin_tokens: torch.Tensor  # (B, K, max_new) int32 finished hypotheses
    fin_scores: torch.Tensor  # (B, K) fp32 penalized, sorted descending
    fin_lens: torch.Tensor  # (B, K) int32, a trailing eos included
    fin_full: torch.Tensor  # (B, K) bool: the slot holds a hypothesis
    done: torch.Tensor  # (B,) bool


def init_beam_state(b: int, k: int, max_new: int,
                    spliced_len: torch.Tensor) -> BeamState:
    dev = spliced_len.device
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    return BeamState(
        seqs=torch.zeros((b, k, max_new), dtype=torch.int32, device=dev),
        scores=scores,
        fin_tokens=torch.zeros((b, k, max_new), dtype=torch.int32, device=dev),
        fin_scores=torch.full((b, k), NEG_INF, dtype=torch.float32,
                              device=dev),
        fin_lens=torch.zeros((b, k), dtype=torch.int32, device=dev),
        fin_full=torch.zeros((b, k), dtype=torch.bool, device=dev),
        done=spliced_len == 0)  # dead rows never search


def select_step(state: BeamState, logits: torch.Tensor, step: int,
                eos_id: int, length_penalty: float,
                ) -> Tuple[BeamState, torch.Tensor]:
    """The selection of one beam step: from the (B*K, V) logits of the
    running beams to the next state and each new beam's parent beam (B, K).
    No host sync."""
    seqs, scores, fin_tokens, fin_scores, fin_lens, fin_full, done = state
    b, k, max_new = seqs.shape
    dev = seqs.device
    v = logits.shape[-1]
    c = 2 * k
    rank = torch.arange(c, device=dev)[None, :]
    own = torch.arange(k, device=dev)[None, :]

    logp = torch.log_softmax(logits.float(), dim=-1)
    frontier = (scores[:, :, None] + logp.reshape(b, k, v)).reshape(b, k * v)
    cand_scores, cand_idx = top_k_stable(frontier, c)  # (B, 2K)
    cand_parent = cand_idx // v
    cand_tok = (cand_idx % v).to(torch.int32)
    hits = (cand_tok == eos_id) | (step + 1 >= max_new)
    cand_seqs = _gather_rows(seqs, cand_parent)  # (B, 2K, max_new)
    cand_seqs[:, :, step] = cand_tok

    # finished-set merge
    # generated length ** length_penalty, in fp32 as the reference
    pen = float(np.float32(step + 1) ** np.float32(length_penalty))
    pen_scores = cand_scores / pen
    fin_ok = hits & (rank < k) & ~done[:, None]
    merged_scores = torch.cat(
        [fin_scores, torch.where(fin_ok, pen_scores, NEG_INF)], dim=1)
    merged_tokens = torch.cat([fin_tokens, cand_seqs], dim=1)
    merged_lens = torch.cat(
        [fin_lens, torch.full((b, c), step + 1, dtype=torch.int32,
                              device=dev)], dim=1)
    merged_full = torch.cat([fin_full, fin_ok], dim=1)
    fin_scores, top_idx = top_k_stable(merged_scores, k)
    fin_tokens = _gather_rows(merged_tokens, top_idx)
    fin_lens = torch.gather(merged_lens, 1, top_idx)
    fin_full = torch.gather(merged_full, 1, top_idx)

    # next running frontier, finished candidates demoted
    run_scores = cand_scores + hits.float() * NEG_INF
    new_scores, keep = top_k_stable(run_scores, k)
    new_parent = torch.gather(cand_parent, 1, keep)
    new_seqs = _gather_rows(cand_seqs, keep)
    # done items stop evolving (their rows still run the model)
    new_scores = torch.where(done[:, None], scores, new_scores)
    new_seqs = torch.where(done[:, None, None], seqs, new_seqs)
    new_parent = torch.where(done[:, None], own, new_parent)

    best_attainable = new_scores[:, 0] / pen
    worst_fin = torch.where(fin_full.all(dim=1), fin_scores.amin(dim=1),
                            NEG_INF)
    done = done | ~(best_attainable > worst_fin)
    return BeamState(new_seqs, new_scores, fin_tokens, fin_scores, fin_lens,
                     fin_full, done), new_parent


def reorder_gen_cache(gen_cache: Dict[str, torch.Tensor],
                      parent: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The (L, B*K, ...) gen cache with beam row b*K + j taken from the row
    of its parent beam parent[b, j]: an `index_select` of every leaf."""
    b, k = parent.shape
    item0 = torch.arange(b, device=parent.device)[:, None] * k
    rows = (item0 + parent).reshape(-1)
    return {key: t.index_select(1, rows) for key, t in gen_cache.items()}


def generate_beam(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,  # (B, S) right-padded, -200 image sentinel
    images: torch.Tensor,  # (B, 3, H, W)
    prompt_lengths: torch.Tensor,  # (B,) valid token counts (pre-splice)
    max_new_tokens: int,
    eos_id: int,
    num_beams: int,
    length_penalty: float = 1.0,
    attn_impl: str = "auto",
    kv_quant=False,
    mesh=None,
    beam_route: str = "auto",
    stats: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode: (tokens (B, max_new) int32, num_generated (B,)).

    `tokens` holds the best finished hypothesis per item (its eos, when it
    ended with one, included); rows are padded with eos_id past the
    hypothesis. `num_generated` counts content tokens (a trailing eos
    excluded), the contract of `generate_greedy`. Rows with prompt length 0
    are dead rows that return empty hypotheses. `beam_route` picks the
    decode-attention kernel of the beams (K5 "fold", K4 "grid", or "auto":
    ops/decode_attention.auto_beam_route). `stats`,
    when given, receives "steps" (loop iterations) and "best_scores" ((B,)
    penalized score of each returned hypothesis)."""
    if num_beams < 2:
        raise ValueError("generate_beam needs num_beams >= 2; use "
                         "ops.generate.generate_greedy for greedy")
    if mesh is not None:
        raise NotImplementedError(
            "generate_beam: device meshes are not ported yet (ROADMAP queue "
            "1 item 10: meshes and data parallelism)")
    k, max_new = num_beams, max_new_tokens
    _, first_logits, spliced_len, prompt_cache, prompt_seg = _prefill_impl(
        params, cfg, input_ids, images, prompt_lengths, attn_impl, kv_quant)
    b = input_ids.shape[0]
    dev = first_logits.device
    gen_cache = init_gen_cache_like(cfg.llm, b * k, max_new, prompt_cache)

    step = 0
    logits = first_logits.float().repeat_interleave(k, dim=0)  # (B*K, V)
    state = init_beam_state(b, k, max_new, spliced_len)
    pos0 = spliced_len.repeat_interleave(k)

    # the budget's last iteration finishes every running item inside the
    # selection (every candidate hits), so there is no separate finalize pass
    while step < max_new and not bool(state.done.all()):
        state, parent = select_step(state, logits, step, eos_id,
                                    length_penalty)
        # advance the model one step
        gen_cache = reorder_gen_cache(gen_cache, parent)
        flat_tok = state.seqs.reshape(b * k, max_new)[:, step]
        embeds = llama.embed(params["llm"], flat_tok[:, None])
        logits, gen_cache = llama.decode_step(
            params["llm"], cfg.llm, embeds, pos0 + step, prompt_cache,
            prompt_seg, gen_cache, step, attn_impl=attn_impl, beam_k=k,
            beam_route=beam_route)
        step += 1
    fin_tokens, fin_scores, fin_lens = (state.fin_tokens, state.fin_scores,
                                        state.fin_lens)
    if stats is not None:
        stats["steps"] = step
        stats["best_scores"] = fin_scores[:, 0]

    # finished slots are sorted by penalized score: slot 0 wins
    tokens = fin_tokens[:, 0]  # (B, max_new)
    hyp_len = fin_lens[:, 0]  # incl. a trailing eos
    last = torch.gather(tokens, 1, (hyp_len - 1).clamp(min=0).long()[:, None])
    num = hyp_len - ((hyp_len > 0) & (last[:, 0] == eos_id)).to(torch.int32)
    inside = torch.arange(max_new, device=dev)[None, :] < hyp_len[:, None]
    tokens = torch.where(inside, tokens, torch.full_like(tokens, eos_id))
    return tokens, num
