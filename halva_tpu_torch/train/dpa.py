"""Data-augmented Phrase Alignment (DPA) loss, the HALVA objective.

Counterpart of halva_tpu/train/dpa.py (the row-per-sample losses; the packed
variants come with packed DPA, ROADMAP queue 1 item 8b):
- per-token logps: log_softmax gathered at the label ids, shifted;
- phrase accumulation: sum of token logps per phrase-sign id over a static
  MAX_PHRASES axis;
- alignment: mean over (batch x present phrase) of
  log(1 + exp(neg_phrase_logp - pos_phrase_logp));
- KL(ref || policy) over supervised ref tokens, fp32 softmax, / batch;
  total = alignment + alpha * KL.

The chunked variants take final hidden states and apply lm_head `chunk`
positions at a time, each chunk a non-reentrant `torch.utils.checkpoint`
region (the reference's `jax.checkpoint` scan body): no (B, S, V) fp32
tensor lives whole, forward or backward. A ragged last chunk needs no
padding here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from halva_tpu_torch.constants import IGNORE_INDEX

MAX_PHRASES = 16  # static upper bound on <MASK> spans per answer

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def _gather_logps(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    safe = torch.where(labels == IGNORE_INDEX, torch.zeros_like(labels),
                       labels).long()
    lsm = F.log_softmax(logits, dim=-1)
    return torch.gather(lsm, -1, safe[..., None])[..., 0]


def per_token_logps(logits: torch.Tensor,  # (B, S, V) fp32
                    labels: torch.Tensor) -> torch.Tensor:  # (B, S)
    """Shifted per-token log-probabilities (B, S-1); IGNORE_INDEX positions
    still give a (meaningless) value: mask downstream."""
    return _gather_logps(logits[:, :-1], labels[:, 1:])


def accumulate_phrase_logps(logps: torch.Tensor,  # (B, S-1) masked
                            signs: torch.Tensor,  # (B, S-1) 0 = none
                            max_phrases: int = MAX_PHRASES) -> torch.Tensor:
    """(B, max_phrases): column k-1 = sum of logps where signs == k."""
    ids = torch.arange(1, max_phrases + 1, dtype=signs.dtype,
                       device=signs.device)
    onehot = (signs[:, :, None] == ids[None, None, :]).to(logps.dtype)
    return torch.einsum("bs,bsk->bk", logps, onehot)


def alignment_loss(
    pos_logps: torch.Tensor,  # (B, S-1)
    neg_logps: torch.Tensor,
    pos_labels: torch.Tensor,  # (B, S-1) shifted labels
    neg_labels: torch.Tensor,
    pos_signs: torch.Tensor,  # (B, S-1) shifted signs
    neg_signs: torch.Tensor,
    max_phrases: int = MAX_PHRASES,
) -> torch.Tensor:
    """Phrase-level contrastive loss (scalar, fp32). The present-phrase set
    comes from `pos_signs` only, as in the reference (HALVA pairs carry the
    same phrase ids on both sides); rows lacking a present id add log(2)."""
    pos_mask = (pos_labels != IGNORE_INDEX).float()
    neg_mask = (neg_labels != IGNORE_INDEX).float()
    pos_signs = pos_signs.clamp_min(0)
    pos = accumulate_phrase_logps(pos_logps * pos_mask, pos_signs,
                                  max_phrases)
    neg = accumulate_phrase_logps(neg_logps * neg_mask,
                                  neg_signs.clamp_min(0), max_phrases)
    ids = torch.arange(1, max_phrases + 1, dtype=pos_signs.dtype,
                       device=pos_signs.device)
    present = (pos_signs[:, :, None] == ids[None, None, :]).any(dim=1).any(
        dim=0)  # (K,)
    elem = torch.log1p(torch.exp(neg - pos))  # (B, K)
    num = (elem * present[None, :].to(elem.dtype)).sum()
    denom = pos.shape[0] * present.float().sum().clamp_min(1.0)
    return num / denom


def kl_divergence(policy_logits: torch.Tensor,  # (B, S, V) fp32
                  ref_logits: torch.Tensor,  # (B, S, V) frozen model
                  ref_labels: torch.Tensor) -> torch.Tensor:  # (B, S)
    """KL(ref || policy) over the supervised (shifted) ref tokens, summed,
    divided by the batch size. No gradient flows into `ref_logits`."""
    mask = (ref_labels[:, 1:] != IGNORE_INDEX).float()
    r_logp = F.log_softmax(ref_logits[:, :-1].detach().float(), dim=-1)
    p_logp = F.log_softmax(policy_logits[:, :-1].float(), dim=-1)
    div = (r_logp.exp() * (r_logp - p_logp)).sum(-1)  # (B, S-1)
    return (div * mask).sum() / policy_logits.shape[0]


class DPALossParts(NamedTuple):
    total: torch.Tensor
    alignment: torch.Tensor
    divergence: torch.Tensor


def _run_chunk(fn, *args):
    """A checkpointed chunk when autograd records, else a plain call."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def per_token_logps_chunked(
    logits_fn: LogitsFn,  # hidden chunk (B, c, D) -> fp32 logits (B, c, V)
    hidden: torch.Tensor,  # (B, S, D)
    labels: torch.Tensor,  # (B, S)
    chunk: int = 256,
) -> torch.Tensor:
    """per_token_logps(logits_fn(hidden), labels), (B, S-1), without the
    (B, S, V) logits."""
    hid, lab = hidden[:, :-1], labels[:, 1:]

    def body(hc, lc):
        return _gather_logps(logits_fn(hc), lc)

    return torch.cat([
        _run_chunk(body, hid[:, c0:c0 + chunk], lab[:, c0:c0 + chunk])
        for c0 in range(0, hid.shape[1], chunk)
    ], dim=1)


def kl_divergence_chunked(
    logits_fn: LogitsFn,
    policy_hidden: torch.Tensor,  # (B, S, D)
    ref_hidden: torch.Tensor,  # (B, S, D) frozen model (no gradient)
    ref_labels: torch.Tensor,  # (B, S)
    chunk: int = 256,
) -> torch.Tensor:
    """kl_divergence on the logits of both hidden states, chunked; lm_head
    is shared by the policy and the frozen model (LoRA never touches it)."""
    p_hid = policy_hidden[:, :-1]
    r_hid = ref_hidden[:, :-1].detach()
    lab = ref_labels[:, 1:]

    def body(pc, rc, lc):
        mask = (lc != IGNORE_INDEX).float()
        p_logp = F.log_softmax(logits_fn(pc), dim=-1)
        r_logp = F.log_softmax(logits_fn(rc), dim=-1).detach()
        div = (r_logp.exp() * (r_logp - p_logp)).sum(-1)
        return (div * mask).sum()

    total = sum(
        _run_chunk(body, p_hid[:, c0:c0 + chunk], r_hid[:, c0:c0 + chunk],
                   lab[:, c0:c0 + chunk])
        for c0 in range(0, p_hid.shape[1], chunk)
    )
    return total / policy_hidden.shape[0]


def dpa_loss_from_hidden(
    logits_fn: LogitsFn,
    pos_hidden: torch.Tensor,
    neg_hidden: torch.Tensor,
    pos_labels: torch.Tensor,
    neg_labels: torch.Tensor,
    pos_signs: torch.Tensor,
    neg_signs: torch.Tensor,
    policy_ref_hidden: torch.Tensor,
    frozen_ref_hidden: torch.Tensor,
    ref_labels: torch.Tensor,
    alpha: float,
    max_phrases: int = MAX_PHRASES,
    chunk: int = 256,
) -> DPALossParts:
    """dpa_loss from final hidden states, logits chunked over the sequence."""
    pos_lp = per_token_logps_chunked(logits_fn, pos_hidden, pos_labels, chunk)
    neg_lp = per_token_logps_chunked(logits_fn, neg_hidden, neg_labels, chunk)
    align = alignment_loss(pos_lp, neg_lp, pos_labels[:, 1:],
                           neg_labels[:, 1:], pos_signs[:, 1:],
                           neg_signs[:, 1:], max_phrases)
    div = kl_divergence_chunked(logits_fn, policy_ref_hidden,
                                frozen_ref_hidden, ref_labels, chunk)
    return DPALossParts(align + alpha * div, align, div)


def dpa_loss(
    pos_logits: torch.Tensor,  # (B, S, V) policy on positive rows
    neg_logits: torch.Tensor,  # (B, S, V) policy on negative rows
    pos_labels: torch.Tensor,  # (B, S) spliced labels
    neg_labels: torch.Tensor,
    pos_signs: torch.Tensor,  # (B, S) spliced signs
    neg_signs: torch.Tensor,
    policy_ref_logits: torch.Tensor,  # (B, Sr, V) policy on the ref batch
    frozen_ref_logits: torch.Tensor,  # (B, Sr, V) frozen model on it
    ref_labels: torch.Tensor,  # (B, Sr)
    alpha: float,
    max_phrases: int = MAX_PHRASES,
) -> DPALossParts:
    pos_lp = per_token_logps(pos_logits, pos_labels)
    neg_lp = per_token_logps(neg_logits, neg_labels)
    align = alignment_loss(pos_lp, neg_lp, pos_labels[:, 1:],
                           neg_labels[:, 1:], pos_signs[:, 1:],
                           neg_signs[:, 1:], max_phrases)
    div = kl_divergence(policy_ref_logits, frozen_ref_logits, ref_labels)
    return DPALossParts(align + alpha * div, align, div)
