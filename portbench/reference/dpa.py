"""Plain HALVA DPA loss (Data-augmented Phrase Alignment), fp32.

For a batch of B samples, each with a correct (pos) and a hallucinated
(neg) answer and a reference sample:

- a phrase's log-probability is the sum of the log-probabilities of its
  tokens (token t predicted from position t - 1, supervised tokens only);
- alignment: over the rows and the phrase ids present anywhere in the
  batch's pos answers, the mean of log(1 + exp(neg - pos)) (a row without
  a present id has 0 on both sides, log 2);
- divergence: KL(frozen || policy) over the supervised tokens of the
  reference samples, summed, over B;
- total = alignment + alpha * divergence.

Rows are given as per-row tensors over their valid (spliced) positions;
labels are -100 where a token is not supervised.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

IGNORE = -100


def supervised(labels: torch.Tensor) -> torch.Tensor:
    """Positions t whose next token is supervised."""
    return torch.nonzero(labels[1:] != IGNORE).flatten()


def phrase_sums(logits: torch.Tensor, labels: torch.Tensor,
                signs: torch.Tensor, max_phrases: int) -> torch.Tensor:
    """(max_phrases,) summed log-probabilities; logits are those of the
    positions `supervised(labels)` gives, in that order."""
    idx = supervised(labels)
    lp = torch.log_softmax(logits, -1).gather(
        -1, labels[1:][idx].long()[:, None])[:, 0]
    sg = signs[1:][idx]
    ids = torch.arange(1, max_phrases + 1, device=lp.device)
    return ((sg[:, None] == ids[None]).to(lp.dtype) * lp[:, None]).sum(0)


def alignment(pos: Sequence[torch.Tensor], neg: Sequence[torch.Tensor],
              pos_signs: Sequence[torch.Tensor], max_phrases: int
              ) -> torch.Tensor:
    """pos / neg: each row's phrase_sums; pos_signs: each pos row's signs."""
    present = torch.zeros(max_phrases, dtype=torch.bool,
                          device=pos[0].device)
    for sg in pos_signs:
        for k in torch.unique(sg[1:]).tolist():
            if 1 <= k <= max_phrases:
                present[k - 1] = True
    elem = torch.log1p(torch.exp(torch.stack(neg) - torch.stack(pos)))
    num = (elem * present.to(elem.dtype)).sum()
    return num / (len(pos) * max(int(present.sum()), 1))


def divergence(policy: Sequence[torch.Tensor], frozen: Sequence[torch.Tensor]
               ) -> torch.Tensor:
    """KL(frozen || policy) summed over the given positions of every row,
    over the rows; each row's logits at its supervised positions."""
    total = 0.0
    for p, f in zip(policy, frozen):
        r = torch.log_softmax(f.detach(), -1)
        total = total + (r.exp() * (r - torch.log_softmax(p, -1))).sum()
    return total / len(policy)


def loss(align: torch.Tensor, div: torch.Tensor, alpha: float) -> List:
    return [align + alpha * div, align, div]
