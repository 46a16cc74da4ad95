"""DPA trainer: optimizer, schedules and the train step, in PyTorch.

Counterpart of halva_tpu/train/trainer.py with the same names and call
pattern:

    trainable, frozen, optimizer, opt_state = init_train_state(params, tcfg)
    train_step, eval_loss = dpa_step_fns(cfg, tcfg, optimizer)
    trainable, opt_state, metrics = train_step(trainable, frozen, None,
                                               opt_state, batch)

- The param tree is split into (trainable, frozen) trees with None
  placeholders, as in the reference. Trainable leaves are the LoRA factors
  (and the projector under mm_projector_lr); they are marked
  `requires_grad` and updated in place.
- The frozen reference model is the same tensors as the policy's frozen
  tree (`ref_model_tree`): no second copy of the weights.
- The optimizer reproduces the reference's optax chain (clip_by_global_norm
  -> scale_by_adam -> add_decayed_weights -> scale_by_schedule, inside
  optax.MultiSteps, one chain per param group) with torch.optim.AdamW, a
  LambdaLR schedule per group, global-norm clipping per group and a running
  mean of the mini-step grads. torch optimizers own their state, so
  `opt_state` is the optimizer object itself: `train_step` updates it in
  place and hands it back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from halva_tpu_torch import tree
from halva_tpu_torch.config import LlavaConfig
from halva_tpu_torch.models import llama, llava
from halva_tpu_torch.train import dpa
from halva_tpu_torch.train.lora import trainable_mask

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-6
    mm_projector_lr: Optional[float] = None  # None/0 -> projector frozen
    warmup_ratio: float = 0.03
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    lr_schedule: str = "cosine"  # cosine | linear | constant
    optim: str = "adamw"  # adamw | adamw8bit (not ported yet)
    loss_alpha: float = 0.4
    grad_accum_steps: int = 4
    num_train_steps: int = 1000
    max_phrases: int = dpa.MAX_PHRASES
    attn_impl: str = "auto"  # auto (kernels on CUDA tensors) | plain
    remat: bool = True
    # None = full (B, S, V) logits; N = lm_head N positions at a time
    loss_chunk: Optional[int] = None


# --------------------------------------------------------------------------
# trainable/frozen partition (None placeholders)
# --------------------------------------------------------------------------


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def split_params(params: Params, mask: Params) -> Tuple[Params, Params]:
    train = _map2(lambda p, m: p if m else None, params, mask)
    frozen = _map2(lambda p, m: None if m else p, params, mask)
    return train, frozen


def combine_params(train: Params, frozen: Params) -> Params:
    return _map2(lambda a, b: a if a is not None else b, train, frozen)


def ref_model_tree(frozen: Params, overrides: Optional[Params]) -> Params:
    """The frozen reference model from the policy's frozen tree: the None
    placeholders (LoRA factors, tuned components) stripped, `overrides`
    (original copies of trainable components, e.g. the initial projector
    under mm_projector_lr) laid over it. The leaves are the frozen tree's own
    tensors. `lora_scale` stays where it was: `dense` ignores it without
    `lora_a`."""

    def strip(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                sv = strip(v)
                if sv is not None:
                    out[k] = sv
            return out or None
        if isinstance(node, (list, tuple)):
            vals = [strip(v) for v in node]
            if any(v is None for v in vals):
                return None  # partially trainable list: needs an override
            return type(node)(vals)
        return node

    ref = strip(frozen) or {}
    if overrides:
        for k, v in overrides.items():
            ref[k] = v
    for comp in ("llm", "vision", "projector"):
        if comp not in ref:
            raise ValueError(
                f"reference model is missing {comp!r}: component is "
                "trainable, so pass its original copy via ref overrides"
            )
    return ref


def _leaves(t: Params) -> List[Tuple[tuple, torch.Tensor]]:
    return [(p, x) for p, x in tree.flatten(t) if x is not None]


# --------------------------------------------------------------------------
# Optimizer
# --------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: constant init for steps <= 0."""
    if steps <= 0:
        return lambda count: init

    def sched(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return sched


def _cosine(init: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def sched(count):
        count = min(count, decay_steps)
        cos = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * cos + alpha)

    return sched


def _join(first, second, boundary: int):
    """optax.join_schedules of two: the second sees steps past the
    boundary."""
    return lambda step: first(step) if step < boundary else second(
        step - boundary)


def lr_schedule(tcfg: TrainConfig, base_lr: float) -> Callable[[int], float]:
    """The learning rate of the n-th optimizer update (n from 0), value for
    value the reference's optax schedule: warmup and cosine decay (the
    warmup counted inside the decay steps, end value 0), warmup and linear
    decay, or constant."""
    warmup = max(int(tcfg.warmup_ratio * tcfg.num_train_steps), 1)
    total = max(tcfg.num_train_steps, warmup + 1)
    if tcfg.lr_schedule == "cosine":
        return _join(_linear(0.0, base_lr, warmup),
                     _cosine(base_lr, total - warmup, 0.0), warmup)
    if tcfg.lr_schedule == "linear":
        return _join(_linear(0.0, base_lr, warmup),
                     _linear(base_lr, 0.0, tcfg.num_train_steps - warmup),
                     warmup)
    return lambda step: base_lr


class DPAOptimizer:
    """AdamW over the trainable leaves with the reference's optax semantics.

    - One param group per optax chain: "base" (LoRA) at learning_rate and,
      under mm_projector_lr, "projector" at its own rate, each with its own
      schedule and its own global-norm clipping.
    - Each group's lr is 1.0 times its LambdaLR factor, the schedule itself,
      and the scheduler steps after each update, so the n-th update uses
      lr(n): the first uses lr(0) = 0 (optax's scale_by_schedule reads the
      count before incrementing it).
    - Gradient accumulation as optax.MultiSteps: the running mean
      acc += (g - acc) / (n + 1) over grad_accum_steps mini-steps, then one
      update; the schedule and Adam's count advance on updates only.
    - Clipping as optax.clip_by_global_norm: grads are divided by the exact
      norm and times max_norm when the norm is not below it
      (torch.nn.utils.clip_grad_norm_ would add 1e-6 to the norm).
    - Accumulators and Adam moments take the params' dtype, as optax's do.
    """

    def __init__(self, tcfg: TrainConfig, trainable: Params):
        if tcfg.optim == "adamw8bit":
            raise NotImplementedError(
                "optim='adamw8bit' is not ported yet (ROADMAP queue 1 item "
                "8b, train/optim8bit.py)")
        if tcfg.optim != "adamw":
            raise ValueError(f"unknown optim {tcfg.optim!r}")
        self.tcfg = tcfg
        flat = _leaves(trainable)
        leaves = [x for _, x in flat]
        # indices into the trainable-leaf order, by group
        groups: Dict[str, List[int]] = {"base": [], "projector": []}
        for i, (path, _) in enumerate(flat):
            proj = bool(tcfg.mm_projector_lr) and "projector" in path
            groups["projector" if proj else "base"].append(i)
        rates = {"base": tcfg.learning_rate,
                 "projector": tcfg.mm_projector_lr}
        names = [n for n in ("base", "projector") if groups[n]]
        self.leaves = leaves
        self.groups = [groups[n] for n in names]
        self.adamw = torch.optim.AdamW(
            [{"params": [leaves[i] for i in groups[n]], "lr": 1.0}
             for n in names],
            betas=(tcfg.adam_b1, tcfg.adam_b2), eps=tcfg.adam_eps,
            weight_decay=tcfg.weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, [lr_schedule(tcfg, rates[n]) for n in names])
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    @property
    def updates(self) -> int:
        """Optimizer updates applied so far."""
        return self.scheduler.last_epoch

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> bool:
        """Feed one mini-step's grads (in trainable-leaf order); returns
        whether an update was applied."""
        k = self.tcfg.grad_accum_steps
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.leaves]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g.to(a.dtype) - a) / (n + 1))
            self.mini_step = (n + 1) % k
            if self.mini_step:
                return False
            grads = self.acc
        for group in self.groups:
            gs = [grads[i].to(self.leaves[i].dtype) for i in group]
            norm = global_norm(gs)
            if not norm < self.tcfg.max_grad_norm:
                gs = [g / norm.to(g.dtype) * self.tcfg.max_grad_norm
                      for g in gs]
            for i, g in zip(group, gs):
                self.leaves[i].grad = g
        self.adamw.step()
        self.scheduler.step()
        for p in self.leaves:
            p.grad = None
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        return True


def make_optimizer(tcfg: TrainConfig, trainable: Params) -> DPAOptimizer:
    return DPAOptimizer(tcfg, trainable)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every grad, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


# --------------------------------------------------------------------------
# Train step
# --------------------------------------------------------------------------


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    alignment: torch.Tensor
    divergence: torch.Tensor
    grad_norm: torch.Tensor


def dpa_step_fns(cfg: LlavaConfig, tcfg: TrainConfig,
                 optimizer: DPAOptimizer, mesh=None):
    """(train_step, eval_loss).

    train_step(trainable, frozen, ref_params, opt_state, batch)
      -> (trainable, opt_state, TrainMetrics), trainable and opt_state
      updated in place; `train_step.loss_and_grads(trainable, frozen,
      ref_params, batch)` -> (loss, DPALossParts, grads tree) is the
      quantity it differentiates. ref_params: None (the reference model is
      the frozen tree), a dict of overrides, or a full tree.

    A micro-step: the pos+neg forward (2B rows, with grad), the policy
    forward on the reference batch (B rows, with grad), the frozen
    reference forward (B rows, no grad), the DPA loss (chunked when
    tcfg.loss_chunk is set), the backward into the trainable leaves, then
    the optimizer (which applies an update every grad_accum_steps calls).
    """
    if mesh is not None:
        raise NotImplementedError(
            "dpa_step_fns(mesh=...) is not ported yet (ROADMAP queue 1 item "
            "10, multi-GPU)")
    chunked = tcfg.loss_chunk is not None

    def forwards(params: Params, batch: Batch):
        # one 2B-row forward for pos+neg (reference concatenated_forward)
        def cat(a, b):
            return torch.cat([batch[a], batch[b]], dim=0)

        out, sp = llava.forward(
            params, cfg, cat("input_ids", "neg_input_ids"),
            cat("images", "images"),
            segment_ids=cat("segment_ids", "neg_segment_ids"),
            labels=cat("labels", "neg_labels"),
            signs=cat("pos_signs", "neg_signs"),
            attn_impl=tcfg.attn_impl, remat=tcfg.remat,
            return_hidden=chunked,
        )
        b = batch["input_ids"].shape[0]
        return (out[:b], out[b:], sp.labels[:b], sp.labels[b:],
                sp.signs[:b], sp.signs[b:])

    def ref_forward(params: Params, batch: Batch):
        out, sp = llava.forward(
            params, cfg, batch["ref_input_ids"], batch["ref_images"],
            segment_ids=batch["ref_segment_ids"], labels=batch["ref_labels"],
            attn_impl=tcfg.attn_impl, remat=tcfg.remat,
            return_hidden=chunked,
        )
        return out, sp.labels

    def loss_fn(trainable, frozen, frozen_ref_out, ref_labels_spliced,
                batch) -> dpa.DPALossParts:
        params = combine_params(trainable, frozen)
        pos_out, neg_out, pos_lab, neg_lab, pos_sg, neg_sg = forwards(
            params, batch)
        policy_ref_out, _ = ref_forward(params, batch)
        if chunked:
            llm = params["llm"]

            def logits_fn(h):
                return llama.lm_logits(llm, cfg.llm, h)

            return dpa.dpa_loss_from_hidden(
                logits_fn, pos_out, neg_out, pos_lab, neg_lab, pos_sg,
                neg_sg, policy_ref_out, frozen_ref_out, ref_labels_spliced,
                alpha=tcfg.loss_alpha, max_phrases=tcfg.max_phrases,
                chunk=tcfg.loss_chunk)
        return dpa.dpa_loss(
            pos_out, neg_out, pos_lab, neg_lab, pos_sg, neg_sg,
            policy_ref_out, frozen_ref_out, ref_labels_spliced,
            alpha=tcfg.loss_alpha, max_phrases=tcfg.max_phrases)

    def frozen_ref(frozen, ref_params, batch):
        with torch.no_grad():
            return ref_forward(ref_model_tree(frozen, ref_params), batch)

    def loss_and_grads(trainable, frozen, ref_params, batch):
        frozen_ref_out, ref_labels_spliced = frozen_ref(frozen, ref_params,
                                                        batch)
        with torch.enable_grad():
            parts = loss_fn(trainable, frozen, frozen_ref_out,
                            ref_labels_spliced, batch)
            leaves = [x for _, x in _leaves(trainable)]
            # a leaf the loss does not reach gets a zero grad, as in the
            # reference: MPT's MLP is not gated, and the tree still carries
            # a `gate` stack whose LoRA factors are trainable leaves
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves, torch.autograd.grad(
                         parts.total, leaves, allow_unused=True))]
        it = iter(grads)  # map_tree visits the leaves in flatten's order
        grad_tree = tree.map_tree(lambda t: None if t is None else next(it),
                                  trainable)
        detached = dpa.DPALossParts(*(t.detach() for t in parts))
        return detached.total, detached, grad_tree

    def train_step(trainable, frozen, ref_params, opt_state, batch):
        loss, parts, grads = loss_and_grads(trainable, frozen, ref_params,
                                            batch)
        flat = [g for _, g in _leaves(grads)]
        gnorm = global_norm(flat)
        opt_state.step(flat)
        return trainable, opt_state, TrainMetrics(
            loss, parts.alignment, parts.divergence, gnorm)

    @torch.no_grad()
    def eval_loss(trainable, frozen, ref_params, batch):
        frozen_ref_out, ref_labels_spliced = frozen_ref(frozen, ref_params,
                                                        batch)
        parts = loss_fn(trainable, frozen, frozen_ref_out,
                        ref_labels_spliced, batch)
        return TrainMetrics(parts.total, parts.alignment, parts.divergence,
                            torch.zeros((), device=parts.total.device))

    train_step.loss_and_grads = loss_and_grads
    return train_step, eval_loss


def packed_dpa_step_fns(*args, **kwargs):
    raise NotImplementedError(
        "packed_dpa_step_fns is not ported yet (ROADMAP queue 1 item 8b, "
        "packed DPA)")


def init_train_state(params: Params, tcfg: TrainConfig,
                     extra_trainable: Tuple[str, ...] = ()):
    """Split params, mark the trainable leaves `requires_grad`, build the
    optimizer. Returns (trainable, frozen, optimizer, opt_state); opt_state
    is the optimizer (see the module docstring)."""
    if tcfg.mm_projector_lr:
        extra_trainable = extra_trainable + (r"^projector/",)
    mask = trainable_mask(params, extra_trainable=extra_trainable)
    trainable, frozen = split_params(params, mask)
    for _, leaf in _leaves(trainable):
        leaf.requires_grad_(True)
    optimizer = make_optimizer(tcfg, trainable)
    return trainable, frozen, optimizer, optimizer
