"""Traffic kind `dpa_train`: HALVA's DPA LoRA fine-tune, one closed loop.

The window drives the program's train step (`train/trainer.dpa_step_fns`
with `DPAOptimizer`, the train CLI's step) on micro-batches in
`train/data.collate`'s layout, one after another, each ended by reading
its loss on the host, as the train loop logs it.

Every row sits at the recipe's row bound: `row_tokens` spliced tokens
(HALVA's --model_max_length, which LLaVA applies to the spliced sequence).
Each sample (cell parameters under "traffic"):
- a prompt of `prompt_tokens` text tokens (BOS first, the image sentinel
  at `image_at`), one image, and a correct answer that fills the row to
  `row_tokens`, ending in EOS;
- a hallucinated answer: the same tokens with `phrases` phrases of
  `phrase_tokens` tokens each replaced by as many others; phrase k's
  tokens carry sign k on both sides;
- a reference sample with its own image, prompt and answer, at the same
  bound.
The row length alone sets the work of a micro-step: the prompt's length
and the phrases move only which tokens the loss reads.

Every size (prompt lengths, phrase counts and places) comes from
`design_seed`, the same for every run, and the contents (token ids,
pixels) from the run's seed: every seed gives the same work. The feed holds
`batches` micro-batches and cycles.

Set-up makes the weights and the adapter from the seed, builds the train
state once, resumes its optimizer part-way through training (`resume`),
and drives it through its first `checked_steps` micro-steps, which also
warm it up; the window continues with the same objects. The resumed
optimizer ends its accumulation cycle at micro-step `update_at` (from 0),
which applies an AdamW update at the schedule's update `resume_updates`,
past warm-up. After the window the plain reference (reference/llava.py,
reference/dpa.py, reference/optim.py) follows those first micro-steps from
the benchmark's own inputs: each micro-step's loss, the first micro-step's
LoRA gradient as the optimizer holds it (its accumulator), and each LoRA
leaf's change over the micro-steps, which holds the update.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, harness, trace as trace_lib, weights

IGNORE = -100
SENTINEL = -200
BOS = 1
PAD = 64  # train/data.collate's pad_multiple, which the train loop keeps
# CLIP's pixel normalisation (openai/clip-vit-large-patch14-336)
MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def pixels(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    img = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    x = (img.astype(np.float32) / 255.0 - MEAN) / STD
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def design(p: dict, image_tokens: int) -> List[dict]:
    """The sizes of every sample, from the design seed alone: each row
    spliced to `row_tokens`."""
    rng = np.random.default_rng(p["design_seed"])
    n = p["batches"] * p["batch"]
    text = p["row_tokens"] - image_tokens + 1  # ids, the sentinel one of them
    lo, hi = p["prompt_tokens"]
    prompt = rng.integers(lo, hi + 1, n)
    ref_prompt = rng.integers(lo, hi + 1, n)
    out = []
    for i in range(n):
        resp = text - int(prompt[i]) - 1  # EOS last
        k = int(rng.integers(p["phrases"][0], p["phrases"][1] + 1))
        lens = rng.integers(p["phrase_tokens"][0], p["phrase_tokens"][1] + 1,
                            k)
        # phrases sit in order, apart, inside the answer
        gaps = np.sort(rng.choice(resp - int(lens.sum()), k, replace=False))
        starts = [int(g) + int(lens[:j].sum()) for j, g in enumerate(gaps)]
        out.append({"prompt": int(prompt[i]), "resp": resp,
                    "starts": starts, "lens": [int(x) for x in lens],
                    "ref_prompt": int(ref_prompt[i]),
                    "ref_resp": text - int(ref_prompt[i]) - 1})
    return out


def _prompt(rng, n: int, image_at: int, vocab: int) -> np.ndarray:
    ids = rng.integers(3, vocab, n).astype(np.int64)
    ids[0] = BOS
    ids[image_at] = SENTINEL
    return ids


def samples(p: dict, model: dict, eos: int, seed: int) -> List[dict]:
    """Every sample of the feed, in `train/data.HallDataset`'s fields."""
    vocab = model["llm"]["vocab_size"]
    size = model["vision"]["image_size"]
    plan = design(p, harness.image_tokens(model))
    rng = np.random.default_rng(seed)
    images = pixels(rng, 2 * len(plan), size)
    out = []
    for i, d in enumerate(plan):
        prompt = _prompt(rng, d["prompt"], p["image_at"], vocab)
        answer = rng.integers(3, vocab, d["resp"]).astype(np.int64)
        pos_sign = np.zeros(d["resp"], np.int64)
        neg_parts, neg_sign, cur = [], [], 0
        for k, (s, n) in enumerate(zip(d["starts"], d["lens"]), start=1):
            pos_sign[s:s + n] = k
            neg_parts.append(answer[cur:s])
            neg_sign.append(np.zeros(s - cur, np.int64))
            neg_parts.append(rng.integers(3, vocab, n).astype(np.int64))
            neg_sign.append(np.full(n, k, np.int64))
            cur = s + n
        neg_parts.append(answer[cur:])
        neg_sign.append(np.zeros(d["resp"] - cur, np.int64))
        neg_answer = np.concatenate(neg_parts)
        neg_signs = np.concatenate(neg_sign)

        def row(ans, signs):
            ids = np.concatenate([prompt, ans, [eos]])
            labels = np.concatenate([np.full(len(prompt), IGNORE), ans,
                                     [eos]])
            sg = np.concatenate([np.zeros(len(prompt), np.int64), signs,
                                 [0]])
            return ids.astype(np.int32), labels.astype(np.int32), \
                sg.astype(np.int32)

        ids, labels, signs = row(answer, pos_sign)
        nids, nlabels, nsigns = row(neg_answer, neg_signs)
        rprompt = _prompt(rng, d["ref_prompt"], p["image_at"], vocab)
        ranswer = rng.integers(3, vocab, d["ref_resp"]).astype(np.int64)
        rids = np.concatenate([rprompt, ranswer, [eos]]).astype(np.int32)
        rlabels = np.concatenate([np.full(len(rprompt), IGNORE), ranswer,
                                  [eos]]).astype(np.int32)
        out.append({"input_ids": ids, "labels": labels, "pos_signs": signs,
                    "neg_input_ids": nids, "neg_labels": nlabels,
                    "neg_signs": nsigns, "image": images[2 * i],
                    "ref_input_ids": rids, "ref_labels": rlabels,
                    "ref_image": images[2 * i + 1]})
    return out


def batches(p: dict, all_samples: List[dict]) -> List[List[dict]]:
    """Micro-batches of `batch` samples."""
    b = p["batch"]
    return [all_samples[i:i + b] for i in range(0, len(all_samples), b)]


def spliced_len(ids: np.ndarray, image_tokens: int) -> int:
    return len(ids) + (image_tokens - 1) * int((ids == SENTINEL).any())


def batch_shapes(group: List[dict], image_tokens: int, pad: int):
    """(pos/neg live lengths, their padded spliced length, reference live
    lengths, their padded spliced length) as collate and the splice lay
    the batch out."""
    def bucket(n):
        return -(-n // pad) * pad

    pn_text = max(max(len(s["input_ids"]), len(s["neg_input_ids"]))
                  for s in group)
    ref_text = max(len(s["ref_input_ids"]) for s in group)
    pn = [spliced_len(s[k], image_tokens) for k in ("input_ids",
                                                    "neg_input_ids")
          for s in group]
    ref = [spliced_len(s["ref_input_ids"], image_tokens) for s in group]
    return (pn, bucket(pn_text) + image_tokens - 1, ref,
            bucket(ref_text) + image_tokens - 1)


def shapes(group: List[dict], image_tokens: int) -> Dict[str, object]:
    """What a micro-step's work follows: the live spliced lengths of the
    pos/neg rows and of the reference rows, and their padded widths."""
    pn, pn_pad, ref, ref_pad = batch_shapes(group, image_tokens, PAD)
    return {"pn": pn, "pn_pad": pn_pad, "ref": ref, "ref_pad": ref_pad}


def leaf_name(path) -> str:
    return "/".join(str(k) for k in path)


# --------------------------------------------------------------------------
# the reference's side
# --------------------------------------------------------------------------


def _expand(ids: np.ndarray, values: np.ndarray, fill: int,
            image_tokens: int) -> np.ndarray:
    at = np.flatnonzero(ids == SENTINEL)
    if not at.size:
        return values
    i = int(at[0])
    return np.concatenate([values[:i], np.full(image_tokens, fill,
                                               values.dtype), values[i + 1:]])


def reference_steps(ref, group_list: List[List[dict]], device, job: dict,
                    image_tokens: int, dtype: torch.dtype):
    """The reference's micro-steps over `group_list`, from the optimizer's
    resumed state (`job`): [(total, alignment, divergence) per micro-step],
    the first micro-step's LoRA gradients {leaf name: norm}, and each LoRA
    leaf's change over the micro-steps {leaf name: norm}. Micro-step
    `update_at` ends the accumulation cycle and applies AdamW; the
    gradients of the cycle's micro-steps are taken in full, the later
    micro-steps run without them."""
    from portbench.reference import dpa, optim

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    names = list(ref.lora)
    keys = [n + "/" + part for n in names for part in ("lora_a", "lora_b")]
    start = [x.clone() for n in names for x in ref.lora[n][:2]]
    n_acc = job["grad_accum_steps"] - 1 - job["update_at"]
    acc = [torch.zeros_like(x) for x in start]
    losses = []
    grad_norms: Dict[str, float] = {}
    for step, group in enumerate(group_list):
        imgs = t(np.stack([s["image"] for s in group]))
        rimgs = t(np.stack([s["ref_image"] for s in group]))
        fpos, fref = ref.features(imgs), ref.features(rimgs)
        rows, labels, signs = [], [], []
        for key, lab, sg, feats in (("input_ids", "labels", "pos_signs", fpos),
                                    ("neg_input_ids", "neg_labels",
                                     "neg_signs", fpos),
                                    ("ref_input_ids", "ref_labels", None,
                                     fref)):
            for i, s in enumerate(group):
                rows.append(ref.embed_row(s[key], feats[i]))
                labels.append(t(_expand(s[key], s[lab], IGNORE,
                                        image_tokens)))
                signs.append(None if sg is None else t(_expand(
                    s[key], s[sg], 0, image_tokens)))
        b = len(group)
        ref_rows, ref_labels = rows[2 * b:], labels[2 * b:]
        with torch.no_grad():
            frozen = [ref.logits(h[dpa.supervised(lab)]) for h, lab in zip(
                ref.hidden(ref_rows, lora=False), ref_labels)]
        with_grad = step <= job["update_at"]
        if with_grad:
            leaves = {n: (a.clone().requires_grad_(), bb.clone()
                          .requires_grad_(), s) for n, (a, bb, s)
                      in ref.lora.items()}
            hs = ref.hidden_grad(rows, leaves)
        else:
            hs = ref.hidden(rows, lora=True)
        with torch.set_grad_enabled(with_grad):
            sums = [dpa.phrase_sums(ref.logits(h[dpa.supervised(lab)]), lab,
                                    sg, job["max_phrases"])
                    for h, lab, sg in zip(hs[:2 * b], labels[:2 * b],
                                          signs[:2 * b])]
            align = dpa.alignment(sums[:b], sums[b:], signs[:b],
                                  job["max_phrases"])
            policy = [ref.logits(h[dpa.supervised(lab)])
                      for h, lab in zip(hs[2 * b:], ref_labels)]
            div = dpa.divergence(policy, frozen)
            total = align + job["loss_alpha"] * div
        losses.append((float(total.detach()), float(align.detach()),
                       float(div.detach())))
        del hs, rows, frozen
        if not with_grad:
            continue
        flat = [x for n in names for x in leaves[n][:2]]
        grads = [torch.zeros_like(x) if g is None else g.detach()
                 for x, g in zip(flat, torch.autograd.grad(
                     total, flat, allow_unused=True))]  # MPT has no gate
        del leaves, flat, total, align, div, sums, policy
        if step == 0:
            grad_norms = {k: float(g.norm()) for k, g in zip(keys, grads)}
        acc = optim.accumulate(acc, grads, n_acc)
        n_acc += 1
        del grads
        if n_acc == job["grad_accum_steps"]:
            lr = optim.learning_rate(job, job["resume_updates"])
            params = [x for n in names for x in ref.lora[n][:2]]
            new = optim.adamw(params, optim.clip(acc, job["max_grad_norm"]),
                              {}, lr, job, dtype)
            ref.lora = {n: (new[2 * i], new[2 * i + 1], ref.lora[n][2])
                        for i, n in enumerate(names)}
            del acc, params, new
    change = {k: float((x - x0).norm()) for k, x, x0 in zip(
        keys, [x for n in names for x in ref.lora[n][:2]], start)}
    return losses, grad_norms, change


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves) -> float:
    """The worst leaf's gap between the program's and the reference's norm,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def compare(prog_losses, ref_losses, prog_grads: Dict[str, float],
            ref_grads: Dict[str, float], prog_change: Dict[str, float],
            ref_change: Dict[str, float]) -> Dict[str, float]:
    """The numbers a training cell compares:
    - loss: the largest relative gap of a checked micro-step's loss;
    - divergence: the largest relative gap of its KL term;
    - grad: worst_leaf of the first micro-step's gradient norms;
    - update: worst_leaf of the norms of each leaf's change over the
      checked micro-steps (the update they hold).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of both (nought to rounding)."""
    med = statistics.median(ref_grads.values())
    leaves = [k for k, v in ref_grads.items() if v >= 1e-3 * med]
    loss = max(abs(p[0] - r[0]) / abs(r[0])
               for p, r in zip(prog_losses, ref_losses))
    div = max(abs(p[2] - r[2]) / abs(r[2])
              for p, r in zip(prog_losses, ref_losses))
    if not all(math.isfinite(x) for p in prog_losses for x in p):
        loss = div = float("inf")
    return {"loss": loss, "divergence": div,
            "grad": worst_leaf(prog_grads, ref_grads, leaves),
            "update": worst_leaf(prog_change, ref_change, leaves)}


def short(name: str) -> str:
    """llm/layers/attn/wq/lora_a -> wq/lora_a"""
    parts = name.split("/")
    return "/".join(parts[-2:])


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------


def build(ctx, tree, cfg):
    """The program's train state and step over `tree` (its LoRA leaves
    become the trainable ones)."""
    from halva_tpu_torch.train.trainer import (TrainConfig, dpa_step_fns,
                                                init_train_state)

    job = ctx.cell["job"]
    tcfg = TrainConfig(
        learning_rate=job["learning_rate"], warmup_ratio=job["warmup_ratio"],
        weight_decay=job["weight_decay"], adam_b1=job["adam_b1"],
        adam_b2=job["adam_b2"], adam_eps=job["adam_eps"],
        max_grad_norm=job["max_grad_norm"], lr_schedule="cosine",
        loss_alpha=job["loss_alpha"], max_phrases=job["max_phrases"],
        grad_accum_steps=job["grad_accum_steps"],
        num_train_steps=job["num_train_steps"], remat=job["remat"],
        loss_chunk=job["loss_chunk"])
    trainable, frozen, opt, opt_state = init_train_state(tree, tcfg)
    step, _ = dpa_step_fns(cfg, tcfg, opt)
    resume(opt, job)
    return trainable, frozen, opt, step


def resume(opt, job: dict) -> None:
    """The optimizer part-way through training, as the adapter is, the way
    the program's checkpoint restore sets it: `resume_updates` updates
    done, and the accumulation cycle `update_at` micro-steps before its
    last, with nothing accumulated yet. Adam's moments start at zero."""
    if job["grad_accum_steps"] < 2:
        raise ValueError("dpa_train checks a step with gradient "
                         "accumulation (grad_accum_steps > 1)")
    opt.mini_step = job["grad_accum_steps"] - 1 - job["update_at"]
    sched = opt.scheduler
    sched.last_epoch = job["resume_updates"]
    lrs = [base * fn(sched.last_epoch)
           for fn, base in zip(sched.lr_lambdas, sched.base_lrs)]
    for group, lr in zip(opt.adamw.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = lrs


def to_device(group: List[dict], device) -> dict:
    from halva_tpu_torch.train.data import collate

    arrays = collate(group, pad_token_id=0)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def lora_leaves(trainable):
    """(short name, dense path, factor, leaf) of every trainable leaf."""
    from halva_tpu_torch import tree as port_tree

    for path, x in port_tree.flatten(trainable):
        if x is not None:
            name = leaf_name(path)
            dense, part = name.rsplit("/", 1)
            yield short(name), dense, part, x


def acc_norms(trainable, opt, cycle_step: int) -> Dict[str, float]:
    """Per-leaf norms of the gradient the optimizer got at micro-step
    `cycle_step` of its cycle, the first of the run, worked out from its
    accumulator (which starts at zero: acc = g / (cycle_step + 1))."""
    return {k: float(a.float().norm()) * (cycle_step + 1)
            for (k, _, _, _), a in zip(lora_leaves(trainable), opt.acc)}


def change_norms(trainable, lora0) -> Dict[str, float]:
    """Per-leaf norms of the change of the trainable leaves since set-up
    made them."""
    return {k: float((x.detach().float() - lora0[dense][part].float())
                     .norm())
            for k, dense, part, x in lora_leaves(trainable)}


def prepare(ctx, quantize: bool = False):
    """Weights, adapter and feed from the seed, and the program's train
    state over them (on an int8 base from the program's own quantizer
    when `quantize`: the control)."""
    p, model, job = ctx.params, ctx.model, ctx.cell["job"]
    cfg, tree = harness.make_tree(ctx)
    weights.add_lora(tree, ctx.seed, job["lora_r"], job["lora_alpha"],
                     job["lora_b_std"], ctx.device,
                     getattr(torch, ctx.config["dtype"]))
    lora0 = weights.clone_lora(tree)
    groups = batches(p, samples(p, model, ctx.config["assumed"]["eos_token_id"],
                                ctx.seed))
    feed = [to_device(g, ctx.device) for g in groups]
    policy = tree
    if quantize:
        from halva_tpu_torch.ops.quant import quantize_params

        with torch.no_grad():
            policy = quantize_params(tree)
    trainable, frozen, opt, step = build(ctx, policy, cfg)
    return {"tree": tree, "lora0": lora0, "groups": groups, "feed": feed,
            "trainable": trainable, "frozen": frozen, "opt": opt,
            "step": step}


def first_steps(st: dict, job: dict):
    """The first `checked_steps` micro-steps through the window's own call
    and feed: each one's (loss, alignment, divergence); the per-leaf norms
    of the gradient the optimizer got in the first; and of each leaf's
    change after them all."""
    losses, grads = [], None
    cycle_step = st["opt"].mini_step
    for i in range(job["checked_steps"]):
        st["trainable"], st["opt"], m = st["step"](
            st["trainable"], st["frozen"], None, st["opt"], st["feed"][i])
        losses.append((float(m.loss), float(m.alignment),
                       float(m.divergence)))
        if i == 0:
            grads = acc_norms(st["trainable"], st["opt"], cycle_step)
    return losses, grads, change_norms(st["trainable"], st["lora0"])


def drop_program(st: dict, device) -> None:
    for k in ("trainable", "frozen", "opt", "step", "feed"):
        st.pop(k, None)
    harness.free(device)


def check(ctx, st: dict, prog) -> Dict[str, float]:
    """The reference over the first micro-steps' samples, from the
    benchmark's own weights and adapter; the numbers compared. `prog`:
    first_steps' readings."""
    from portbench.reference.llava import Reference

    prog_losses, prog_grads, prog_change = prog
    image_tokens = harness.image_tokens(ctx.model)
    ref = Reference(st["tree"], ctx.config, st["lora0"])
    ref_losses, ref_grads, ref_change = reference_steps(
        ref, st["groups"][:len(prog_losses)], ctx.device, ctx.cell["job"],
        image_tokens, getattr(torch, ctx.config["dtype"]))
    ref.release()
    st["readings"] = {"program_losses": prog_losses,
                      "reference_losses": ref_losses,
                      "program_grads": prog_grads,
                      "reference_grads": ref_grads,
                      "program_change": prog_change,
                      "reference_change": ref_change}
    return compare(prog_losses, ref_losses, prog_grads, ref_grads,
                   prog_change, ref_change)


def run(ctx) -> dict:
    p, model, job = ctx.params, ctx.model, ctx.cell["job"]
    dev = ctx.device
    image_tokens = harness.image_tokens(model)
    st = prepare(ctx)
    # set-up ends with the first micro-steps, which the reference follows
    prog = first_steps(st, job)
    harness.sync(dev)

    tracer = trace_lib.Tracer(p["trace_first"], p["trace_units"]) \
        if ctx.trace else None
    feed, groups, step = st["feed"], st["groups"], st["step"]
    units = []
    harness.window_opens()
    start = time.perf_counter()
    setup_s = start - ctx.t0
    i = 0
    while True:
        k = (job["checked_steps"] + i) % len(feed)
        t0 = time.perf_counter()
        with (tracer.unit(i) if tracer else contextlib.nullcontext()):
            st["trainable"], st["opt"], m = step(
                st["trainable"], st["frozen"], None, st["opt"], feed[k])
            loss = float(m.loss)
        t1 = time.perf_counter()
        sh = shapes(groups[k], image_tokens)
        units.append({
            "t": t1 - t0, "end": t1 - start, "items": len(groups[k]),
            "ok": math.isfinite(loss),
            "traced": bool(tracer and tracer.traced(i)),
            "flops": flops.train_step_flops(model, sh["pn"], sh["ref"],
                                            job["lora_r"]),
            "shapes": sh,
        })
        i += 1
        if t1 - start >= ctx.seconds and (tracer is None or i > tracer.last):
            break
    peak = harness.peak_bytes(dev)
    harness.window_closes()

    # the check, after the window, with the program's state freed
    del step, feed, m
    drop_program(st, dev)
    nums = check(ctx, st, prog)
    return {
        "kind": "dpa_train", "model": model, "job": job, "units": units,
        "window_s": units[-1]["end"], "setup_s": setup_s,
        "peak_bytes": peak, "trace": tracer.trace if tracer else None,
        "attempted": sum(u["items"] for u in units),
        "failed": sum(u["items"] for u in units if not u["ok"]),
        "checks": harness.checks(nums, ctx.cell["limits"]),
        "readings": st["readings"],
    }
