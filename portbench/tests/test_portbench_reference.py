"""The plain references agree with the port at tiny sizes, in fp32 on the
CPU: prefill and decode logits through the cache, the DPA loss and the
LoRA gradients."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference.llava import Reference
from portbench.tests import tiny
from portbench.tests.conftest import SEED
from portbench.traffic import dpa_train, eval_batches

CONFIGS = ["llava-mistral-7b", "llava-mpt-7b"]


def _tree(name, lora=False):
    config = tiny.config(name)
    ctx = harness.Context("t", {"traffic": {}}, config, SEED, 0.0, False,
                          "cpu", 0.0)
    cfg, tree = harness.make_tree(ctx)
    if lora:
        weights.add_lora(tree, SEED, 4, 8.0, 0.05, "cpu", torch.float32)
    return config, cfg, tree


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_logits_match_the_reference(name):
    from halva_tpu_torch.ops import generate as gen
    from halva_tpu_torch.models import llama

    config, cfg, tree = _tree(name)
    cell = tiny.cell("mistral7b-pope")
    batch = eval_batches.make_batches(cell["traffic"], config["model"],
                                      SEED)[0]
    steps = 5
    with torch.no_grad():
        first, first_logits, spliced, cache, seg = gen._prefill_impl(
            tree, cfg, batch["ids"], batch["images"], batch["lens"])
        gen_cache = gen.init_gen_cache_like(cfg.llm, first.shape[0], steps,
                                            cache)
        tok, logits = first, [first_logits]
        toks = [first]
        for s in range(steps - 1):
            step = torch.tensor(s)
            emb = llama.embed(tree["llm"], tok[:, None])
            out, _ = llama.decode_step(tree["llm"], cfg.llm, emb,
                                       spliced + step, cache, seg,
                                       gen_cache, step)
            logits.append(out.float())
            tok = out.argmax(-1).to(torch.int32)
            toks.append(tok)
    got = torch.stack(logits, 1)  # (B, steps, V)
    served = torch.stack(toks, 1).numpy()

    ref = Reference(tree, config)
    image_tokens = 4
    feats = ref.features(batch["images"])
    rows, where = [], []
    table = tree["llm"]["embed"]["embedding"]
    for r in range(got.shape[0]):
        n = int(batch["lens"][r])
        prompt = ref.embed_row(batch["ids"][r, :n].numpy(), feats[r])
        rows.append(torch.cat([prompt, table[torch.as_tensor(
            served[r, :-1], dtype=torch.long)].float()]))
        where.append(torch.arange(prompt.shape[0] - 1,
                                  prompt.shape[0] - 1 + steps))
        assert prompt.shape[0] == n + image_tokens - 1
    hs = ref.hidden(rows, lora=False)
    want = torch.stack([ref.logits(h[w]) for h, w in zip(hs, where)])
    # the prefill's logits to fp32 rounding; the decode steps read the
    # prompt cache the port keeps in bf16 whatever the tree's dtype, so
    # they agree within a few of bf16's 2^-8 of the logits' scale (a wrong
    # position, mask or bias reads as large as the logits themselves)
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-4, atol=1e-4)
    scale = float(want.abs().max())
    torch.testing.assert_close(got[:, 1:], want[:, 1:], rtol=0,
                               atol=2**-6 * scale)


@pytest.mark.parametrize("name", CONFIGS)
def test_dpa_loss_and_lora_grads_match_the_reference(name):
    from halva_tpu_torch import tree as port_tree
    from halva_tpu_torch.train.trainer import (TrainConfig, dpa_step_fns,
                                                init_train_state)

    config, cfg, tree = _tree(name, lora=True)
    lora0 = weights.clone_lora(tree)
    cell = tiny.cell("mistral7b-dpa-train")
    p = cell["traffic"]
    groups = dpa_train.batches(p, dpa_train.samples(p, config["model"], 2,
                                                    SEED))
    tcfg = TrainConfig(grad_accum_steps=4, loss_alpha=0.4, remat=True)
    trainable, frozen, opt, _ = init_train_state(tree, tcfg)
    step, _ = dpa_step_fns(cfg, tcfg, opt)
    batch = dpa_train.to_device(groups[0], "cpu")
    loss, parts, grads = step.loss_and_grads(trainable, frozen, None, batch)
    got = {dpa_train.short(dpa_train.leaf_name(path)): float(g.norm())
           for path, g in port_tree.flatten(grads) if g is not None}

    ref = Reference(tree, config, lora0)
    losses, ref_grads, _ = dpa_train.reference_steps(
        ref, groups[:1], "cpu", cell["job"], 4, torch.float32)
    np.testing.assert_allclose(
        [float(loss), float(parts.alignment), float(parts.divergence)],
        losses[0], rtol=1e-4, atol=1e-6)
    assert parts.divergence > 0  # the adapter is not zero
    for k, v in ref_grads.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-8)
    if name == "llava-mpt-7b":
        assert ref_grads["gate/lora_a"] == 0.0 == got["gate/lora_a"]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_resumed_update_matches_the_reference(name):
    """Three micro-steps of the resumed optimizer, the second ending its
    accumulation cycle: each leaf's change agrees with plain AdamW's, and
    the third micro-step's loss reads the updated adapter."""
    config, cfg, tree = _tree(name, lora=True)
    cell = tiny.cell("mistral7b-dpa-train")
    cell["config"] = name
    ctx = harness.Context("t", cell, config, SEED, 0.0, False, "cpu", 0.0)
    st = dpa_train.prepare(ctx)
    prog = dpa_train.first_steps(st, cell["job"])
    assert st["opt"].updates == cell["job"]["resume_updates"] + 1
    dpa_train.drop_program(st, "cpu")
    nums = dpa_train.check(ctx, st, prog)
    moved = [k for k, v in st["readings"]["reference_change"].items() if v]
    assert len(moved) >= 12
    for k in moved:
        np.testing.assert_allclose(st["readings"]["program_change"][k],
                                   st["readings"]["reference_change"][k],
                                   rtol=1e-4)
    assert nums["update"] < 1e-4 and nums["loss"] < 1e-4


def test_plain_adamw_by_hand():
    from portbench.reference import optim

    job = {"learning_rate": 1e-3, "warmup_ratio": 0.1, "num_train_steps": 100,
           "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-8,
           "weight_decay": 0.0}
    assert optim.learning_rate(job, 0) == 0.0
    assert optim.learning_rate(job, 5) == pytest.approx(5e-4)
    assert optim.learning_rate(job, 10) == pytest.approx(1e-3)
    assert optim.learning_rate(job, 55) == pytest.approx(5e-4)
    acc = optim.accumulate([torch.zeros(2)], [torch.tensor([3.0, 4.0])], 0)
    assert acc[0].tolist() == [3.0, 4.0]
    acc = optim.accumulate(acc, [torch.tensor([1.0, 0.0])], 1)
    assert acc[0].tolist() == [2.0, 2.0]
    clipped = optim.clip([torch.tensor([3.0, 4.0])], 1.0)[0]
    assert clipped.tolist() == pytest.approx([0.6, 0.8])
    # Adam's first step moves each element by lr in its gradient's sign
    p = torch.tensor([1.0, -1.0, 0.5])
    new = optim.adamw([p], [torch.tensor([2.0, -1e-3, 0.0])], {}, 0.01, job,
                      torch.float32)[0]
    assert new.tolist() == pytest.approx([0.99, -0.99, 0.5])
