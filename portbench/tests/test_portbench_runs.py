"""Each cell end to end at a tiny preset of its architecture, on the CPU
through the port's plain route, and the faults its check must catch."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests import tiny
from portbench.tests.conftest import SEED

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_is_correct(tiny_results, name):
    out = tiny_results[name]
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), name, False)}
    assert set(out["metrics"]) == want
    assert {"setup_s", "peak_mem_gib"} <= set(out["metrics"])
    assert out["device"]["platform"] == "cpu"


def test_the_same_seed_gives_the_same_inputs():
    from portbench.traffic import dpa_train, eval_batches

    cell = tiny.cell("mistral7b-dpa-train")
    model = tiny.config(cell["config"])["model"]
    a = dpa_train.samples(cell["traffic"], model, 2, SEED)
    b = dpa_train.samples(cell["traffic"], model, 2, SEED)
    c = dpa_train.samples(cell["traffic"], model, 2, SEED + 1)
    assert all((x["input_ids"] == y["input_ids"]).all() for x, y in zip(a, b))
    assert [len(x["input_ids"]) for x in a] == [len(x["input_ids"])
                                                for x in c]
    assert any((x["input_ids"] != y["input_ids"]).any() for x, y in zip(a, c))
    pope = tiny.cell("mistral7b-pope")
    pa = eval_batches.make_batches(pope["traffic"], model, SEED)
    pb = eval_batches.make_batches(pope["traffic"], model, SEED)
    assert all(torch.equal(x["images"], y["images"]) for x, y in zip(pa, pb))


def _run(name, seed=SEED):
    cell = tiny.cell(name)
    return harness.run_cell(name, cell, tiny.config(cell["config"]), seed,
                            0.0, False, "cpu")


def test_a_train_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    from halva_tpu_torch.train import trainer

    def step(self, grads):
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in self.leaves]
        return False

    monkeypatch.setattr(trainer.DPAOptimizer, "step", step)
    out = _run("mistral7b-dpa-train")
    assert not out["correct"] and out["checks"]["grad"]["value"] >= 0.99
    assert out["checks"]["update"]["value"] >= 0.99


def _skipped(real):
    def step(self, *args, **kwargs):
        return None
    return step


def _twice(real):
    def step(self, *args, **kwargs):
        real(self, *args, **kwargs)
        return real(self, *args, **kwargs)
    return step


def _double_rate(real):
    def step(self, *args, **kwargs):
        for group in self.param_groups:
            group["lr"] *= 2
        try:
            return real(self, *args, **kwargs)
        finally:
            for group in self.param_groups:
                group["lr"] /= 2
    return step


@pytest.mark.parametrize("fault", [_skipped, _twice, _double_rate],
                         ids=["skipped", "applied twice", "twice the rate"])
def test_a_wrong_optimizer_update_fails(monkeypatch, fault):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        fault(torch.optim.AdamW.step))
    out = _run("mistral7b-dpa-train")
    assert not out["correct"] and out["checks"]["update"]["value"] >= 0.5


def test_a_train_step_on_half_the_batch_fails(monkeypatch):
    from halva_tpu_torch.train import trainer

    real = trainer.dpa_step_fns

    def halved(*args, **kwargs):
        step, ev = real(*args, **kwargs)

        def train_step(tr, fr, rp, opt, batch):
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return step(tr, fr, rp, opt, half)

        return train_step, ev

    monkeypatch.setattr(trainer, "dpa_step_fns", halved)
    out = _run("mistral7b-dpa-train")
    assert not out["correct"]


def _patch_generate(monkeypatch, fault):
    from halva_tpu_torch.ops import generate as gen

    real = gen.generate_greedy

    def broken(params, cfg, ids, images, lens, **kw):
        return fault(real, params, cfg, ids, images, lens, kw)

    monkeypatch.setattr(gen, "generate_greedy", broken)


def _altered(real, params, cfg, ids, images, lens, kw):
    tokens, num = real(params, cfg, ids, images, lens, **kw)
    tokens = tokens.clone()
    tokens[:, 0] = (tokens[:, 0] + 1) % cfg.llm.vocab_size
    return tokens, num


def _half_batch(real, params, cfg, ids, images, lens, kw):
    h = ids.shape[0] // 2
    tokens, num = real(params, cfg, ids[:h], images[:h], lens[:h], **kw)
    return torch.cat([tokens, torch.zeros_like(tokens)]), torch.cat(
        [num, num])


@pytest.mark.parametrize("name", ["mistral7b-pope", "mpt7b-chair"])
@pytest.mark.parametrize("fault", [_altered, _half_batch],
                         ids=["a token altered", "half the batch"])
def test_an_eval_fault_fails(monkeypatch, name, fault):
    _patch_generate(monkeypatch, fault)
    out = _run(name)
    assert not out["correct"], out["checks"]
