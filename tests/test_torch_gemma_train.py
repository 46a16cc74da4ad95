"""Gemma's DPA LoRA train step in the port against the JAX package, on the
CPU: VILA's llava_gemma composition at tiny widths (LLAVA_TINY's towers
under `gemma_like`: 2 layers, 2 query heads over 1 KV head at Gemma's head
dim 256, unit-offset RMSNorm, gelu_tanh, the tied head), fp32, the same
numpy-seeded weights, LoRA r=4 factors from the reference's `add_lora` with
a perturbed lora_b (at B = 0 the KL and the lora_a grads are exactly 0), and
the same batches:

- one unpacked DPA micro-step (`dpa_step_fns(...).loss_and_grads`, remat
  on) at loss_chunk None and 8: its loss parts within rtol 1e-5 of the
  reference's (attn_impl "xla"), its LoRA grads within 1e-4 of each leaf's
  largest |grad| (the bound test_torch_alt_backends.py holds Mistral and MPT
  to: fp32 sums over other orders, magnified near 0 by the unit-offset
  norms);
- one packed micro-step (`packed_dpa_step_fns`, three samples in rows of
  the reference's PackedDPABatcher): its loss parts within rtol 1e-5 of the
  reference's packed eval loss and its LoRA grads within 1e-4 of each
  leaf's largest |grad| of `jax.grad` of that loss (the reference's packed
  step has no loss_and_grads hook; it holds the frozen reference under
  stop_gradient, as its step does);
- the route: with grad enabled, attn_impl "auto" and "kernel" reach the
  flash wrapper (K1 forward, K2 and K3 backward on the card) at head dim
  256 in every layer of every forward, "plain" never does; on CPU tensors
  the wrapper's plain path through autograd gives the plain route's loss
  parts and grads bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.train import lora as jlora
from halva_tpu.train import trainer as jtrainer
from halva_tpu_torch import tree
from halva_tpu_torch.train import trainer

from test_packed_dpa import IMG, T, _make_items
from test_torch_gemma import gemma_like
from test_torch_tree import jax_tree, port_cfg
from test_trainer import _fake_batch

torch.set_num_threads(2)

CFG = dataclasses.replace(LLAVA_TINY, llm=gemma_like())
PARTS_RTOL = 1e-5
GRAD_REL = 1e-4


def _np_policy(seed_b=5, b_std=0.05):
    params = jax.tree.map(jnp.asarray, jax_tree(CFG))
    lp = jlora.add_lora(params, jax.random.PRNGKey(1), rank=4, alpha=8)
    rng = np.random.RandomState(seed_b)
    for _, p in jlora._iter_dense(lp):
        if "lora_b" in p:
            p["lora_b"] = jnp.asarray(
                rng.randn(*p["lora_b"].shape).astype(np.float32) * b_std)
    return jax.tree.map(np.array, lp)


def _torch_state(np_lp, **kw):
    tcfg = trainer.TrainConfig(**kw)
    tr, fz, opt, st = trainer.init_train_state(
        tree.to_torch(jax.tree.map(np.array, np_lp), device="cpu"), tcfg)
    return tr, fz, opt, st, tcfg


def _grads_close(got_tree, want_tree):
    want = {p: w for p, w in tree.flatten(jax.tree.map(np.asarray, want_tree))
            if w is not None}
    got = {p: g for p, g in tree.flatten(got_tree) if g is not None}
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, path
        np.testing.assert_allclose(got[path].numpy(), w, rtol=0,
                                   atol=GRAD_REL * scale, err_msg=str(path))


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def np_lp():
    return _np_policy()


@pytest.mark.parametrize("chunk", [None, 8])
def test_dpa_micro_step_matches_reference(np_lp, chunk):
    kw = dict(grad_accum_steps=1, num_train_steps=10, remat=True,
              loss_chunk=chunk)
    batch = _fake_batch(b=2, seed=0)

    jcfg = jtrainer.TrainConfig(attn_impl="xla", **kw)
    jt, jf, jopt, _ = jtrainer.init_train_state(
        jax.tree.map(jnp.asarray, np_lp), jcfg)
    jstep, _ = jtrainer.dpa_step_fns(CFG, jcfg, jopt)
    _, jparts, jg = jax.jit(jstep.loss_and_grads)(
        jt, jf, None, {k: jnp.asarray(v) for k, v in batch.items()})

    tt, tf, topt, _, tcfg = _torch_state(np_lp, **kw)
    tstep, _ = trainer.dpa_step_fns(port_cfg(CFG), tcfg, topt)
    _, tparts, tg = tstep.loss_and_grads(tt, tf, None, _t(batch))

    for got, want in zip(tparts, jparts):
        np.testing.assert_allclose(float(got), float(want), rtol=PARTS_RTOL)
    assert float(tparts.divergence) > 0
    _grads_close(tg, jg)


def _packed_batch(items):
    from halva_tpu_torch.train.pack import PackedDPABatcher

    b = PackedDPABatcher(seq_len=64, pn_rows=3, ref_rows=2, max_samples=3,
                         num_image_tokens=T, pad_token_id=0,
                         image_shape=(3, IMG, IMG))
    batches = list(b.batches(iter(items)))
    assert len(batches) == 1, "the items must fit one packed batch"
    return batches[0]


def test_packed_micro_step_matches_reference(np_lp):
    kw = dict(learning_rate=1e-3, grad_accum_steps=1, num_train_steps=4,
              loss_chunk=8)
    batch = _packed_batch(_make_items(3, seed=21))
    assert int(batch["n_samples"]) == 3

    jcfg = jtrainer.TrainConfig(attn_impl="xla", **kw)
    jt, jf, jopt, _ = jtrainer.init_train_state(
        jax.tree.map(jnp.asarray, np_lp), jcfg)
    _, jev = jtrainer.packed_dpa_step_fns(CFG, jcfg, jopt, max_samples=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparts = jax.jit(jev)(jt, jf, None, jbatch)
    jg = jax.jit(jax.grad(lambda t: jev(t, jf, None, jbatch).loss))(jt)

    tt, tf, topt, _, tcfg = _torch_state(np_lp, **kw)
    tstep, _ = trainer.packed_dpa_step_fns(port_cfg(CFG), tcfg, topt,
                                           max_samples=3)
    _, tparts, tg = tstep.loss_and_grads(tt, tf, None, _t(batch))

    for got, want in zip(tparts[:3], jparts[:3]):
        np.testing.assert_allclose(float(got), float(want), rtol=PARTS_RTOL)
    assert float(tparts.divergence) > 0
    _grads_close(tg, jg)


@pytest.mark.parametrize("packed", [False, True])
def test_grad_route_takes_the_flash_wrapper_at_head_dim_256(np_lp, packed,
                                                           monkeypatch):
    from halva_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape[-1])
                        or real(*a, **k))
    if packed:
        batch = _t(_packed_batch(_make_items(3, seed=21)))
    else:
        batch = _t(_fake_batch(b=2, seed=0))
    runs, counts = {}, {}
    for impl in ("auto", "kernel", "plain"):
        kw = dict(grad_accum_steps=1, num_train_steps=10, remat=True,
                  loss_chunk=8, attn_impl=impl)
        tt, tf, topt, _, tcfg = _torch_state(np_lp, **kw)
        if packed:
            step, _ = trainer.packed_dpa_step_fns(port_cfg(CFG), tcfg, topt,
                                                  max_samples=3)
        else:
            step, _ = trainer.dpa_step_fns(port_cfg(CFG), tcfg, topt)
        calls.clear()
        _, parts, grads = step.loss_and_grads(tt, tf, None, batch)
        counts[impl] = list(calls)
        runs[impl] = (parts, grads)
    layers = CFG.llm.num_layers
    # per layer: the pos+neg (pn) forward, its remat recompute, and the
    # policy-as-reference and frozen-reference forwards
    assert counts["plain"] == []
    for impl in ("auto", "kernel"):
        assert counts[impl] == [256] * len(counts[impl])
        assert len(counts[impl]) >= 3 * layers
        assert len(counts[impl]) % layers == 0
        parts, grads = runs[impl]
        want_parts, want_grads = runs["plain"]
        for got, want in zip(parts, want_parts):
            assert float(got) == float(want)
        for (path, g), (_, w) in zip(tree.flatten(grads),
                                     tree.flatten(want_grads)):
            if w is not None:
                assert torch.equal(g, w), path
