"""Llama decoder in the port (halva_tpu_torch/models/llama.py) against
halva_tpu.models.llama on the same tiny fp32 trees: the forward's logits,
prefill's hidden states and head-major prompt cache, and one decode step's
logits and updated gen cache.

Tolerances: fp32 activations rtol = atol = 1e-5 (only summation order
differs). The KV caches are bf16 in both packages (prefill writes
cache_dtype=bfloat16); an fp32 value a few ulps apart can round to
neighbouring bf16 values, so cache entries may differ by one bf16 step
(rtol 2^-7)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAMA_TINY
from halva_tpu.models import llama as jllama
from halva_tpu_torch import tree
from halva_tpu_torch.models import llama

from test_torch_tree import LLAVA_TINY_GQA

torch.set_num_threads(2)

CONFIGS = {"mha": LLAMA_TINY, "gqa_tied": LLAVA_TINY_GQA.llm}
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_STEP = dict(rtol=2**-7, atol=1e-6)


def _llm_trees(cfg):
    params = jllama.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    np_tree = jax.tree.map(np.asarray, params)
    return jax.tree.map(jnp.asarray, np_tree), tree.to_torch(np_tree)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits(name):
    cfg = CONFIGS[name]
    jp, tp = _llm_trees(cfg)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    seg = np.ones((2, 24), np.int32)
    seg[1, 17:] = 0
    want = jllama.forward(jp, cfg, jnp.asarray(ids), jnp.asarray(seg))
    got = llama.forward(tp, cfg, torch.from_numpy(ids), torch.from_numpy(seg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_norms_and_rope():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    pos = rng.randint(0, 300, (2, 5)).astype(np.int32)
    for unit in (False, True):
        np.testing.assert_allclose(
            _np(llama.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                               1e-5, unit)),
            _np(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, unit)),
            **F32)
    np.testing.assert_allclose(
        _np(llama.layer_norm_np(torch.from_numpy(x), torch.from_numpy(w),
                                1e-5)),
        _np(jllama.layer_norm_np(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        **F32)
    for scale in (None, 4.0):
        tc, ts = llama.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0, scale)
        jc, js = jllama.rope_cos_sin(jnp.asarray(pos), 16, 10000.0, scale)
        np.testing.assert_allclose(_np(tc), _np(jc), **F32)
        np.testing.assert_allclose(
            _np(llama.apply_rope(torch.from_numpy(x), tc, ts)),
            _np(jllama.apply_rope(jnp.asarray(x), jc, js)), **F32)


def _prefill_inputs(cfg, b=2, s=20, seed=2):
    rng = np.random.RandomState(seed)
    emb = rng.randn(b, s, cfg.hidden_size).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    seg[1, 13:] = 0
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return emb, seg, pos


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_hidden_and_cache(name):
    cfg = CONFIGS[name]
    jp, tp = _llm_trees(cfg)
    emb, seg, pos = _prefill_inputs(cfg)
    jh, jc = jax.jit(lambda p, e, s_, q: jllama.prefill(p, cfg, e, s_, q))(
        jp, jnp.asarray(emb), jnp.asarray(seg), jnp.asarray(pos))
    th, tc = llama.prefill(tp, cfg, torch.from_numpy(emb),
                           torch.from_numpy(seg), torch.from_numpy(pos))
    np.testing.assert_allclose(_np(th), _np(jh), **F32)
    for key in ("k", "v"):
        assert tc[key].dtype == torch.bfloat16
        assert tuple(tc[key].shape) == jc[key].shape == (
            cfg.num_layers, 2, cfg.kv_heads, 20, cfg.head_size)
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **BF16_STEP)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_step_logits_and_gen_cache(name):
    cfg = CONFIGS[name]
    jp, tp = _llm_trees(cfg)
    emb, seg, pos = _prefill_inputs(cfg)
    _, jc = jax.jit(lambda p, e, s_, q: jllama.prefill(p, cfg, e, s_, q))(
        jp, jnp.asarray(emb), jnp.asarray(seg), jnp.asarray(pos))
    prompt_np = jax.tree.map(np.asarray, jc)
    # a gen cache whose first slots hold earlier steps' keys and values
    rng = np.random.RandomState(3)
    step = 2
    gen_np = jax.tree.map(np.array, jllama.init_gen_cache(cfg, 2, 5))
    assert gen_np["k"].shape[3] == 128  # Sg rounds up to a 128 multiple
    for key in ("k", "v"):
        filled = rng.randn(*gen_np[key][:, :, :, :step].shape)
        gen_np[key][:, :, :, :step] = np.asarray(
            jnp.asarray(filled, jnp.bfloat16))
    tok_emb = rng.randn(2, 1, cfg.hidden_size).astype(np.float32)
    positions = np.array([20 + step, 13 + step], np.int32)

    want_logits, want_gen = jax.jit(
        lambda p, e, q, pc, ps, gc: jllama.decode_step(
            p, cfg, e, q, pc, ps, gc, jnp.int32(step))
    )(jp, jnp.asarray(tok_emb), jnp.asarray(positions),
      jax.tree.map(jnp.asarray, prompt_np), jnp.asarray(seg),
      jax.tree.map(jnp.asarray, gen_np))
    gen_t = tree.to_torch(gen_np)
    got_logits, got_gen = llama.decode_step(
        tp, cfg, torch.from_numpy(tok_emb), torch.from_numpy(positions),
        tree.to_torch(prompt_np), torch.from_numpy(seg), gen_t, step)
    assert got_gen is gen_t  # written in place
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(got_gen[key]), _np(want_gen[key]),
                                   **BF16_STEP)


def test_unported_branches_raise():
    x = torch.zeros(2, 4)
    with pytest.raises(NotImplementedError):
        llama.dense(x, {"kernel_q": x, "kernel_scale": x})
    with pytest.raises(NotImplementedError):
        llama.dense(x, {"kernel": torch.zeros(4, 4), "lora_a": x})
    cfg = dataclasses.replace(LLAMA_TINY, sliding_window=8)
    _, tp = _llm_trees(LLAMA_TINY)
    with pytest.raises(NotImplementedError):
        llama.forward(tp, cfg, torch.zeros(1, 4, dtype=torch.int32))
