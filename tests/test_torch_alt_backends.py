"""The Mistral-like (GQA, sliding window) and MPT-like (ALiBi, bias-free
LayerNorm, non-gated GELU MLP, tied embeddings) backends of the port against
the JAX package through the entry points, on LLAVA_TINY's towers with a tiny
LLM of each kind, fp32, the same seeded weights and inputs:

- greedy decode and 2-beam search token-exact against
  halva_tpu.ops.generate / ops.beam (the window, 8, is smaller than the
  ~15-token spliced prompts, so decode runs the position-aware plain
  attention with prompt keys dropped; ALiBi decode adds the per-step bias);
- one DPA micro-step's loss parts (rtol 1e-5) and LoRA grads (within 1e-4 of
  each leaf's largest |grad|) on the MPT-like config against
  `dpa_step_fns(...).loss_and_grads`. MPT's MLP is not gated, yet the tree
  carries a `gate` stack and `add_lora` puts factors on it in both packages:
  their grads are exactly 0 in both;
- the speculative entry refuses both configs, as the reference's does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.ops import beam as jbeam
from halva_tpu.ops import generate as jgenerate
from halva_tpu.ops import speculative as jspeculative
from halva_tpu.train import lora as jlora
from halva_tpu.train import trainer as jtrainer
from halva_tpu_torch import tree
from halva_tpu_torch.ops import beam, generate, speculative
from halva_tpu_torch.train import trainer

from test_torch_llama import MISTRAL_TINY, MPT_TINY
from test_torch_llava import _generate_inputs
from test_torch_tree import jax_tree, port_cfg, shared_trees
from test_trainer import _fake_batch

torch.set_num_threads(2)

CFGS = {
    "mistral_like": dataclasses.replace(LLAVA_TINY, llm=MISTRAL_TINY),
    "mpt_like": dataclasses.replace(LLAVA_TINY, llm=MPT_TINY),
}
MAX_NEW = 10


@pytest.mark.parametrize("kv_quant", [False, "int4"])
@pytest.mark.parametrize("name", list(CFGS))
def test_generate_greedy_token_exact(name, kv_quant):
    cfg = CFGS[name]
    jp, tp = shared_trees(cfg)
    ids, imgs, lens = _generate_inputs()
    want_tok, want_num = jgenerate.generate_greedy(
        jp, cfg, jnp.asarray(ids), jnp.asarray(imgs), jnp.asarray(lens),
        max_new_tokens=MAX_NEW, eos_id=-1, kv_quant=kv_quant)
    with torch.inference_mode():
        got_tok, got_num = generate.generate_greedy(
            tp, port_cfg(cfg), torch.from_numpy(ids), torch.from_numpy(imgs),
            torch.from_numpy(lens), max_new_tokens=MAX_NEW, eos_id=-1,
            kv_quant=kv_quant)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_num.numpy(), np.asarray(want_num))
    assert int(got_num[0]) == MAX_NEW and int(got_num[2]) == 0  # dead row


@pytest.mark.parametrize("name", list(CFGS))
def test_generate_beam_token_exact(name):
    cfg = CFGS[name]
    jp, tp = shared_trees(cfg)
    ids, imgs, lens = _generate_inputs()
    want_tok, want_num = jbeam.generate_beam(
        jp, cfg, jnp.asarray(ids), jnp.asarray(imgs), jnp.asarray(lens),
        max_new_tokens=MAX_NEW, eos_id=-1, num_beams=2, attn_impl="xla")
    with torch.inference_mode():
        got_tok, got_num = beam.generate_beam(
            tp, port_cfg(cfg), torch.from_numpy(ids), torch.from_numpy(imgs),
            torch.from_numpy(lens), max_new_tokens=MAX_NEW, eos_id=-1,
            num_beams=2)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_num.numpy(), np.asarray(want_num))


@pytest.mark.parametrize("name", list(CFGS))
def test_speculative_refuses_as_the_reference(name):
    cfg = CFGS[name]
    jp, tp = shared_trees(cfg)
    ids, imgs, lens = _generate_inputs()
    with pytest.raises(NotImplementedError):
        jspeculative.generate_speculative(
            jp, cfg, jnp.asarray(ids), jnp.asarray(imgs), jnp.asarray(lens),
            max_new_tokens=4, eos_id=-1)
    with pytest.raises(NotImplementedError):
        speculative.generate_speculative(
            tp, port_cfg(cfg), torch.from_numpy(ids), torch.from_numpy(imgs),
            torch.from_numpy(lens), max_new_tokens=4, eos_id=-1)


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("name", list(CFGS))
def test_dpa_micro_step_matches_reference(name, chunk):
    cfg = CFGS[name]
    params = jax.tree.map(jnp.asarray, jax_tree(cfg))
    lp = jlora.add_lora(params, jax.random.PRNGKey(1), rank=4, alpha=8)
    rng = np.random.RandomState(5)
    for _, p in jlora._iter_dense(lp):
        if "lora_b" in p:
            p["lora_b"] = jnp.asarray(
                rng.randn(*p["lora_b"].shape).astype(np.float32) * 0.05)
    np_lp = jax.tree.map(np.array, lp)
    kw = dict(grad_accum_steps=1, num_train_steps=10, remat=True,
              loss_chunk=chunk)
    batch = _fake_batch(b=2, seed=0)

    jcfg = jtrainer.TrainConfig(attn_impl="xla", **kw)
    jt, jf, jopt, _ = jtrainer.init_train_state(
        jax.tree.map(jnp.asarray, np_lp), jcfg)
    jstep, _ = jtrainer.dpa_step_fns(cfg, jcfg, jopt)
    _, jparts, jg = jax.jit(jstep.loss_and_grads)(
        jt, jf, None, {k: jnp.asarray(v) for k, v in batch.items()})

    tcfg = trainer.TrainConfig(**kw)
    tt, tf, topt, _ = trainer.init_train_state(
        tree.to_torch(np_lp, device="cpu"), tcfg)
    tstep, _ = trainer.dpa_step_fns(port_cfg(cfg), tcfg, topt)
    _, tparts, tg = tstep.loss_and_grads(
        tt, tf, None, {k: torch.from_numpy(v) for k, v in batch.items()})

    for got, want in zip(tparts, jparts):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(tparts.divergence) > 0
    want = {p: w for p, w in tree.flatten(jax.tree.map(np.asarray, jg))
            if w is not None}
    got = {p: g for p, g in tree.flatten(tg) if g is not None}
    assert sorted(got, key=str) == sorted(want, key=str)
    unused = 0
    for path, w in want.items():
        scale = np.abs(w).max()
        if scale == 0:  # the unused gate stack of the non-gated MLP
            assert "gate" in path and not cfg.llm.gated_mlp, path
            assert not got[path].any(), path
            unused += 1
            continue
        np.testing.assert_allclose(got[path].numpy(), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=str(path))
    assert unused == (0 if cfg.llm.gated_mlp else 2)


@pytest.mark.parametrize("num_beams", [1, 2])
@pytest.mark.parametrize("name", list(CFGS))
def test_batched_generator_texts_match_reference(tmp_path, name, num_beams):
    """BatchedGenerator on both backends, greedy and beams: the answers of
    the reference's, exactly."""
    from halva_tpu.evals import runner as jrunner
    from halva_tpu.mm_utils import ImageProcessor
    from halva_tpu_torch.evals import runner

    from test_data_pipeline import SPTok
    from test_torch_runner import _requests

    cfg = CFGS[name]
    jp, tp = shared_trees(cfg)
    kw = dict(batch_size=2, max_new_tokens=4, prompt_bucket=16,
              num_beams=num_beams)
    proc = ImageProcessor(size=28, crop_size=28)
    want = jrunner.BatchedGenerator(
        jp, cfg, SPTok(), proc, attn_impl="xla", **kw
    ).run(_requests(tmp_path, jrunner))
    got = runner.BatchedGenerator(tp, port_cfg(cfg), SPTok(), proc,
                                  **kw).run(_requests(tmp_path, runner))
    assert got == want and len(got) == 5
