"""The DPA trainer in the port (halva_tpu_torch/train/trainer.py, with
models/llava.py:forward and the remat of models/llama.py:forward_embeds)
against the reference's halva_tpu/train/trainer.py on LLAVA_TINY with LoRA
r=4 and a perturbed lora_b (at B = 0 the KL and the lora_a grads are
exactly 0, and a comparison would prove little).

- One micro-step's loss parts and LoRA grads against the reference's
  `train_step.loss_and_grads` (attn_impl "xla"), remat on and off,
  loss_chunk None and 8. Tolerance: loss parts rtol = 1e-5; grads within
  1e-4 of each leaf's largest |grad| (fp32 through 2 layers, two towers and
  log_softmax over 256 classes; measured ~2e-6).
- lr_schedule value for value, within 1e-6 of the value or of the peak lr
  (the reference computes in fp32).
- The LoRA params after 4 micro-steps at grad_accum_steps=2 (2 updates)
  against the reference's jitted step. Adam divides by sqrt(v), which
  turns a tiny grad difference into a visible one where a grad is near 0,
  so the bound is stated against the learning rate: every param within
  lr / 10 of the reference's (each update moves a param by up to ~lr).
- One micro-step on LLAVA_TINY's quantized frozen bases (int8 W8A8, NF4,
  packed int4 per channel and with groups of 32; ref_params=None, bf16
  adapters as `add_lora` gives a quantized base) against the reference on
  the tree carried across. The LLM computes in fp32 (the tiny vocabulary
  keeps its float table), so the bounds stay tight: loss parts rtol = 1e-4;
  the grads are bf16 leaves, like the factors, so each is held within one
  bf16 step of its leaf's largest |grad| (2^-7; the two frameworks round
  the same fp32 value to neighbouring bf16 values where it lies at a
  rounding boundary). The quantized denses' pinned backward multiplies by
  the dequantized weights in the gradient's dtype on both sides. The int8
  base (W8A8) rounds every dense's activations to int8, where a last-bit
  difference between the frameworks moves a value across a rounding
  boundary (one int8 step of one activation): its loss parts rtol = 2e-3
  (measured 7.7e-4). With a vocab-sized table the
  int8 embedding gives bf16 rows and the LLM computes in bf16, where the two
  frameworks round at different places: loss parts rtol = 5e-2, grads by
  relative error of the whole vector <= 0.15.
- Only LoRA leaves change; the projector group updates under
  mm_projector_lr; the frozen reference tree tolerates a lone lora_scale;
  the entry points that are not ported raise naming their ROADMAP item."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY as CFG
from halva_tpu.models import llava as jllava
from halva_tpu.train import lora as jlora
from halva_tpu.train import trainer as jtrainer
from halva_tpu_torch import tree
from halva_tpu_torch.models import llava
from halva_tpu_torch.train import lora, trainer

from test_torch_tree import jax_tree, port_cfg
from test_trainer import _fake_batch

torch.set_num_threads(2)


def _np_policy(seed_b=5, b_std=0.05):
    params = jax.tree.map(jnp.asarray, jax_tree(CFG))
    lp = jlora.add_lora(params, jax.random.PRNGKey(1), rank=4, alpha=8)
    rng = np.random.RandomState(seed_b)
    for _, p in jlora._iter_dense(lp):
        if "lora_b" in p:
            p["lora_b"] = jnp.asarray(
                rng.randn(*p["lora_b"].shape).astype(np.float32) * b_std)
    return jax.tree.map(np.array, lp)


def _jax_state(np_lp, **kw):
    tcfg = jtrainer.TrainConfig(attn_impl="xla", **kw)
    trainable, frozen, opt, opt_state = jtrainer.init_train_state(
        jax.tree.map(jnp.asarray, np_lp), tcfg)
    step, eval_loss = jtrainer.dpa_step_fns(CFG, tcfg, opt)
    return trainable, frozen, opt_state, step, eval_loss


def _torch_state(np_lp, **kw):
    tcfg = trainer.TrainConfig(**kw)
    trainable, frozen, opt, opt_state = trainer.init_train_state(
        tree.to_torch(jax.tree.map(np.array, np_lp), device="cpu"), tcfg)
    step, eval_loss = trainer.dpa_step_fns(port_cfg(CFG), tcfg, opt)
    return trainable, frozen, opt_state, step, eval_loss


def _batches(n=1, b=2):
    return [_fake_batch(b=b, seed=i) for i in range(n)]


def _assert_grads_close(got_tree, want_tree, rel=1e-4):
    want = {p: w for p, w in tree.flatten(jax.tree.map(np.asarray, want_tree))
            if w is not None}
    got = {p: g for p, g in tree.flatten(got_tree) if g is not None}
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, w in want.items():
        g = got[path].numpy()
        scale = np.abs(w).max()
        assert scale > 0, path
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale,
                                   err_msg=str(path))


def _np_quant_policy(base, seed_b=5, b_std=0.05, vocab_table=False):
    """LLAVA_TINY quantized by the reference, then LoRA r=4 (bf16 factors on
    a quantized base) with a perturbed lora_b, as numpy arrays."""
    from halva_tpu.ops import quant as jquant
    from halva_tpu.ops.w4_matmul import quantize_params_int4_host

    t = jax_tree(CFG)
    if vocab_table:  # >= 4096 rows: the int8 pass quantizes the table
        t["llm"]["embed"]["embedding"] = np.random.RandomState(3).randn(
            4096, CFG.llm.hidden_size).astype(np.float32) * 0.02
    if base.startswith("int4"):
        q = jax.tree.map(jnp.asarray, quantize_params_int4_host(
            t, group_size=32 if base == "int4g" else None))
    else:
        q = jquant.quantize_params(jax.tree.map(jnp.asarray, t),
                                   bits=4 if base == "nf4" else 8)
    lp = jlora.add_lora(q, jax.random.PRNGKey(1), rank=4, alpha=8)
    rng = np.random.RandomState(seed_b)
    for _, p in jlora._iter_dense(lp):
        if "lora_b" in p:
            p["lora_b"] = jnp.asarray(
                rng.randn(*p["lora_b"].shape) * b_std, p["lora_b"].dtype)
    return jax.tree.map(np.asarray, lp)


def _quant_micro_step(np_lp):
    kw = dict(grad_accum_steps=1, num_train_steps=10, remat=True,
              loss_chunk=8)
    batch = _batches()[0]
    jt, jf, _, jstep, _ = _jax_state(np_lp, **kw)
    _, jparts, jg = jax.jit(jstep.loss_and_grads)(
        jt, jf, None, {k: jnp.asarray(v) for k, v in batch.items()})
    tt, tf, _, tstep, _ = _torch_state(np_lp, **kw)
    _, tparts, tg = tstep.loss_and_grads(
        tt, tf, None, {k: torch.from_numpy(v) for k, v in batch.items()})
    return tparts, jparts, tg, jg


@pytest.mark.parametrize("base", ["int8", "nf4", "int4", "int4g"])
def test_quantized_base_micro_step_matches_reference(base):
    np_lp = _np_quant_policy(base)
    leaf = {"int8": "kernel_q", "nf4": "kernel_q4"}.get(base, "kernel_q4p")
    wq = np_lp["llm"]["layers"]["attn"]["wq"]
    assert leaf in wq and wq["lora_a"].dtype.name == "bfloat16"
    assert "embedding" in np_lp["llm"]["embed"]  # float table: fp32 LLM
    tparts, jparts, tg, jg = _quant_micro_step(np_lp)
    rtol = 2e-3 if base == "int8" else 1e-4
    for got, want in zip(tparts, jparts):
        np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    assert float(tparts.divergence) > 0
    got = tree.map_tree(lambda g: None if g is None else g.float(), tg)
    _assert_grads_close(got, jax.tree.map(
        lambda g: np.asarray(g, np.float32), jg), rel=2**-7)


@pytest.mark.parametrize("base", ["int8", "int4g"])
def test_quantized_base_with_int8_embedding_micro_step(base):
    """The vocab-sized table is int8, so the LLM runs in bf16."""
    np_lp = _np_quant_policy(base, vocab_table=True)
    assert "embedding_q" in np_lp["llm"]["embed"]
    tparts, jparts, tg, jg = _quant_micro_step(np_lp)
    for got, want in zip(tparts, jparts):
        np.testing.assert_allclose(float(got), float(want), rtol=5e-2)
    want = np.concatenate([np.asarray(g, np.float32).ravel() for _, g in
                           tree.flatten(jax.tree.map(np.asarray, jg))
                           if g is not None])
    got = np.concatenate([g.float().numpy().ravel() for _, g in
                          tree.flatten(tg) if g is not None])
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 0.15, rel


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("chunk", [None, 8])
def test_loss_parts_and_lora_grads_match_reference(remat, chunk):
    np_lp = _np_policy()
    kw = dict(grad_accum_steps=1, num_train_steps=10, remat=remat,
              loss_chunk=chunk)
    batch = _batches()[0]
    jt, jf, _, jstep, _ = _jax_state(np_lp, **kw)
    jl, jparts, jg = jax.jit(jstep.loss_and_grads)(
        jt, jf, None, {k: jnp.asarray(v) for k, v in batch.items()})
    tt, tf, _, tstep, _ = _torch_state(np_lp, **kw)
    tl, tparts, tg = tstep.loss_and_grads(
        tt, tf, None, {k: torch.from_numpy(v) for k, v in batch.items()})
    for got, want in zip(tparts, jparts):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(tparts.divergence) > 0
    _assert_grads_close(tg, jg)


def test_eval_loss_matches_reference():
    np_lp = _np_policy()
    kw = dict(grad_accum_steps=1, num_train_steps=10, loss_chunk=8)
    batch = _batches()[0]
    jt, jf, _, _, jeval = _jax_state(np_lp, **kw)
    want = jax.jit(jeval)(jt, jf, None,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    tt, tf, _, _, teval = _torch_state(np_lp, **kw)
    got = teval(tt, tf, None, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    assert not got.loss.requires_grad


@pytest.mark.parametrize("sched", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("steps,warmup", [(400, 0.03), (10, 0.3), (1, 0.03)])
def test_lr_schedule_matches_optax(sched, steps, warmup):
    kw = dict(lr_schedule=sched, num_train_steps=steps, warmup_ratio=warmup)
    want = jtrainer.lr_schedule(jtrainer.TrainConfig(**kw), 5e-6)
    got = trainer.lr_schedule(trainer.TrainConfig(**kw), 5e-6)
    counts = list(range(0, steps + 3)) + [steps * 2]
    np.testing.assert_allclose([got(n) for n in counts],
                               [float(want(n)) for n in counts],
                               rtol=1e-6, atol=1e-6 * 5e-6)
    if sched != "constant":
        assert got(0) == 0.0  # the first update applies lr(0) = 0


def test_four_micro_steps_match_reference():
    """grad_accum_steps=2: micro-steps 1 and 3 apply updates 1 (lr(0) = 0,
    the moments still move) and 2; the LoRA params after them against the
    reference's jitted train step on the same batches."""
    np_lp = _np_policy()
    lr = 1e-3
    kw = dict(learning_rate=lr, grad_accum_steps=2, num_train_steps=10,
              warmup_ratio=0.1, loss_chunk=8)
    batches = _batches(4)
    jt, jf, jst, jstep, _ = _jax_state(np_lp, **kw)
    jstep = jax.jit(jstep)
    tt, tf, tst, tstep, _ = _torch_state(np_lp, **kw)
    norms = []
    for batch in batches:
        jt, jst, jm = jstep(jt, jf, None, jst,
                            {k: jnp.asarray(v) for k, v in batch.items()})
        tt, tst, tm = tstep(tt, tf, None, tst,
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
        norms.append((float(tm.grad_norm), float(jm.grad_norm)))
        for g, w in zip(tm, jm):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-4)
    assert tst.updates == 2
    want = {p: w for p, w in tree.flatten(jax.tree.map(np.asarray, jt))
            if w is not None}
    moved = 0
    for path, g in tree.flatten(tt):
        if g is None:
            continue
        init = np.asarray(dict(tree.flatten(np_lp))[path])
        np.testing.assert_allclose(g.detach().numpy(), want[path], rtol=0,
                                   atol=lr / 10, err_msg=str(path))
        moved += int(np.abs(want[path] - init).max() > lr / 2)
    assert moved > 0  # the second update moved the params by ~lr
    assert all(n[0] > 0 for n in norms)


def test_only_lora_leaves_change():
    np_lp = _np_policy()
    kw = dict(learning_rate=1e-2, grad_accum_steps=1, num_train_steps=10)
    tt, tf, tst, tstep, _ = _torch_state(np_lp, **kw)
    params = trainer.combine_params(tt, tf)
    before = {p: t.detach().clone() for p, t in tree.flatten(params)}
    batch = {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    for _ in range(2):  # update 1 applies lr(0) = 0
        tt, tst, _ = tstep(tt, tf, None, tst, batch)
    changed = {p for p, t in tree.flatten(params)
               if not torch.equal(t.detach(), before[p])}
    assert changed
    assert all(p[-1] in ("lora_a", "lora_b") for p in changed), changed


def test_projector_group_updates_under_mm_projector_lr():
    np_lp = _np_policy()
    kw = dict(learning_rate=1e-3, mm_projector_lr=1e-2, grad_accum_steps=1,
              num_train_steps=10, warmup_ratio=0.1)
    jt, jf, jst, jstep, _ = _jax_state(np_lp, **kw)
    tt, tf, tst, tstep, _ = _torch_state(np_lp, **kw)
    assert len(tst.adamw.param_groups) == 2
    proj = tt["projector"]["layers"][0]["kernel"]
    start = proj.detach().clone()
    batch = _batches()[0]
    overrides = {"projector": tree.to_torch(jax.tree.map(
        np.array, np_lp["projector"]), device="cpu")}
    joverrides = jax.tree.map(jnp.asarray, {"projector": np_lp["projector"]})
    for _ in range(2):
        jt, jst, _ = jax.jit(jstep)(
            jt, jf, joverrides, jst,
            {k: jnp.asarray(v) for k, v in batch.items()})
        tt, tst, _ = tstep(tt, tf, overrides, tst,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    moved = float((proj.detach() - start).abs().max())
    assert 1e-3 < moved <= 1.5e-2  # one update at the projector's lr
    np.testing.assert_allclose(
        proj.detach().numpy(),
        np.asarray(jt["projector"]["layers"][0]["kernel"]), rtol=0,
        atol=1e-3)
    with pytest.raises(ValueError, match="projector"):
        trainer.ref_model_tree(tf, None)  # the projector is trainable


def test_ref_model_tree_keeps_lone_lora_scale():
    np_lp = _np_policy()
    tt, tf, _, _, _ = _torch_state(np_lp, grad_accum_steps=1)
    ref = trainer.ref_model_tree(tf, None)
    wq = ref["llm"]["layers"]["attn"]["wq"]
    assert "lora_scale" in wq and "lora_a" not in wq
    assert wq["kernel"] is tf["llm"]["layers"]["attn"]["wq"]["kernel"]
    base = tree.to_torch(jax_tree(CFG), device="cpu")
    ids = torch.from_numpy(_fake_batch()["input_ids"])
    imgs = torch.from_numpy(_fake_batch()["images"])
    got, _ = llava.forward(ref, port_cfg(CFG), ids, imgs)
    want, _ = llava.forward(base, port_cfg(CFG), ids, imgs)
    assert torch.equal(got, want)


def test_llava_forward_matches_reference():
    np_lp = _np_policy()
    batch = _fake_batch()
    args = ("input_ids", "images", "segment_ids", "labels", "pos_signs")
    want, wsp = jllava.forward(jax.tree.map(jnp.asarray, np_lp), CFG,
                               *(jnp.asarray(batch[a]) for a in args),
                               attn_impl="xla")
    got, sp = llava.forward(tree.to_torch(np_lp, device="cpu"), port_cfg(CFG),
                            *(torch.from_numpy(batch[a]) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for g, w in zip(sp[1:], wsp[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hidden, _ = llava.forward(tree.to_torch(np_lp, device="cpu"), port_cfg(CFG),
                              *(torch.from_numpy(batch[a]) for a in args),
                              return_hidden=True)
    assert hidden.shape == got.shape[:2] + (CFG.llm.hidden_size,)
    with pytest.raises(NotImplementedError, match="item 11"):
        llava.forward(tree.to_torch(np_lp, device="cpu"), port_cfg(CFG),
                      torch.from_numpy(batch["input_ids"]),
                      torch.from_numpy(batch["images"])[:, None])


def test_remat_runs_each_layer_again_in_the_backward(monkeypatch):
    """forward_embeds(remat=True) under autograd: every layer runs once in
    the forward and once more in the backward; without grad, once."""
    from halva_tpu_torch.models import llama

    calls = []
    layer = llama._layer

    def counting(*args):
        calls.append(1)
        return layer(*args)

    monkeypatch.setattr(llama, "_layer", counting)
    np_lp = _np_policy()
    params = tree.to_torch(np_lp, device="cpu")["llm"]
    params["layers"]["attn"]["wq"]["lora_b"].requires_grad_(True)
    x = torch.randn(2, 6, CFG.llm.hidden_size)
    seg = torch.ones(2, 6, dtype=torch.int32)
    pos = torch.arange(6).expand(2, 6)
    out = llama.forward_embeds(params, port_cfg(CFG.llm), x, seg, pos, remat=True)
    assert len(calls) == CFG.llm.num_layers
    out.sum().backward()
    assert len(calls) == 2 * CFG.llm.num_layers
    calls.clear()
    with torch.no_grad():
        again = llama.forward_embeds(params, port_cfg(CFG.llm), x, seg, pos,
                                     remat=True)
    assert len(calls) == CFG.llm.num_layers
    torch.testing.assert_close(again, out.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("what", ["adamw8bit", "mesh", "packed", "sgd"])
def test_unported_options_raise(what):
    np_lp = _np_policy()
    params = tree.to_torch(np_lp, device="cpu")
    if what == "adamw8bit":
        with pytest.raises(NotImplementedError, match="item 8"):
            trainer.init_train_state(params,
                                     trainer.TrainConfig(optim="adamw8bit"))
    elif what == "sgd":
        with pytest.raises(ValueError, match="unknown optim"):
            trainer.init_train_state(params, trainer.TrainConfig(optim="sgd"))
    elif what == "mesh":
        _, _, opt, _ = trainer.init_train_state(params, trainer.TrainConfig())
        with pytest.raises(NotImplementedError, match="item 10"):
            trainer.dpa_step_fns(port_cfg(CFG), trainer.TrainConfig(), opt,
                                 mesh=object())
    else:
        with pytest.raises(NotImplementedError, match="item 8"):
            trainer.packed_dpa_step_fns(port_cfg(CFG), trainer.TrainConfig(), None, 4)


def test_train_config_fields_and_defaults_match_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(trainer.TrainConfig) == fields(jtrainer.TrainConfig)
