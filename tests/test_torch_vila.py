"""The port's VILA path against the JAX package, fp32, tiny widths, the same
seeded weights and numpy inputs in both:

- `projector.downsample_2x2` on even grids (exact: a reshape), and on odd
  grids against the reference's fold of the same grid zero-padded to the
  next even side (VILA's DownSampleBlock pads so; the reference's fold
  raises there: on `VILA_13B_384`'s 27 x 27 grid, its `TypeError` is the
  reference fault of ROADMAP queue 3, and the port counts 196 image tokens
  where the reference counts 182);
- the mlp_downsample projector (1e-5);
- `splice_image_tokens_multi` with 0..K images a row (integer fields
  exact, embeds 1e-6), and `forward` with (B, K, 3, H, W) images (1e-4, as
  tests/test_torch_llava.py's logits);
- a tiny VILA (a SigLIP-like tower on a 4 x 4 grid, mlp_downsample,
  LLAVA_TINY's LLM): greedy decode and 2-beam search token for token, one
  DPA micro-step's loss parts (rtol 1e-5), LoRA grads and projector grads
  (within 1e-4 of each leaf's largest |grad|) with the projector trainable,
  as VILA's recipe trains it.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY, VILA_13B_384, ViTConfig
from halva_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from halva_tpu.models import llava as jllava
from halva_tpu.models import projector as jprojector
from halva_tpu.ops import beam as jbeam
from halva_tpu.ops import generate as jgenerate
from halva_tpu.train import lora as jlora
from halva_tpu.train import trainer as jtrainer
from halva_tpu_torch import config as tconfig
from halva_tpu_torch import tree
from halva_tpu_torch.models import llava, projector
from halva_tpu_torch.ops import beam, generate
from halva_tpu_torch.train import trainer

from test_torch_tree import jax_tree, port_cfg, shared_trees
from test_trainer import _fake_batch

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)

SIGLIP_56 = ViTConfig(
    image_size=56, patch_size=14, hidden_size=32, intermediate_size=64,
    num_layers=2, num_heads=2, layer_norm_eps=1e-6, use_cls_token=False,
    use_pre_layernorm=False, hidden_act="gelu_tanh")
VILA_TINY = dataclasses.replace(LLAVA_TINY, vision=SIGLIP_56,
                                mm_projector_type="mlp_downsample")
MAX_NEW = 10


@pytest.mark.parametrize("side,factor", [(2, 2), (4, 2), (6, 2), (6, 3),
                                         (8, 4)])
def test_downsample_on_even_grids_is_the_reference(side, factor):
    x = np.random.RandomState(side).randn(2, side * side, 5).astype(
        np.float32)
    want = jprojector.downsample_2x2(jnp.asarray(x), factor)
    got = projector.downsample_2x2(torch.from_numpy(x), factor)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("side,factor", [(3, 2), (5, 2), (27, 2), (7, 3),
                                         (5, 4)])
def test_downsample_on_odd_grids_is_the_reference_on_the_padded_grid(
        side, factor):
    """The port zero-pads the last rows and columns to the next multiple
    of the factor, then folds: the reference's fold of that padded grid."""
    d = 4
    x = np.random.RandomState(side).randn(2, side, side, d).astype(
        np.float32)
    out = -(-side // factor)
    padded = np.zeros((2, out * factor, out * factor, d), np.float32)
    padded[:, :side, :side] = x
    want = jprojector.downsample_2x2(
        jnp.asarray(padded.reshape(2, -1, d)), factor)
    got = projector.downsample_2x2(torch.from_numpy(x.reshape(2, -1, d)),
                                   factor)
    assert got.shape == (2, out * out, factor * factor * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_downsample_refuses_a_grid_that_is_no_square():
    with pytest.raises(ValueError, match="no square"):
        projector.downsample_2x2(torch.zeros(1, 12, 3))


def test_the_reference_cannot_fold_the_vila_13b_grid():
    """ROADMAP queue 3's reference behaviour: SigLIP-384/14's 27 x 27 grid
    under VILA_13B_384's mlp_downsample. The reference's fold raises and its
    count, 729 // 4 = 182, is no fold's; the port pads and counts 14 x 14."""
    side = VILA_13B_384.vision.image_size // VILA_13B_384.vision.patch_size
    assert side == 27
    x = jnp.zeros((1, side * side, 4))
    with pytest.raises(TypeError, match=re.escape("(1, 13, 2, 13, 2, 4)")):
        jprojector.downsample_2x2(x, VILA_13B_384.downsample_factor)
    assert VILA_13B_384.num_image_tokens == 182
    assert tconfig.VILA_13B_384.num_image_tokens == 196
    got = projector.downsample_2x2(torch.zeros(1, side * side, 4))
    assert got.shape == (1, 196, 16)


def test_num_image_tokens_is_the_references_on_even_grids():
    for cfg in (VILA_TINY,
                dataclasses.replace(VILA_TINY, downsample_factor=4),
                dataclasses.replace(LLAVA_TINY,
                                    mm_projector_type="mlp_downsample")):
        assert port_cfg(cfg).num_image_tokens == cfg.num_image_tokens


def test_mlp_downsample_projector_is_the_reference():
    params = jprojector.init_params(jax.random.PRNGKey(2), VILA_TINY)
    feats = np.random.RandomState(3).randn(
        2, SIGLIP_56.num_patches, SIGLIP_56.hidden_size).astype(np.float32)
    want = jprojector.apply(params, VILA_TINY, jnp.asarray(feats))
    got = projector.apply(tree.to_torch(jax.tree.map(np.asarray, params),
                                        device="cpu"),
                          port_cfg(VILA_TINY), torch.from_numpy(feats))
    assert got.shape == (2, VILA_TINY.num_image_tokens,
                         VILA_TINY.llm.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _multi_rows(k):
    """Rows with 0..k sentinels (none with more), padding on some; labels
    and signs set."""
    rng = np.random.RandomState(4)
    b, s = 5, 14
    ids = rng.randint(3, 200, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    sentinels = {0: [1, 6], 1: [], 2: [0, 4, 9], 3: [3], 4: [2, 3]}
    for r, cols in sentinels.items():
        ids[r, cols[:k]] = IMAGE_TOKEN_INDEX
    seg[1, 10:] = 0
    seg[3, 7:] = 0
    seg[4, 12:] = 0
    ids[seg == 0] = 0
    labels = rng.randint(0, 200, (b, s)).astype(np.int32)
    labels[seg == 0] = IGNORE_INDEX
    signs = rng.randint(-1, 2, (b, s)).astype(np.int32)
    return ids, seg, labels, signs


@pytest.mark.parametrize("k", [1, 2, 3])
def test_splice_multi_is_the_reference(k):
    jp, tp = shared_trees()
    ids, seg, labels, signs = _multi_rows(k)
    t = LLAVA_TINY.num_image_tokens
    feats = np.random.RandomState(k).randn(
        ids.shape[0], k, t, LLAVA_TINY.llm.hidden_size).astype(np.float32)
    want = jllava.splice_image_tokens_multi(
        jp, LLAVA_TINY, *(jnp.asarray(a) for a in
                          (ids, feats, seg, labels, signs)))
    got = llava.splice_image_tokens_multi(
        tp, port_cfg(LLAVA_TINY), *(torch.from_numpy(a) for a in
                                    (ids, feats, seg, labels, signs)))
    assert got.embeds.shape == (ids.shape[0], ids.shape[1] + k * (t - 1),
                                LLAVA_TINY.llm.hidden_size)
    np.testing.assert_allclose(got.embeds.numpy(), np.asarray(want.embeds),
                               rtol=0, atol=1e-6)
    for field in ("labels", "signs", "segment_ids", "positions"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.int32, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    # a row with fewer than k sentinels parks its missing blocks, masked,
    # right after its content: its valid length is text + real blocks
    for r in range(ids.shape[0]):
        n = int((ids[r] == IMAGE_TOKEN_INDEX).sum())
        real = int(seg[r].sum())
        assert int((got.segment_ids[r] != 0).sum()) == real + n * (t - 1)


def test_splice_multi_with_defaults_is_the_reference():
    jp, tp = shared_trees()
    ids, _, _, _ = _multi_rows(2)
    t = LLAVA_TINY.num_image_tokens
    feats = np.random.RandomState(9).randn(
        ids.shape[0], 2, t, LLAVA_TINY.llm.hidden_size).astype(np.float32)
    want = jllava.splice_image_tokens_multi(jp, LLAVA_TINY, jnp.asarray(ids),
                                            jnp.asarray(feats))
    got = llava.splice_image_tokens_multi(tp, port_cfg(LLAVA_TINY),
                                          torch.from_numpy(ids),
                                          torch.from_numpy(feats))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("cfg", [LLAVA_TINY, VILA_TINY],
                         ids=["llava_tiny", "vila_tiny"])
def test_forward_with_multi_image_rows_is_the_reference(cfg):
    jp, tp = shared_trees(cfg)
    ids, seg, labels, signs = _multi_rows(2)
    size = cfg.vision.image_size
    imgs = np.random.RandomState(5).randn(ids.shape[0], 2, 3, size,
                                          size).astype(np.float32)
    want, wsp = jllava.forward(jp, cfg, jnp.asarray(ids), jnp.asarray(imgs),
                               jnp.asarray(seg), jnp.asarray(labels),
                               jnp.asarray(signs), attn_impl="xla")
    got, sp = llava.forward(tp, port_cfg(cfg), torch.from_numpy(ids),
                            torch.from_numpy(imgs), torch.from_numpy(seg),
                            torch.from_numpy(labels), torch.from_numpy(signs))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for g, w in zip(sp[1:], wsp[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _vila_inputs():
    rng = np.random.RandomState(5)
    b, s = 4, 16
    ids = rng.randint(3, 250, (b, s)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    lens = np.array([16, 9, 0, 12], np.int32)  # row 2 is a dead row
    for r, n in enumerate(lens):
        ids[r, n:] = 0
    size = SIGLIP_56.image_size
    imgs = rng.randn(b, 3, size, size).astype(np.float32)
    return ids, imgs, lens


@pytest.mark.parametrize("kv_quant", [False, "int4"])
def test_tiny_vila_greedy_token_exact(kv_quant):
    jp, tp = shared_trees(VILA_TINY)
    ids, imgs, lens = _vila_inputs()
    want_tok, want_num = jgenerate.generate_greedy(
        jp, VILA_TINY, jnp.asarray(ids), jnp.asarray(imgs),
        jnp.asarray(lens), max_new_tokens=MAX_NEW, eos_id=-1,
        kv_quant=kv_quant)
    with torch.inference_mode():
        got_tok, got_num = generate.generate_greedy(
            tp, port_cfg(VILA_TINY), torch.from_numpy(ids),
            torch.from_numpy(imgs), torch.from_numpy(lens),
            max_new_tokens=MAX_NEW, eos_id=-1, kv_quant=kv_quant)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_num.numpy(), np.asarray(want_num))


def test_tiny_vila_beams_token_exact():
    jp, tp = shared_trees(VILA_TINY)
    ids, imgs, lens = _vila_inputs()
    want_tok, want_num = jbeam.generate_beam(
        jp, VILA_TINY, jnp.asarray(ids), jnp.asarray(imgs),
        jnp.asarray(lens), max_new_tokens=MAX_NEW, eos_id=-1, num_beams=2,
        attn_impl="xla")
    with torch.inference_mode():
        got_tok, got_num = beam.generate_beam(
            tp, port_cfg(VILA_TINY), torch.from_numpy(ids),
            torch.from_numpy(imgs), torch.from_numpy(lens),
            max_new_tokens=MAX_NEW, eos_id=-1, num_beams=2)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_num.numpy(), np.asarray(want_num))


@pytest.mark.parametrize("chunk", [None, 8])
def test_tiny_vila_dpa_micro_step_matches_reference(chunk):
    """VILA's recipe trains LoRA on the LLM and the whole projector; the
    frozen reference model keeps the projector's initial copy
    (ref_params), in both packages."""
    cfg = VILA_TINY
    params = jax.tree.map(jnp.asarray, jax_tree(cfg))
    lp = jlora.add_lora(params, jax.random.PRNGKey(1), rank=4, alpha=8)
    rng = np.random.RandomState(5)
    for _, p in jlora._iter_dense(lp):
        if "lora_b" in p:
            p["lora_b"] = jnp.asarray(
                rng.randn(*p["lora_b"].shape).astype(np.float32) * 0.05)
    np_lp = jax.tree.map(np.array, lp)
    ref_proj = jax.tree.map(np.array, np_lp["projector"])
    # the policy's projector moved away from the reference's copy
    for layer in np_lp["projector"]["layers"]:
        layer["bias"] = rng.randn(*layer["bias"].shape).astype(
            np.float32) * 0.05
    kw = dict(grad_accum_steps=1, num_train_steps=10, remat=True,
              loss_chunk=chunk)
    batch = _fake_batch(b=2, seed=0)
    size = SIGLIP_56.image_size
    for key in ("images", "ref_images"):
        batch[key] = rng.randn(2, 3, size, size).astype(np.float32)
    extra = (r"^projector/",)

    jcfg = jtrainer.TrainConfig(attn_impl="xla", **kw)
    jt, jf, jopt, _ = jtrainer.init_train_state(
        jax.tree.map(jnp.asarray, np_lp), jcfg, extra_trainable=extra)
    jstep, _ = jtrainer.dpa_step_fns(cfg, jcfg, jopt)
    _, jparts, jg = jax.jit(jstep.loss_and_grads)(
        jt, jf, {"projector": jax.tree.map(jnp.asarray, ref_proj)},
        {k: jnp.asarray(v) for k, v in batch.items()})

    tcfg = trainer.TrainConfig(**kw)
    tt, tf, topt, _ = trainer.init_train_state(
        tree.to_torch(np_lp, device="cpu"), tcfg, extra_trainable=extra)
    tstep, _ = trainer.dpa_step_fns(port_cfg(cfg), tcfg, topt)
    _, tparts, tg = tstep.loss_and_grads(
        tt, tf, {"projector": tree.to_torch(ref_proj, device="cpu")},
        {k: torch.from_numpy(v) for k, v in batch.items()})

    for got, want in zip(tparts, jparts):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(tparts.divergence) > 0
    want = {p: w for p, w in tree.flatten(jax.tree.map(np.asarray, jg))
            if w is not None}
    got = {p: g for p, g in tree.flatten(tg) if g is not None}
    assert sorted(got, key=str) == sorted(want, key=str)
    assert sum(p[0] == "projector" for p in got) == 4  # 2 kernels, 2 biases
    for path, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, path
        np.testing.assert_allclose(got[path].numpy(), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=str(path))
