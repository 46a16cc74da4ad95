"""LLaVA in the port against the reference on LLAVA_TINY fp32 trees: the
CLIP tower, the projectors, image encoding, the image-token splice, and
greedy generation end to end, on the float tree and on the int4g serving
tree (int4 layer stacks with grouped scales, int8 projector and lm_head)
with int4 and int8 KV caches.

Tolerances: fp32 activations rtol = atol = 1e-5 (1e-4 on the int4 tree:
W8A8 quantizes the projector's activations, where a few-ulp input
difference can move one int8 step); the splice's integer fields exactly
equal; greedy tokens and counts exactly equal (mixed prompt lengths, one
dead row, an eos_id that some row hits)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.constants import IMAGE_TOKEN_INDEX
from halva_tpu.models import llava as jllava
from halva_tpu.models import projector as jprojector
from halva_tpu.models import vit as jvit
from halva_tpu.ops import generate as jgenerate
from halva_tpu.ops.w4_matmul import quantize_params_int4_host
from halva_tpu_torch import tree
from halva_tpu_torch.models import llava, projector, vit
from halva_tpu_torch.ops import generate

from test_torch_tree import jax_tree, port_cfg, shared_trees

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)


def _images(b, seed=0):
    size = LLAVA_TINY.vision.image_size
    return np.random.RandomState(seed).randn(b, 3, size, size).astype(
        np.float32)


def test_vit_encode():
    jp, tp = shared_trees()
    imgs = _images(3)
    want = jvit.encode(jp["vision"], LLAVA_TINY.vision, jnp.asarray(imgs))
    got = vit.encode(tp["vision"], port_cfg(LLAVA_TINY.vision), torch.from_numpy(imgs))
    assert got.shape == (3, LLAVA_TINY.vision.num_patches,
                         LLAVA_TINY.vision.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("ptype", ["linear", "mlp2x_gelu", "mlp3x_gelu",
                                   "identity"])
def test_projector_apply(ptype):
    cfg = dataclasses.replace(LLAVA_TINY, mm_projector_type=ptype)
    params = jprojector.init_params(jax.random.PRNGKey(2), cfg)
    np_params = jax.tree.map(np.asarray, params)
    feats = np.random.RandomState(3).randn(2, 4, 32).astype(np.float32)
    want = jprojector.apply(params, cfg, jnp.asarray(feats))
    got = projector.apply(tree.to_torch(np_params, device="cpu"), port_cfg(cfg),
                          torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_encode_images():
    jp, tp = shared_trees()
    imgs = _images(2, seed=1)
    want = jllava.encode_images(jp, LLAVA_TINY, jnp.asarray(imgs))
    got = llava.encode_images(tp, port_cfg(LLAVA_TINY), torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_splice_image_tokens():
    jp, tp = shared_trees()
    rng = np.random.RandomState(4)
    b, s, t = 4, 12, LLAVA_TINY.num_image_tokens
    ids = rng.randint(3, 200, (b, s)).astype(np.int32)
    ids[0, 0] = IMAGE_TOKEN_INDEX
    ids[1, 5] = IMAGE_TOKEN_INDEX
    ids[3, 7] = IMAGE_TOKEN_INDEX  # row 2 has no image
    seg = np.ones((b, s), np.int32)
    seg[1, 9:] = 0
    seg[2, 6:] = 0
    seg[3, 10:] = 0
    labels = rng.randint(0, 200, (b, s)).astype(np.int32)
    signs = rng.randint(-1, 2, (b, s)).astype(np.int32)
    feats = rng.randn(b, t, LLAVA_TINY.llm.hidden_size).astype(np.float32)
    want = jllava.splice_image_tokens(
        jp, LLAVA_TINY, jnp.asarray(ids), jnp.asarray(feats),
        jnp.asarray(seg), jnp.asarray(labels), jnp.asarray(signs))
    got = llava.splice_image_tokens(
        tp, port_cfg(LLAVA_TINY), torch.from_numpy(ids), torch.from_numpy(feats),
        torch.from_numpy(seg), torch.from_numpy(labels),
        torch.from_numpy(signs))
    assert got._fields == want._fields
    np.testing.assert_allclose(got.embeds.numpy(), np.asarray(want.embeds),
                               rtol=0, atol=0)
    for field in ("labels", "signs", "segment_ids", "positions"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.int32, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)


def _generate_inputs():
    rng = np.random.RandomState(5)
    b, s = 4, 16
    ids = rng.randint(3, 250, (b, s)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    lens = np.array([16, 9, 0, 12], np.int32)  # row 2 is a dead row
    for r, n in enumerate(lens):
        ids[r, n:] = 0
    return ids, _images(b, seed=6), lens


def test_generate_greedy_token_exact():
    jp, tp = shared_trees()
    ids, imgs, lens = _generate_inputs()
    max_new = 10

    def run_jax(eos):
        tok, num = jgenerate.generate_greedy(
            jp, LLAVA_TINY, jnp.asarray(ids), jnp.asarray(imgs),
            jnp.asarray(lens), max_new_tokens=max_new, eos_id=eos)
        return np.asarray(tok), np.asarray(num)

    # an eos_id that row 0 really emits, mid-sequence: its first token
    # after step 0 that it has not emitted before
    free, _ = run_jax(-1)
    hit = next(i for i in range(1, max_new)
               if free[0, i] not in free[0, :i])
    eos = int(free[0, hit])
    want_tok, want_num = run_jax(eos)
    assert want_tok[0, hit] == eos and want_num[0] == hit

    with torch.inference_mode():
        got_tok, got_num = generate.generate_greedy(
            tp, port_cfg(LLAVA_TINY), torch.from_numpy(ids), torch.from_numpy(imgs),
            torch.from_numpy(lens), max_new_tokens=max_new, eos_id=eos)
    assert got_tok.dtype == torch.int32
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_array_equal(got_num.numpy(), want_num)
    assert want_num[2] == 0  # the dead row emits nothing


def test_prefill_first_token_and_cache_layout():
    jp, tp = shared_trees()
    ids, imgs, lens = _generate_inputs()
    want = jgenerate._prefill_phase(
        jp, LLAVA_TINY, jnp.asarray(ids), jnp.asarray(imgs),
        jnp.asarray(lens), 8, "auto")
    got = generate._prefill_impl(
        tp, port_cfg(LLAVA_TINY), torch.from_numpy(ids), torch.from_numpy(imgs),
        torch.from_numpy(lens))
    w_tok, w_logits, w_len, w_cache, w_seg = want
    g_tok, g_logits, g_len, g_cache, g_seg = got
    np.testing.assert_array_equal(g_tok.numpy(), np.asarray(w_tok))
    np.testing.assert_allclose(g_logits.numpy(), np.asarray(w_logits), **F32)
    np.testing.assert_array_equal(g_len.numpy(), np.asarray(w_len))
    np.testing.assert_array_equal(g_seg.numpy(), np.asarray(w_seg))
    assert tuple(g_cache["k"].shape) == w_cache["k"].shape
    assert g_cache["k"].dtype == torch.bfloat16


def int4_trees():
    """(jax tree, torch tree) of the int4g serving tree (group size 32) of
    LLAVA_TINY, lm_head scaled x100 as tests/test_w4.py does, so greedy
    margins dwarf quantization noise."""
    t = jax_tree(LLAVA_TINY)
    t["llm"]["lm_head"]["kernel"] = t["llm"]["lm_head"]["kernel"] * 100.0
    q = quantize_params_int4_host(t, group_size=32)
    return jax.tree.map(jnp.asarray, q), tree.to_torch(q, device="cpu")


def test_encode_images_int4_tree():
    jp, tp = int4_trees()
    assert "kernel_q4p" in tp["vision"]["layers"]["mlp"]["fc1"]
    assert "kernel_q" in tp["projector"]["layers"][0]
    imgs = _images(2, seed=1)
    want = jllava.encode_images(jp, LLAVA_TINY, jnp.asarray(imgs))
    got = llava.encode_images(tp, port_cfg(LLAVA_TINY), torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kv_quant", ["int4", "int8"])
def test_generate_greedy_int4_tree_token_exact(kv_quant):
    jp, tp = int4_trees()
    ids, imgs, lens = _generate_inputs()
    lens = lens.copy()
    lens[3] = 11  # spliced lengths 19 (odd) and 15: the int4 pad slot
    ids[3, 11:] = 0
    want_tok, want_num = jgenerate.generate_greedy(
        jp, LLAVA_TINY, jnp.asarray(ids), jnp.asarray(imgs),
        jnp.asarray(lens), max_new_tokens=10, eos_id=-1, kv_quant=kv_quant)
    with torch.inference_mode():
        got_tok, got_num = generate.generate_greedy(
            tp, port_cfg(LLAVA_TINY), torch.from_numpy(ids), torch.from_numpy(imgs),
            torch.from_numpy(lens), max_new_tokens=10, eos_id=-1,
            kv_quant=kv_quant)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_num.numpy(), np.asarray(want_num))


@pytest.mark.parametrize("kv_quant", [True, "int4"])
def test_prefill_quantized_cache_layout(kv_quant):
    jp, tp = int4_trees()
    ids, imgs, lens = _generate_inputs()
    want = jgenerate._prefill_phase(
        jp, LLAVA_TINY, jnp.asarray(ids), jnp.asarray(imgs),
        jnp.asarray(lens), 8, "auto", kv_quant)
    got = generate._prefill_impl(
        tp, port_cfg(LLAVA_TINY), torch.from_numpy(ids), torch.from_numpy(imgs),
        torch.from_numpy(lens), kv_quant=kv_quant)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    g_cache, w_cache = got[3], want[3]
    assert sorted(g_cache) == sorted(w_cache)
    for key in g_cache:
        assert tuple(g_cache[key].shape) == w_cache[key].shape, key
    gen_cache = generate.init_gen_cache_like(port_cfg(LLAVA_TINY.llm), 4, 8, g_cache)
    want_gen = jgenerate.init_gen_cache_like(LLAVA_TINY.llm, 4, 8, w_cache)
    assert sorted(gen_cache) == sorted(want_gen)
    for key in gen_cache:
        assert tuple(gen_cache[key].shape) == want_gen[key].shape, key
        assert str(gen_cache[key].dtype).split(".")[-1] == str(
            want_gen[key].dtype), key
