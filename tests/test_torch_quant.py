"""int8 and int4 weight quantization in the port (halva_tpu_torch/ops/
quant.py, ops/w4_matmul.py) against the reference's host quantizers and its
int8 / int4 matmuls, on the same seeded inputs.

Tolerances: the quantizers are bit-exact (same keys, int8 bytes and bf16
scale bits; both round half to even). The W8A8 / W4A8 products accumulate
exactly in int32 on both sides and rescale in fp32 in the same order, so
fp32 outputs agree to rtol = atol = 1e-6; bf16 outputs to one bf16 step
(rtol 2^-7). The embedding lookup is exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.ops import quant as jquant
from halva_tpu.ops import w4_matmul as jw4
from halva_tpu_torch import tree
from halva_tpu_torch.ops import quant, w4_matmul

from test_torch_tree import jax_tree

torch.set_num_threads(2)

F32 = dict(rtol=1e-6, atol=1e-6)
BF16_STEP = dict(rtol=2**-7, atol=1e-6)


def _tree_with_vocab_table():
    """LLAVA_TINY with a (4096, 8) embedding table, so that the int8 pass
    makes `embedding_q` (tables under 4096 rows stay float)."""
    t = jax_tree(LLAVA_TINY)
    t["llm"]["embed"]["embedding"] = np.random.RandomState(0).randn(
        4096, 8).astype(np.float32)
    return t


def _assert_trees_bit_equal(want, got):
    wl, gl = dict(tree.flatten(want)), dict(tree.flatten(got))
    assert sorted(gl, key=str) == sorted(wl, key=str)
    for path, w in wl.items():
        w, g = np.asarray(w), gl[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("group_size", [None, 32])
def test_quantize_params_int4_bit_exact(group_size):
    t = _tree_with_vocab_table()
    want = jw4.quantize_params_int4_host(t, group_size=group_size)
    got = tree.to_numpy(w4_matmul.quantize_params_int4(
        tree.to_torch(t, device="cpu"), group_size=group_size))
    _assert_trees_bit_equal(want, got)
    llm, vis = got["llm"], got["vision"]
    assert "embedding_q" in llm["embed"] and "kernel_q" in llm["lm_head"]
    assert "kernel_q4p" in llm["layers"]["mlp"]["down"]
    assert "kernel_q" in got["projector"]["layers"][0]
    # sibling leaves survive: the vision stacks keep their biases
    wq = vis["layers"]["attn"]["wq"]
    assert {"kernel_q4p", "kernel_scale4p", "bias"} == set(wq)
    np.testing.assert_array_equal(wq["bias"],
                                  t["vision"]["layers"]["attn"]["wq"]["bias"])
    if group_size:  # K = 64 and 128 both split into groups of 32
        assert llm["layers"]["mlp"]["down"]["kernel_scale4p"].shape[2] == 4


def test_quantize_params_int8_bit_exact():
    t = _tree_with_vocab_table()
    want = jquant.quantize_params_host(t)
    got = tree.to_numpy(quant.quantize_params(tree.to_torch(t, device="cpu")))
    _assert_trees_bit_equal(want, got)


def test_int4_group_size_that_does_not_divide_falls_back():
    w = np.random.RandomState(1).randn(2, 48, 16).astype(np.float32)
    t = {"layers": {"kernel": w}}
    got = w4_matmul.quantize_params_int4(tree.to_torch(t, device="cpu"), group_size=32)
    want = jw4.quantize_params_int4_host(t, group_size=32)
    assert got["layers"]["kernel_scale4p"].shape == (2, 2, 1, 8)
    _assert_trees_bit_equal(want, tree.to_numpy(got))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        w4_matmul.quantize_params_int4(tree.to_torch(t, device="cpu"), tp=2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_dense_matches_reference(dtype):
    rng = np.random.RandomState(2)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    w = rng.randn(64, 48).astype(np.float32)
    x = np.array(jnp.asarray(rng.randn(3, 5, 64), jdt))
    x[0, 0] = 0  # an all-zero row quantizes with scale 1
    q = jquant.quantize_kernel(jnp.asarray(w))
    want = jquant.int8_dense(jnp.asarray(x), q["kernel_q"], q["kernel_scale"])
    qt = tree.to_torch(jax.tree.map(np.asarray, q), device="cpu")
    got = quant.int8_dense(tree.to_torch([x], device="cpu")[0], qt["kernel_q"],
                           qt["kernel_scale"])
    assert got.shape == (3, 5, 48)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32 if dtype == "f32" else BF16_STEP))
    np.testing.assert_array_equal(
        quant.dequantize_kernel(qt, torch.float32).numpy(),
        np.asarray(jquant.dequantize_kernel(q, jnp.float32)))
    w8 = quant.w8_dense(tree.to_torch([x], device="cpu")[0], qt["kernel_q"],
                        qt["kernel_scale"])
    want8 = jquant.w8_dense(jnp.asarray(x), q["kernel_q"], q["kernel_scale"])
    np.testing.assert_allclose(w8.float().numpy(),
                               np.asarray(want8, np.float32),
                               **(dict(rtol=1e-5, atol=1e-5) if dtype == "f32"
                                  else dict(rtol=2**-6, atol=2e-2)))


@pytest.mark.parametrize("group_size", [None, 32])
def test_w4a8_dense_matches_reference(group_size):
    rng = np.random.RandomState(3)
    w = rng.randn(1, 64, 40).astype(np.float32)
    x = rng.randn(2, 7, 64).astype(np.float32)
    q = jw4.quantize_kernel_int4_stacked_host(w, group_size=group_size)
    want = jw4.w4a8_dense(jnp.asarray(x), jnp.asarray(q["kernel_q4p"][0]),
                          jnp.asarray(q["kernel_scale4p"][0]))
    qt = tree.to_torch(q, device="cpu")
    got = w4_matmul.w4a8_dense(torch.from_numpy(x), qt["kernel_q4p"][0],
                               qt["kernel_scale4p"][0])
    assert qt["kernel_scale4p"].shape[2] == (1 if group_size is None else 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_embed_lookup_matches_reference():
    t = _tree_with_vocab_table()
    p = jquant.quantize_params_host(t)["llm"]["embed"]
    ids = np.random.RandomState(4).randint(0, 4096, (3, 9)).astype(np.int32)
    want = jquant.embed_lookup(jax.tree.map(jnp.asarray, p), jnp.asarray(ids))
    got = quant.embed_lookup(tree.to_torch(p, device="cpu"), torch.from_numpy(ids).long())
    assert got.dtype == torch.bfloat16  # whatever the tree's dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    plain = quant.embed_lookup(tree.to_torch(t["llm"]["embed"], device="cpu"),
                               torch.from_numpy(ids).long())
    np.testing.assert_array_equal(plain.numpy(),
                                  t["llm"]["embed"]["embedding"][ids])


def test_switches_default_and_set(monkeypatch):
    monkeypatch.setattr(quant, "_W8A8", None)
    monkeypatch.setattr(quant, "_W4A8", None)
    monkeypatch.delenv("HALVA_W8A8", raising=False)
    monkeypatch.delenv("HALVA_W4A8", raising=False)
    assert quant.w8a8_enabled() and not quant.w4a8_enabled()
    quant.set_w4a8(True)
    quant.set_w8a8(False)
    assert quant.w4a8_enabled() and not quant.w8a8_enabled()
    monkeypatch.setattr(quant, "_W8A8", None)
    monkeypatch.setenv("HALVA_W8A8", "0")
    assert not quant.w8a8_enabled()
