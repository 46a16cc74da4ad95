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
    # tensor-parallel packing (an "llm" stack's column-split kernel)
    tl = {"llm": {"layers": {"attn": {"wq": {"kernel": w}}}}}
    got = w4_matmul.quantize_params_int4(tree.to_torch(tl, device="cpu"),
                                         group_size=32, tp=2)
    want = jw4.quantize_params_int4_host(tl, group_size=32, tp=2)
    _assert_trees_bit_equal(want, tree.to_numpy(got))


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


# --------------------------------------------------------------------------
# NF4, and the pinned backwards of the quantized denses.
#
# Tolerances: the NF4 quantizer is index for index and scale bit for bit:
# both sides take the first minimum of |w / scale - code| in fp32 (jnp.argmin
# and torch.argmin share the first-index tie rule; the test plants weights
# at the fp32 midpoints between codes and an all-zero channel beside random
# weights). Forwards and gradients in fp32:
# rtol = atol = 1e-5 (one dequant, one matmul, another summation order); in
# bf16 one bf16 step of the output's scale.
# --------------------------------------------------------------------------

GRAD = dict(rtol=1e-5, atol=1e-5)


def _bf16_close(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    bound = 2**-7 * (np.abs(want) + np.abs(want).max() / 4)
    assert (np.abs(got - want) <= bound).all()


def test_nf4_code_is_the_reference_table():
    assert quant.NF4_CODE == jquant.NF4_CODE and len(quant.NF4_CODE) == 16


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 24)])
def test_quantize_kernel_nf4_bit_exact(shape, monkeypatch):
    rng = np.random.RandomState(5)
    w = rng.randn(*shape).astype(np.float32)
    # ties and near-ties: column 0 has absmax 1, so its normed values are
    # the weights themselves, two of them the fp32 midpoints of codes 14, 15
    # and of codes 7, 8
    col = w[..., 0]
    col[...] = np.clip(col, -0.9, 0.9)
    col[..., 0] = 1.0
    col[..., 1] = np.float32(0.5) * (np.float32(quant.NF4_CODE[14]) + 1)
    col[..., 2] = np.float32(0.5) * np.float32(quant.NF4_CODE[8])
    w[..., 5] = 0.0  # an all-zero channel: scale 1, index 7
    want = jquant.quantize_kernel_nf4(jnp.asarray(w))
    monkeypatch.setattr(quant, "_NF4_CHUNK", 1000)  # several slices
    got = quant.quantize_kernel_nf4(torch.from_numpy(w))
    assert got["kernel_q4"].dtype == torch.uint8  # one index per byte
    np.testing.assert_array_equal(
        got["kernel_q4"].numpy(),
        np.asarray(want["kernel_q4"]).astype(np.uint8))
    assert tree.to_numpy(got["kernel_scale4"]).tobytes() == np.asarray(
        want["kernel_scale4"]).tobytes()
    assert (got["kernel_q4"].numpy()[..., 5] == 7).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_nf4_dense_forward_and_dx_match_reference(dtype):
    rng = np.random.RandomState(6)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    q = jquant.quantize_kernel_nf4(jnp.asarray(rng.randn(64, 48), jnp.float32))
    x = np.asarray(jnp.asarray(rng.randn(3, 5, 64), jdt))
    g = np.asarray(jnp.asarray(rng.randn(3, 5, 48), jdt))
    want, vjp = jax.vjp(
        lambda xx: jquant.nf4_dense(xx, q["kernel_q4"], q["kernel_scale4"]),
        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    qt = tree.to_torch(jax.tree.map(np.asarray, q), device="cpu")
    tx, tg = tree.to_torch([x, g], device="cpu")
    tx.requires_grad_()
    got = quant.nf4_dense(tx, qt["kernel_q4"], qt["kernel_scale4"])
    (dx,) = torch.autograd.grad(got, tx, tg)
    assert got.dtype == tx.dtype and dx.dtype == tx.dtype
    if dtype == "f32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **GRAD)
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **GRAD)
    else:
        _bf16_close(got.detach(), want)
        _bf16_close(dx, want_dx)


def _one_hot_rows(m, n, seed):
    """A cotangent with one non-zero entry per row: the case in which the
    missing straight-through backward read a relative error of 1.16."""
    rng = np.random.RandomState(seed)
    g = np.zeros((m, n), np.float32)
    g[np.arange(m), rng.randint(0, n, m)] = rng.randn(m)
    return g


@pytest.mark.parametrize("fn", ["int8_dense", "w8_dense"])
@pytest.mark.parametrize("case", ["5x64 one-hot", "3-D dense", "bf16"])
def test_int8_denses_dx_match_reference_vjp(fn, case):
    """dx = g @ dequant(W).T on both sides (straight-through for int8_dense:
    autograd through round() would reach x only through the absmax scale)."""
    rng = np.random.RandomState(8)
    k, n = 64, 48
    q = jquant.quantize_kernel(jnp.asarray(rng.randn(k, n), jnp.float32))
    if case == "5x64 one-hot":
        x, g = rng.randn(5, k).astype(np.float32), _one_hot_rows(5, n, 9)
    else:
        x = rng.randn(2, 7, k).astype(np.float32)
        g = rng.randn(2, 7, n).astype(np.float32)
    if case == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
        g = np.asarray(jnp.asarray(g, jnp.bfloat16))
    jfn, tfn = getattr(jquant, fn), getattr(quant, fn)
    _, vjp = jax.vjp(lambda xx: jfn(xx, q["kernel_q"], q["kernel_scale"]),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    qt = tree.to_torch(jax.tree.map(np.asarray, q), device="cpu")
    tx, tg = tree.to_torch([x, g], device="cpu")
    tx.requires_grad_()
    y = tfn(tx, qt["kernel_q"], qt["kernel_scale"])
    (dx,) = torch.autograd.grad(y, tx, tg)
    assert dx.dtype == tx.dtype and dx.shape == tx.shape
    if case == "bf16":
        _bf16_close(dx, want)
    else:
        np.testing.assert_allclose(dx.numpy(), np.asarray(want), **GRAD)
        # far from what differentiating the rounding itself would give
        assert np.abs(np.asarray(want)).max() > 1e-3


def test_quantized_denses_give_no_gradient_to_their_weights():
    rng = np.random.RandomState(11)
    q = quant.quantize_kernel(torch.from_numpy(
        rng.randn(32, 16).astype(np.float32)))
    scale = q["kernel_scale"].float().requires_grad_()
    x = torch.from_numpy(rng.randn(4, 32).astype(np.float32)).requires_grad_()
    for fn in (quant.int8_dense, quant.w8_dense):
        dx, ds = torch.autograd.grad(fn(x, q["kernel_q"], scale).sum(),
                                     (x, scale), allow_unused=True)
        assert ds is None and dx is not None
    n4 = quant.quantize_kernel_nf4(torch.from_numpy(
        rng.randn(32, 16).astype(np.float32)))
    s4 = n4["kernel_scale4"].float().requires_grad_()
    dx, ds = torch.autograd.grad(
        quant.nf4_dense(x, n4["kernel_q4"], s4).sum(), (x, s4),
        allow_unused=True)
    assert ds is None and dx is not None


@pytest.mark.parametrize("group_size", [None, 32])
def test_w4a8_dense_gradient_is_the_references_as_it_is(group_size):
    """The reference's w4a8_dense has no custom VJP: jax.grad differentiates
    the rounding (zero almost everywhere) and reaches x through the absmax
    scale alone. The port's plain autograd gives the same gradient; neither
    side is straight-through."""
    rng = np.random.RandomState(12)
    w = rng.randn(1, 64, 40).astype(np.float32)
    x = rng.randn(5, 64).astype(np.float32)
    g = rng.randn(5, 40).astype(np.float32)
    q = jw4.quantize_kernel_int4_stacked_host(w, group_size=group_size)
    jq, js = jnp.asarray(q["kernel_q4p"][0]), jnp.asarray(
        q["kernel_scale4p"][0])
    want = np.asarray(jax.grad(
        lambda xx: jnp.sum(jw4.w4a8_dense(xx, jq, js) * jnp.asarray(g)))(
            jnp.asarray(x)))
    qt = tree.to_torch(q, device="cpu")
    tx = torch.from_numpy(x).requires_grad_()
    y = w4_matmul.w4a8_dense(tx, qt["kernel_q4p"][0], qt["kernel_scale4p"][0])
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), want, rtol=1e-4, atol=1e-5)
    # one non-zero per row (the absmax entry), unlike g @ dequant(W).T
    assert (np.count_nonzero(want, axis=1) <= 1).all()
    assert (np.count_nonzero(dx.numpy(), axis=1) <= 1).all()


@pytest.mark.parametrize("quantize_embed", [True, False])
def test_quantize_params_nf4_leaf_for_leaf(quantize_embed):
    t = _tree_with_vocab_table()
    want = jax.tree.map(np.asarray, jquant.quantize_params(
        jax.tree.map(jnp.asarray, t), quantize_embed=quantize_embed, bits=4))
    got = tree.to_numpy(quant.quantize_params(
        tree.to_torch(t, device="cpu"), quantize_embed=quantize_embed,
        bits=4))
    _assert_trees_bit_equal(want, got)
    llm = got["llm"]
    assert "kernel_q4" in llm["layers"]["mlp"]["down"]
    assert ("embedding_q" in llm["embed"]) == quantize_embed  # int8, not NF4
    assert "bias" in got["vision"]["layers"]["attn"]["wq"]
    with pytest.raises(ValueError, match="bits"):
        quant.quantize_params(tree.to_torch(t, device="cpu"), bits=2)
