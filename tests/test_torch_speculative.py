"""Speculative greedy decode in the port (halva_tpu_torch/ops/speculative.py
and llama.verify_step) against the reference on the CPU, fp32, plain
versions of the kernels.

- `generate_speculative` is token-exact with the port's own `generate_greedy`
  (bf16-cache, int8 and int4 KV modes; draft_k 3, 4, 8; an eos that takes
  one row out mid-stream while the other goes on), and its tokens and
  `stats` equal the reference's `generate_speculative` on the same weights
  and inputs;
- `ngram_draft` equals the reference's on seeded histories;
- `verify_step`: logits within 1e-5 relative of the reference's XLA verify
  scan and the candidate writes equal, on a float tree and bf16 caches; on
  the head-dim-128 packed-int4 tree the port's K6/K5 plain path against the
  reference's `_verify_step_w4` (its Pallas kernels in interpret mode),
  argmax equal, logits within 0.08 absolute (the reference's own bound
  between its two paths), candidate writes equal up to one int8 step;
- `write_gen_candidates` moves a window that would pass the end of the cache
  back, as `dynamic_update_slice` does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY, LlamaConfig
from halva_tpu.constants import IMAGE_TOKEN_INDEX
from halva_tpu.models import llama as jllama
from halva_tpu.ops import speculative as jspec
from halva_tpu.ops.w4_matmul import quantize_params_int4_host
from halva_tpu_torch import tree
from halva_tpu_torch.models import llama
from halva_tpu_torch.ops import generate, speculative

from test_torch_tree import port_cfg, shared_trees

torch.set_num_threads(2)

CFG = LLAVA_TINY
TCFG = port_cfg(LLAVA_TINY)


def _inputs(b=2, s=9, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 50, (b, s)).astype(np.int32)
    ids[0, 1] = IMAGE_TOKEN_INDEX
    ids[1, 0] = IMAGE_TOKEN_INDEX
    lens = np.array([s, s - 3], np.int32)
    ids[1, s - 3:] = 0
    size = CFG.vision.image_size
    images = rng.randn(b, 3, size, size).astype(np.float32)
    return ids, images, lens


@pytest.fixture(scope="module")
def trees():
    return shared_trees()


def _port(tp, inputs, fn, **kw):
    ids, images, lens = inputs
    with torch.inference_mode():
        return fn(tp, TCFG, torch.from_numpy(ids), torch.from_numpy(images),
                  torch.from_numpy(lens), **kw)


def _check(trees, eos, kv_quant, draft_k, max_new=12):
    jp, tp = trees
    inputs = _inputs()
    ref_t, ref_n = _port(tp, inputs, generate.generate_greedy,
                         max_new_tokens=max_new, eos_id=eos,
                         kv_quant=kv_quant)
    got_t, got_n, stats = _port(tp, inputs, speculative.generate_speculative,
                                max_new_tokens=max_new, eos_id=eos,
                                draft_k=draft_k, kv_quant=kv_quant)
    assert got_t.dtype == torch.int32 and got_t.shape == (2, max_new)
    # greedy leaves 0 in slots it never reached; speculative fills with eos
    written = torch.arange(max_new)[None, :] < (ref_n[:, None] + 1)
    np.testing.assert_array_equal((got_t * written).numpy(),
                                  (ref_t * written).numpy())
    np.testing.assert_array_equal(got_n.numpy(), ref_n.numpy())
    ids, images, lens = inputs
    want_t, want_n, want_stats = jspec.generate_speculative(
        jp, CFG, jnp.asarray(ids), jnp.asarray(images), jnp.asarray(lens),
        max_new_tokens=max_new, eos_id=eos, draft_k=draft_k,
        attn_impl="xla", kv_quant=kv_quant)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert stats == want_stats
    assert stats["emitted_tokens"] >= stats["verify_steps"] >= 1
    return stats


@pytest.mark.parametrize("kv_quant,draft_k", [
    (False, 4), (False, 8), (True, 3), ("int4", 4), ("int8", 8)])
def test_speculative_token_exact_full_budget(trees, kv_quant, draft_k):
    # eos=2 is never produced by this model and seed within the budget
    _check(trees, eos=2, kv_quant=kv_quant, draft_k=draft_k)


@pytest.mark.parametrize("draft_k", [3, 4, 8])
def test_speculative_rows_finish_at_different_steps(trees, draft_k):
    """An eos that row 0 emits at step 3: it stops while row 1 goes on (its
    verify windows keep running), and an eos may land inside an accepted
    draft window."""
    _, tp = trees
    probe, _ = _port(tp, _inputs(), generate.generate_greedy,
                     max_new_tokens=12, eos_id=-1)
    eos = int(probe[0, 3])
    _check(trees, eos=eos, kv_quant=False, draft_k=draft_k)


def test_speculative_accepts_drafts_on_repetitive_output(trees):
    """Tiny random models fall into cyclic argmax output, which prompt
    lookup must then accept: more tokens than verify steps, past a budget
    that needs a second 128-slot block of gen cache at draft_k 8."""
    stats = _check(trees, eos=2, kv_quant=False, draft_k=8, max_new=130)
    assert stats["emitted_tokens"] > stats["verify_steps"]


def test_argument_checks(trees):
    _, tp = trees
    with pytest.raises(ValueError, match="draft_k"):
        _port(tp, _inputs(), speculative.generate_speculative,
              max_new_tokens=4, eos_id=2, draft_k=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_draft_matches_reference(seed):
    rng = np.random.RandomState(seed)
    b, t, n = 4, 24, 5
    hist = rng.randint(0, 4, (b, t)).astype(np.int32)  # few symbols: hits
    valid = rng.rand(b, t) < 0.85
    prev = rng.randint(0, 4, b).astype(np.int32)
    cur = rng.randint(0, 4, b).astype(np.int32)
    self_pos = np.array([-1, 5, t - 2, 0], np.int32)
    want = jspec.ngram_draft(jnp.asarray(hist), jnp.asarray(valid),
                             jnp.asarray(prev), jnp.asarray(cur),
                             jnp.asarray(self_pos), n)
    got = speculative.ngram_draft(
        torch.from_numpy(hist), torch.from_numpy(valid),
        torch.from_numpy(prev), torch.from_numpy(cur),
        torch.from_numpy(self_pos), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ngram_draft_finds_latest_continuation():
    hist = torch.tensor([[7, 8, 9, 3, 7, 8, 4, 5, 0, 7, 8]], dtype=torch.int32)
    valid = torch.ones_like(hist, dtype=torch.bool)
    got = speculative.ngram_draft(
        hist, valid, torch.tensor([7]), torch.tensor([8]),
        torch.tensor([9]), 3)
    assert got.tolist() == [[4, 5, 0]]  # the later of the two earlier hits


def _np(t):
    return jax.tree.map(np.asarray, t)


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_verify_step_matches_reference(cache):
    cfg = CFG.llm
    params = jllama.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    tp = tree.to_torch(_np(params), device="cpu")
    b, s, kq, sg = 2, 20, 4, 128
    rng = np.random.RandomState(3)
    seg = np.ones((b, s), np.int32)
    seg[1, 14:] = 0
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    embeds = rng.randn(b, s, cfg.hidden_size).astype(np.float32)
    quant = {"bf16": False, "int8": "int8", "int4": "int4"}[cache]
    _, pc = jax.jit(lambda e: jllama.prefill(
        params, cfg, e, jnp.asarray(seg), jnp.asarray(pos), attn_impl="xla",
        quantize_cache=quant))(jnp.asarray(embeds))
    gen = jllama.init_gen_cache(cfg, b, sg, quantized=cache != "bf16")
    tpc = tree.to_torch(_np(pc), device="cpu")
    tgen = tree.to_torch(jax.tree.map(np.array, gen), device="cpu")
    te = rng.randn(b, kq, cfg.hidden_size).astype(np.float32)
    pos0 = np.array([20, 14], np.int32)
    # quantized caches: both sides quantize the same fp32 values, where a
    # last-bit difference in the values can move an int8 by one step
    tol = dict(rtol=1e-5, atol=1e-5) if cache == "bf16" else dict(
        rtol=1e-3, atol=2e-3)
    for gen_len in ([0, 0], [3, 1]):
        gl = np.asarray(gen_len, np.int32)
        want_l, gen = jax.jit(lambda g, p0, n: jllama.verify_step(
            params, cfg, jnp.asarray(te), p0, pc, jnp.asarray(seg), g, n,
            allow_fused=False))(gen, jnp.asarray(pos0 + gl), jnp.asarray(gl))
        got_l, tgen = llama.verify_step(
            tp, port_cfg(cfg), torch.from_numpy(te),
            torch.from_numpy(pos0 + gl), tpc, torch.from_numpy(seg), tgen,
            torch.from_numpy(gl))
        assert got_l.dtype == torch.float32 and got_l.shape[:2] == (b, kq)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **tol)
        for key, want in gen.items():
            g, w = tree.to_numpy(tgen)[key], np.asarray(want)
            if w.dtype == np.int8:
                assert np.abs(g.astype(np.int32) - w).max() <= 1, key
            else:
                np.testing.assert_allclose(
                    g.astype(np.float32), w.astype(np.float32), rtol=2**-7,
                    atol=1e-6, err_msg=key)


@pytest.mark.parametrize("cache_mode", ["int8", "int4"])
def test_verify_step_w4_matches_reference(cache_mode):
    """The head-dim-128 packed-int4 tree, as the reference's own test of its
    fused verify runs it."""
    _check_verify_step_w4(cache_mode)


@pytest.mark.parametrize("cache_mode", ["int8", "int4"])
def test_verify_step_w4_on_the_gemm_route(cache_mode, monkeypatch):
    """With the row rule at 1 the B * K = 8 rows of a verify step take
    w4_gemm (K7's wrapper) for all 7 matmuls of each layer, and every
    expectation of the K6 route stands (one arithmetic on CPU tensors)."""
    from halva_tpu_torch.ops import w4_matmul

    calls = []
    real = w4_matmul.w4_gemm
    monkeypatch.setattr(w4_matmul, "W4_GEMV_MAX_ROWS", 1)
    monkeypatch.setattr(w4_matmul, "w4_gemm",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    _check_verify_step_w4(cache_mode)
    assert calls == [8] * (7 * 2 * 2)  # 7 matmuls x 2 layers x 2 steps


def _check_verify_step_w4(cache_mode):
    cfg = LlamaConfig(
        vocab_size=128, hidden_size=256, intermediate_size=320,
        num_layers=2, num_heads=2, max_position_embeddings=512)
    params = jllama.init_params(jax.random.PRNGKey(3), cfg)
    q4 = quantize_params_int4_host(_np(params))
    p4 = jax.tree.map(jnp.asarray, q4)
    tp4 = tree.to_torch(q4, device="cpu")
    b, s, kq, sg = 2, 40, 4, 128
    rng = np.random.RandomState(7)
    seg = np.ones((b, s), np.int32)
    seg[1, 30:] = 0
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    embeds = jnp.asarray(rng.randn(b, s, 256), jnp.float32)
    _, pc = jax.jit(lambda e: jllama.prefill(
        p4, cfg, e, jnp.asarray(seg), pos, attn_impl="xla",
        quantize_cache=cache_mode))(embeds)
    gen = jllama.init_gen_cache(cfg, b, sg, quantized=True)
    tpc = tree.to_torch(_np(pc), device="cpu")
    tgen = tree.to_torch(jax.tree.map(np.array, gen), device="cpu")
    te = rng.randn(b, kq, 256).astype(np.float32)
    pos0 = np.array([40, 30], np.int32)
    for gen_len in ([0, 0], [3, 1]):
        gl = np.asarray(gen_len, np.int32)
        want_l, gen = jax.jit(lambda g, p0, n: jllama._verify_step_w4(
            p4, cfg, jnp.asarray(te), p0, pc, jnp.asarray(seg), g, n))(
                gen, jnp.asarray(pos0 + gl), jnp.asarray(gl))
        got_l, tgen = llama.verify_step(
            tp4, port_cfg(cfg), torch.from_numpy(te),
            torch.from_numpy(pos0 + gl), tpc, torch.from_numpy(seg), tgen,
            torch.from_numpy(gl))
        np.testing.assert_array_equal(got_l.numpy().argmax(-1),
                                      np.asarray(want_l).argmax(-1))
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                                   atol=0.08)
        for key, want in gen.items():
            g, w = tree.to_numpy(tgen)[key], np.asarray(want)
            if w.dtype == np.int8:
                assert np.abs(g.astype(np.int32) - w).max() <= 1, key
            else:
                np.testing.assert_allclose(
                    g.astype(np.float32), w.astype(np.float32), rtol=2**-6,
                    atol=1e-6, err_msg=key)


@pytest.mark.parametrize("quantized", [False, True])
def test_write_gen_candidates_clamps_like_dynamic_update_slice(quantized):
    cfg = CFG.llm
    b, kq, sg = 3, 4, 128
    rng = np.random.RandomState(0)
    nl, kvh, dh = cfg.num_layers, cfg.kv_heads, cfg.head_size
    kc = rng.randn(nl, b, kq, kvh, dh).astype(np.float32)
    vc = rng.randn(nl, b, kq, kvh, dh).astype(np.float32)
    gen_len = np.array([0, 126, 300], np.int32)  # rows 1, 2 pass the end
    gen = jllama.init_gen_cache(cfg, b, sg, quantized=quantized)
    want = jllama.write_gen_candidates(gen, jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(gen_len))
    tgen = tree.to_torch(jax.tree.map(np.array, gen), device="cpu")
    llama.write_gen_candidates(tgen, torch.from_numpy(kc),
                               torch.from_numpy(vc),
                               torch.from_numpy(gen_len))
    for key, w in want.items():
        g, w = tree.to_numpy(tgen)[key], np.asarray(w)
        np.testing.assert_array_equal(g.astype(np.float32),
                                      w.astype(np.float32), err_msg=key)
    assert np.abs(tree.to_numpy(tgen)["k"][:, 1, :, 124:].astype(
        np.float32)).sum() > 0  # the window moved back to end at slot 127
