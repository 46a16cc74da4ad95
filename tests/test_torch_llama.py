"""Llama decoder in the port (halva_tpu_torch/models/llama.py) against
halva_tpu.models.llama on the same tiny fp32 trees: the forward's logits,
prefill's hidden states and head-major prompt cache (bf16, int8, int4),
and one decode step's logits and updated gen cache, on float trees and on
an int4 tree whose decode step the reference runs through its Pallas
kernels (K6 and K4 in interpret mode, at dh=128). The configs include a
tiny Mistral-like one (GQA, a sliding window smaller than the prompt) and a
tiny MPT-like one (ALiBi, bias-free LayerNorm, non-gated GELU MLP, tied
embeddings); for those also decode against the full forward, ALiBi with an
int4 prompt cache, and ALiBi with beams. The same tree carries every
backend (`to_torch` of the reference's `init_params`, an unused `gate`
stack for MPT included).

Tolerances: fp32 activations rtol = atol = 1e-5 (only summation order
differs). The KV caches are bf16 in both packages (prefill writes
cache_dtype=bfloat16); an fp32 value a few ulps apart can round to
neighbouring bf16 values, so cache entries may differ by one bf16 step
(rtol 2^-7). Quantized caches: the same int8 values and bf16 scales,
except where a few-ulp fp32 difference crosses a rounding boundary (one
unit, or one bf16 step, in at most 0.1 % of the entries). The int4 decode
step's logits: rtol = atol = 1e-4 (fp32 throughout on both sides; the
reference's Pallas kernels order their sums by block)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAMA_TINY, LlamaConfig
from halva_tpu.models import llama as jllama
from halva_tpu.ops.w4_matmul import quantize_params_int4_host
from halva_tpu_torch import tree
from halva_tpu_torch.models import llama

from test_torch_tree import LLAVA_TINY_GQA, port_cfg

torch.set_num_threads(2)

MISTRAL_TINY = dataclasses.replace(LLAMA_TINY, num_kv_heads=2,
                                   sliding_window=8)
MPT_TINY = dataclasses.replace(
    LLAMA_TINY, position_embedding="alibi", norm_type="layernorm",
    mlp_act="gelu", gated_mlp=False, tie_word_embeddings=True)
CONFIGS = {"mha": LLAMA_TINY, "gqa_tied": LLAVA_TINY_GQA.llm,
           "mistral_like": MISTRAL_TINY, "mpt_like": MPT_TINY}
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_STEP = dict(rtol=2**-7, atol=1e-6)


def _llm_trees(cfg):
    params = jllama.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    np_tree = jax.tree.map(np.asarray, params)
    return jax.tree.map(jnp.asarray, np_tree), tree.to_torch(np_tree, device="cpu")


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
    got = llama.forward(tp, port_cfg(cfg), torch.from_numpy(ids), torch.from_numpy(seg))
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
    th, tc = llama.prefill(tp, port_cfg(cfg), torch.from_numpy(emb),
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
    gen_t = tree.to_torch(gen_np, device="cpu")
    got_logits, got_gen = llama.decode_step(
        tp, port_cfg(cfg), torch.from_numpy(tok_emb), torch.from_numpy(positions),
        tree.to_torch(prompt_np, device="cpu"), torch.from_numpy(seg), gen_t, step)
    assert got_gen is gen_t  # written in place
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(got_gen[key]), _np(want_gen[key]),
                                   **BF16_STEP)


def test_unported_branches_raise():
    # NF4 is a dense like the others now: no branch of `dense` raises
    x = torch.ones(2, 4)
    y = llama.dense(x, {"kernel_q4": torch.full((4, 3), 15, dtype=torch.uint8),
                        "kernel_scale4": torch.full((1, 3), 0.5)})
    torch.testing.assert_close(y, torch.full((2, 3), 2.0))  # 4 x 1.0 x 0.5
    # sliding window and ALiBi run; the speculative verify step keeps the
    # reference's contract (RoPE, no window) and refuses them as it does
    for cfg in (MISTRAL_TINY, MPT_TINY):
        _, tp = _llm_trees(cfg)
        pcfg = port_cfg(cfg)
        logits = llama.forward(tp, pcfg, torch.zeros(1, 4, dtype=torch.int32))
        assert torch.isfinite(logits).all()
        gen = llama.init_gen_cache(pcfg, 1, 4, device="cpu")
        with pytest.raises(NotImplementedError, match="RoPE"):
            llama.verify_step(tp, pcfg, torch.zeros(1, 2, cfg.hidden_size),
                              torch.zeros(1, dtype=torch.int32), {},
                              torch.ones(1, 4, dtype=torch.int32), gen,
                              torch.zeros(1, dtype=torch.int32))


def _decode_vs_full(cfg, prompt_len=12, total_len=20, kv=False, seed=6):
    """Prefill + step-by-step decode of the port against the port's own
    full forward, and the step logits against the reference's decode."""
    jp, tp = _llm_trees(cfg)
    pcfg = port_cfg(cfg)
    rng = np.random.RandomState(seed)
    b = 2
    ids = rng.randint(0, cfg.vocab_size, (b, total_len)).astype(np.int32)
    tids = torch.from_numpy(ids)
    full = llama.forward(tp, pcfg, tids)
    seg = np.ones((b, prompt_len), np.int32)
    pos = np.broadcast_to(np.arange(prompt_len, dtype=np.int32),
                          (b, prompt_len)).copy()
    emb = llama.embed(tp, tids[:, :prompt_len])
    _, pc = llama.prefill(tp, pcfg, emb, torch.from_numpy(seg),
                          torch.from_numpy(pos), cache_dtype=torch.float32,
                          quantize_cache=kv)
    _, jpc = jllama.prefill(jp, cfg, jnp.asarray(emb.numpy()),
                            jnp.asarray(seg), jnp.asarray(pos),
                            cache_dtype=jnp.float32, quantize_cache=kv)
    max_new = total_len - prompt_len
    gen = llama.init_gen_cache(pcfg, b, max_new, dtype=torch.float32,
                               device="cpu", quantized=bool(kv))
    jgen = jllama.init_gen_cache(cfg, b, max_new, dtype=jnp.float32,
                                 quantized=bool(kv))
    for step in range(max_new):
        t = prompt_len + step
        positions = np.full((b,), t, np.int32)
        logits, gen = llama.decode_step(
            tp, pcfg, llama.embed(tp, tids[:, t:t + 1]),
            torch.from_numpy(positions), pc, torch.from_numpy(seg), gen, step)
        want, jgen = jllama.decode_step(
            jp, cfg, jllama.embed(jp, jnp.asarray(ids[:, t:t + 1])),
            jnp.asarray(positions), jpc, jnp.asarray(seg), jgen,
            jnp.int32(step))
        np.testing.assert_allclose(_np(logits), _np(want), rtol=1e-4,
                                   atol=1e-4)
        if not kv:  # a quantized cache is not the full forward's arithmetic
            np.testing.assert_allclose(_np(logits), _np(full[:, t]),
                                       atol=2e-4, rtol=3e-3)


@pytest.mark.parametrize("name", ["mistral_like", "mpt_like"])
def test_decode_matches_full_forward(name):
    """A window smaller than the sequence must mask prompt and generated
    keys older than it exactly as the full forward does; ALiBi must not
    rotate and must bias both cache halves (fp32 caches; atol 2e-4, rtol
    3e-3 against the full forward as in the reference's own test, 1e-4
    against the reference's decode step)."""
    _decode_vs_full(CONFIGS[name])


@pytest.mark.parametrize("name", ["mistral_like", "mpt_like"])
def test_decode_int4_prompt_cache(name):
    """An int4 prompt cache (odd prompt length: one padded slot) attends in
    even/odd key order: the ALiBi bias and the windowed segment ids must
    follow that order. Step logits against the reference's, 1e-4."""
    _decode_vs_full(CONFIGS[name], prompt_len=13, total_len=19, kv="int4")


@pytest.mark.parametrize("name", ["mistral_like", "mpt_like"])
def test_decode_step_beams(name):
    """beam_k = 2: B*K beam rows against B prompt rows, the bias and the
    window taken at the item's position; logits against the reference."""
    cfg = CONFIGS[name]
    jp, tp = _llm_trees(cfg)
    emb, seg, pos = _prefill_inputs(cfg)
    _, jc = jllama.prefill(jp, cfg, jnp.asarray(emb), jnp.asarray(seg),
                           jnp.asarray(pos))
    prompt_np = jax.tree.map(np.asarray, jc)
    rng = np.random.RandomState(7)
    step, k = 2, 2
    gen_np = jax.tree.map(np.array, jllama.init_gen_cache(cfg, 2 * k, 5))
    for key in ("k", "v"):
        filled = rng.randn(*gen_np[key][:, :, :, :step].shape)
        gen_np[key][:, :, :, :step] = np.asarray(
            jnp.asarray(filled, jnp.bfloat16))
    tok_emb = rng.randn(2 * k, 1, cfg.hidden_size).astype(np.float32)
    positions = np.repeat(np.array([20 + step, 13 + step], np.int32), k)
    want, _ = jllama.decode_step(
        jp, cfg, jnp.asarray(tok_emb), jnp.asarray(positions),
        jax.tree.map(jnp.asarray, prompt_np), jnp.asarray(seg),
        jax.tree.map(jnp.asarray, gen_np), jnp.int32(step), beam_k=k)
    got, _ = llama.decode_step(
        tp, port_cfg(cfg), torch.from_numpy(tok_emb),
        torch.from_numpy(positions), tree.to_torch(prompt_np, device="cpu"),
        torch.from_numpy(seg), tree.to_torch(gen_np, device="cpu"), step,
        beam_k=k)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("name", ["mistral-7b", "mpt-7b"])
def test_presets_share_the_tree(name):
    """MISTRAL_7B and MPT_7B need nothing new of the tree code: the port's
    preset equals the reference's field for field, and `init_params` of a
    narrowed copy gives the reference's leaves, shapes and dtypes (the
    `gate` stack of the non-gated MPT MLP included)."""
    from halva_tpu import config as jconfig
    from halva_tpu_torch import config as tconfig

    jcfg = jconfig.PRESETS[name]
    assert port_cfg(jcfg) == tconfig.PRESETS[name]
    small = dataclasses.replace(jcfg, vocab_size=64, hidden_size=32,
                                intermediate_size=48, num_layers=2,
                                num_heads=4,
                                num_kv_heads=2 if jcfg.num_kv_heads else None)
    want = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(0), small, jnp.float32))
    got = tree._init_llama(
        tree._Init(torch.Generator().manual_seed(0), torch.float32, "cpu"),
        port_cfg(small))
    want_leaves = {p: (v.shape, str(v.dtype)) for p, v in tree.flatten(want)}
    got_leaves = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                  for p, v in tree.flatten(got)}
    assert got_leaves == want_leaves
    assert ("layers", "mlp", "gate", "kernel") in got_leaves


def _assert_cache_close(got_t, want, key):
    """Integer caches equal but for rare one-unit flips where a few-ulp
    fp32 difference crosses a rounding boundary; scales within a bf16
    step."""
    got = tree.to_numpy({key: got_t})[key]
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, key
    if got.dtype == np.int8:
        flips = got != want
        assert flips.mean() <= 1e-3, (key, flips.mean())
    else:
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), **BF16_STEP)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_prefill_quantized_cache(mode):
    cfg = LLAMA_TINY
    jp, tp = _llm_trees(cfg)
    emb, seg, pos = _prefill_inputs(cfg, s=21)  # odd: int4 pads one slot
    jh, jc = jax.jit(lambda p, e, s_, q: jllama.prefill(
        p, cfg, e, s_, q, quantize_cache=mode))(
        jp, jnp.asarray(emb), jnp.asarray(seg), jnp.asarray(pos))
    th, tc = llama.prefill(tp, port_cfg(cfg), torch.from_numpy(emb),
                           torch.from_numpy(seg), torch.from_numpy(pos),
                           quantize_cache=mode)
    np.testing.assert_allclose(_np(th), _np(jh), **F32)
    assert sorted(tc) == sorted(jc)
    want = ({"k4", "v4"} if mode == "int4" else {"k", "v"}) | {
        "k_scale", "v_scale"}
    assert set(tc) == want
    if mode == "int4":
        assert tuple(tc["k4"].shape) == (cfg.num_layers, 2, cfg.kv_heads, 11,
                                         cfg.head_size)
        assert tuple(tc["k_scale"].shape) == (cfg.num_layers, 2, 2,
                                              cfg.kv_heads, 11)
    for key in tc:
        _assert_cache_close(tc[key], jc[key], key)
    with pytest.raises(ValueError):
        llama.prefill(tp, port_cfg(cfg), torch.from_numpy(emb), torch.from_numpy(seg),
                      torch.from_numpy(pos), quantize_cache="int5")


# dh = 128 and Sg = 128: the reference's CPU decode_step takes
# _decode_step_w4, i.e. its Pallas K6 and K4 in interpret mode
W4_CFGS = {
    "mha": LlamaConfig(vocab_size=128, hidden_size=256, intermediate_size=384,
                       num_layers=2, num_heads=2, max_position_embeddings=256),
    "gqa": LlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=384,
                       num_layers=2, num_heads=4, num_kv_heads=2,
                       max_position_embeddings=256),
}


@pytest.mark.parametrize("kv", ["int4", "int8"])
@pytest.mark.parametrize("name", list(W4_CFGS))
def test_decode_step_w4_matches_pallas_route(name, kv, monkeypatch):
    _check_decode_step_w4(name, kv, monkeypatch)


@pytest.mark.parametrize("kv", ["int4", "int8"])
@pytest.mark.parametrize("name", list(W4_CFGS))
def test_decode_step_w4_on_the_gemm_route(name, kv, monkeypatch):
    """With the row rule at 1 the step's 2 rows take w4_gemm (K7's wrapper)
    for all 7 matmuls of each layer; K6's and K7's plain versions are one
    arithmetic, so every expectation of the K6 route stands."""
    from halva_tpu_torch.ops import w4_matmul

    calls = []
    real = w4_matmul.w4_gemm
    monkeypatch.setattr(w4_matmul, "W4_GEMV_MAX_ROWS", 1)
    monkeypatch.setattr(w4_matmul, "w4_gemm",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    _check_decode_step_w4(name, kv, monkeypatch)
    assert calls == [2] * (7 * W4_CFGS[name].num_layers)


def _check_decode_step_w4(name, kv, monkeypatch):
    traced = []
    real = jllama._decode_step_w4
    monkeypatch.setattr(jllama, "_decode_step_w4",
                        lambda *a, **k: traced.append(1) or real(*a, **k))
    cfg = W4_CFGS[name]
    assert cfg.head_size == 128
    params = jllama.init_params(jax.random.PRNGKey(4), cfg, jnp.float32)
    q_np = quantize_params_int4_host(jax.tree.map(np.asarray, params),
                                     group_size=64)
    jp = jax.tree.map(jnp.asarray, q_np)
    tp = tree.to_torch(q_np, device="cpu")
    emb, seg, pos = _prefill_inputs(cfg, s=13)
    _, jc = jax.jit(lambda p, e, s_, q: jllama.prefill(
        p, cfg, e, s_, q, quantize_cache=kv))(
        jp, jnp.asarray(emb), jnp.asarray(seg), jnp.asarray(pos))
    prompt_np = jax.tree.map(np.asarray, jc)
    step = 3
    gen_np = jax.tree.map(np.array, jllama.init_gen_cache(
        cfg, 2, 8, quantized=True))
    rng = np.random.RandomState(5)
    for key in ("k", "v"):
        shape = gen_np[key][:, :, :, :step].shape
        gen_np[key][:, :, :, :step] = rng.randint(-127, 128, shape)
        gen_np[key + "_scale"][:, :, :, :step] = np.asarray(jnp.asarray(
            rng.uniform(0.01, 0.03, shape[:-1]), jnp.bfloat16))
    tok_emb = rng.randn(2, 1, cfg.hidden_size).astype(np.float32)
    positions = np.array([13 + step, 9 + step], np.int32)
    want_logits, want_gen = jax.jit(
        lambda p, e, q, pc, ps, gc: jllama.decode_step(
            p, cfg, e, q, pc, ps, gc, jnp.int32(step))
    )(jp, jnp.asarray(tok_emb), jnp.asarray(positions),
      jax.tree.map(jnp.asarray, prompt_np), jnp.asarray(seg),
      jax.tree.map(jnp.asarray, gen_np))
    gen_t = tree.to_torch(gen_np, device="cpu")
    got_logits, got_gen = llama.decode_step(
        tp, port_cfg(cfg), torch.from_numpy(tok_emb), torch.from_numpy(positions),
        tree.to_torch(prompt_np, device="cpu"), torch.from_numpy(seg), gen_t, step)
    assert traced  # the reference ran its Pallas route
    np.testing.assert_allclose(_np(got_logits), _np(want_logits),
                               rtol=1e-4, atol=1e-4)
    for key in gen_np:
        _assert_cache_close(got_gen[key], want_gen[key], key)


def test_head_dim_rule_picks_the_route_from_the_config(monkeypatch):
    """attn_impl="auto" takes the kernels at head dim 128 and the plain
    versions at any other, on either device, by `kernel_route`: never by a
    failure. The kernel entry points are replaced by ones that raise, so a
    head-dim-64 config that reached one would fail here."""
    from halva_tpu_torch.ops import attention as attn
    from halva_tpu_torch.ops import flash_attention as fa
    from halva_tpu_torch.ops import w4_matmul

    assert attn.kernel_route("auto", 128) == "kernel"
    assert attn.kernel_route("auto", 64) == "plain"
    assert attn.kernel_route("auto", 256) == "plain"
    assert attn.kernel_route("kernel", 64) == "kernel"  # named: not overruled
    assert attn.kernel_route("plain", 128) == "plain"
    with pytest.raises(ValueError, match="unknown attention impl"):
        attn.kernel_route("xla", 128)
    assert llama._w4_mm("auto", 64) is w4_matmul.w4_dense_stacked_plain
    assert llama._w4_mm("auto", 128) is w4_matmul.w4_decode_matmul
    assert llama._w4_mm("kernel", 64) is w4_matmul.w4_decode_matmul
    assert llama._w4_mm("plain", 128) is w4_matmul.w4_dense_stacked_plain

    def refuse(*a, **k):
        raise AssertionError("a kernel entry point was reached")

    monkeypatch.setattr(fa, "flash_attention", refuse)
    monkeypatch.setattr(llama, "decode_attend_layer", refuse)
    monkeypatch.setattr(llama, "fold_attend_layer", refuse)
    monkeypatch.setattr(w4_matmul, "w4_dense_stacked", refuse)
    monkeypatch.setattr(w4_matmul, "w4_gemm", refuse)
    cfg = LlamaConfig(vocab_size=64, hidden_size=128, intermediate_size=128,
                      num_layers=2, num_heads=2, max_position_embeddings=64)
    assert cfg.head_size == 64
    params = jllama.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    q_np = quantize_params_int4_host(jax.tree.map(np.asarray, params),
                                     group_size=64)
    pcfg = port_cfg(cfg)
    for np_tree in (jax.tree.map(np.asarray, params), q_np):
        tp = tree.to_torch(np_tree, device="cpu")
        emb, seg, pos = _prefill_inputs(cfg, s=9)
        args = (torch.from_numpy(emb), torch.from_numpy(seg),
                torch.from_numpy(pos))
        hidden, pc = llama.prefill(tp, pcfg, *args)  # "auto"
        want, _ = llama.prefill(tp, pcfg, *args, attn_impl="plain")
        torch.testing.assert_close(hidden, want, rtol=0, atol=0)
        gen = llama.init_gen_cache(pcfg, 2, 8, dtype=torch.float32,
                                   device="cpu")
        tok = torch.zeros(2, 1, cfg.hidden_size)
        logits, _ = llama.decode_step(tp, pcfg, tok,
                                      torch.tensor([9, 9]), pc, args[1],
                                      gen, 0)
        assert torch.isfinite(logits).all()
        vl, _ = llama.verify_step(tp, pcfg, tok.expand(2, 3, -1),
                                  torch.tensor([9, 9]), pc, args[1], gen,
                                  torch.zeros(2, dtype=torch.int32))
        assert vl.shape == (2, 3, cfg.vocab_size)
    with pytest.raises(AssertionError, match="kernel entry point"):
        llama.prefill(tp, pcfg, *args, attn_impl="kernel")
