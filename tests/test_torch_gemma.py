"""Gemma in the port (halva_tpu_torch/models/llama.py with Gemma's knobs:
unit-offset RMSNorm, embeddings times sqrt(hidden), gelu_tanh MLP, a tied
head, 8 query heads over 1 KV head at head dim 256 in GEMMA_2B) against
`transformers` and against the JAX package, on the CPU:

- `convert_hf.llama_from_hf` on a tiny `transformers.GemmaForCausalLM`
  state dict (tied head, no `lm_head`) and the port's forward, as the
  reference's tests/test_gemma_s2.py::test_gemma_parity holds its own, at
  its tolerance (atol 3e-4, rtol 3e-3; HF runs its eager attention in fp32),
  at its head dim 16 and at Gemma's 256;
- the port's forward, prefill, decode step and verify step against
  halva_tpu.models.llama on the same numpy-seeded fp32 tree at head dim 256
  (2 layers, 2 heads over 1 KV head), fp32 within 1e-5 relative (the
  reference on its XLA path; the absolute part of the bound is 1e-5 of the
  tensor's largest magnitude: the unit-offset norms put hidden states and
  keys at up to ~8, where the two packages' summation orders leave ~2e-5;
  bf16 caches within one bf16 step of that); the packed-int4 decode step
  against the reference's
  `_decode_step_w4`, which at head dim 256 runs its Pallas K6 and K4 in
  interpret mode (logits within 1e-4, as test_torch_llama.py holds the
  head-dim-128 one);
- greedy decode (bf16 and int4 prompt KV), 2-beam search and speculative
  decode token-exact against the reference on the tiny LLAVA_GEMMA
  composition (VILA's llava_gemma: LLAVA_TINY's towers with a tiny Gemma);
- the attention route at head dims 64, 128 and 256 with and without grad: at 256
  the serving steps and a forward that needs a gradient (training) both
  take the kernels' wrappers (their plain versions on CPU tensors), since
  K2 and K3 have head-dim-256 instances. Gemma's train step itself is held
  against the reference in tests/test_torch_gemma_train.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY, LlamaConfig
from halva_tpu.models import llama as jllama
from halva_tpu.ops import beam as jbeam
from halva_tpu.ops import generate as jgenerate
from halva_tpu.ops import speculative as jspec
from halva_tpu.ops.w4_matmul import quantize_params_int4_host
from halva_tpu_torch import tree
from halva_tpu_torch.models import convert_hf, llama
from halva_tpu_torch.ops import attention as attn
from halva_tpu_torch.ops import beam, generate, speculative

from test_torch_llama import _assert_cache_close, _prefill_inputs
from test_torch_llava import _generate_inputs
from test_torch_tree import port_cfg, shared_trees

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)



def _close(got, want, rtol=1e-5):
    """fp32 within rtol relative, the absolute part at rtol of the largest
    magnitude (see the module docstring)."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _cache_close(got_t, want, key):
    """Integer caches as test_torch_llama holds them; bf16 ones within a
    bf16 step, or the fp32 differences above where a value is near 0."""
    if np.asarray(want).dtype == np.int8:
        return _assert_cache_close(got_t, want, key)
    got, want = _np(got_t), _np(want)
    np.testing.assert_allclose(got, want, rtol=2**-7,
                               atol=1e-5 * np.abs(want).max(), err_msg=key)


def gemma_like(head_dim=256, hidden=128, num_heads=2):
    """A tiny Gemma: GEMMA_2B's knobs at 2 layers, heads over 1 KV head."""
    return LlamaConfig(
        vocab_size=256, hidden_size=hidden, intermediate_size=2 * hidden,
        num_layers=2, num_heads=num_heads, num_kv_heads=1, head_dim=head_dim,
        max_position_embeddings=512, rms_norm_eps=1e-6,
        tie_word_embeddings=True, mlp_act="gelu_tanh",
        rmsnorm_unit_offset=True, embed_scale=True)


GEMMA_TINY = gemma_like()
# VILA's llava_gemma composition at tiny widths
LLAVA_GEMMA = dataclasses.replace(LLAVA_TINY, llm=GEMMA_TINY)
MAX_NEW = 10


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _llm_trees(cfg, seed=1):
    params = jllama.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    np_tree = jax.tree.map(np.asarray, params)
    return (jax.tree.map(jnp.asarray, np_tree),
            tree.to_torch(np_tree, device="cpu"))


@pytest.mark.parametrize("head_dim", [16, 256])
def test_gemma_parity_with_transformers(head_dim):
    cfg = gemma_like(head_dim=head_dim, hidden=64, num_heads=4)
    hf_cfg = transformers.GemmaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, head_dim=head_dim,
        max_position_embeddings=512, rms_norm_eps=1e-6,
        hidden_act="gelu_pytorch_tanh", attn_implementation="eager",
        tie_word_embeddings=True)
    torch.manual_seed(0)
    model = transformers.GemmaForCausalLM(hf_cfg).eval()
    params = convert_hf.llama_from_hf(model.state_dict(), port_cfg(cfg))
    assert "lm_head" not in params  # the tied head reads the embedding
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 11))
    with torch.no_grad():
        want = model(torch.tensor(ids)).logits.numpy()
        got = llama.forward(params, port_cfg(cfg),
                            torch.from_numpy(ids.astype(np.int32)))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=3e-3)


def test_forward_matches_reference():
    jp, tp = _llm_trees(GEMMA_TINY)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, GEMMA_TINY.vocab_size, (2, 24)).astype(np.int32)
    seg = np.ones((2, 24), np.int32)
    seg[1, 17:] = 0
    want = jllama.forward(jp, GEMMA_TINY, jnp.asarray(ids), jnp.asarray(seg))
    got = llama.forward(tp, port_cfg(GEMMA_TINY), torch.from_numpy(ids),
                        torch.from_numpy(seg))
    assert got.dtype == torch.float32
    live = seg != 0
    _close(_np(got)[live], _np(want)[live])


def _prefill_both(jp, tp, cfg, quant, s=20):
    emb, seg, pos = _prefill_inputs(cfg, s=s)
    jh, jc = jllama.prefill(jp, cfg, jnp.asarray(emb), jnp.asarray(seg),
                            jnp.asarray(pos), quantize_cache=quant)
    with torch.inference_mode():
        th, tc = llama.prefill(tp, port_cfg(cfg), torch.from_numpy(emb),
                               torch.from_numpy(seg), torch.from_numpy(pos),
                               quantize_cache=quant)
    return (emb, seg, pos), (jh, jc), (th, tc)


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_prefill_and_decode_step_match_reference(cache):
    quant = {"bf16": False, "int8": "int8", "int4": "int4"}[cache]
    jp, tp = _llm_trees(GEMMA_TINY)
    (_, seg, _), (jh, jc), (th, tc) = _prefill_both(jp, tp, GEMMA_TINY,
                                                    quant)
    _close(_np(th)[seg != 0], _np(jh)[seg != 0])
    for key in jc:
        _cache_close(tc[key], jc[key], key)
    prompt_np = jax.tree.map(np.asarray, jc)
    rng = np.random.RandomState(3)
    step = 2
    gen_np = jax.tree.map(np.array, jllama.init_gen_cache(
        GEMMA_TINY, 2, 5, quantized=bool(quant)))
    for key in ("k", "v"):
        shape = gen_np[key][:, :, :, :step].shape
        if quant:
            gen_np[key][:, :, :, :step] = rng.randint(-127, 128, shape)
            gen_np[key + "_scale"][:, :, :, :step] = np.asarray(jnp.asarray(
                rng.uniform(0.01, 0.03, shape[:-1]), jnp.bfloat16))
        else:
            gen_np[key][:, :, :, :step] = np.asarray(
                jnp.asarray(rng.randn(*shape), jnp.bfloat16))
    tok_emb = rng.randn(2, 1, GEMMA_TINY.hidden_size).astype(np.float32)
    positions = np.array([20 + step, 13 + step], np.int32)
    want_logits, want_gen = jllama.decode_step(
        jp, GEMMA_TINY, jnp.asarray(tok_emb), jnp.asarray(positions),
        jax.tree.map(jnp.asarray, prompt_np), jnp.asarray(seg),
        jax.tree.map(jnp.asarray, gen_np), jnp.int32(step))
    gen_t = tree.to_torch(gen_np, device="cpu")
    with torch.inference_mode():
        got_logits, got_gen = llama.decode_step(
            tp, port_cfg(GEMMA_TINY), torch.from_numpy(tok_emb),
            torch.from_numpy(positions), tree.to_torch(prompt_np, device="cpu"),
            torch.from_numpy(seg), gen_t, step)
    # quantized caches: both sides quantize the same fp32 values, where a
    # last-bit difference can move an int8 by one step
    _close(got_logits, want_logits, 1e-5 if cache == "bf16" else 1e-3)
    for key in gen_np:
        _cache_close(got_gen[key], want_gen[key], key)


@pytest.mark.parametrize("cache", ["bf16", "int4"])
def test_verify_step_matches_reference(cache):
    quant = {"bf16": False, "int4": "int4"}[cache]
    jp, tp = _llm_trees(GEMMA_TINY)
    (_, seg, _), (_, jc), (_, tc) = _prefill_both(jp, tp, GEMMA_TINY, quant)
    b, kq, sg = 2, 4, 128
    gen = jllama.init_gen_cache(GEMMA_TINY, b, sg, quantized=bool(quant))
    tgen = tree.to_torch(jax.tree.map(np.array, gen), device="cpu")
    tpc = tree.to_torch(jax.tree.map(np.asarray, jc), device="cpu")
    rng = np.random.RandomState(4)
    te = rng.randn(b, kq, GEMMA_TINY.hidden_size).astype(np.float32)
    pos0 = np.array([20, 13], np.int32)
    for gen_len in ([0, 0], [3, 1]):
        gl = np.asarray(gen_len, np.int32)
        want_l, gen = jllama.verify_step(
            jp, GEMMA_TINY, jnp.asarray(te), jnp.asarray(pos0 + gl), jc,
            jnp.asarray(seg), gen, jnp.asarray(gl), allow_fused=False)
        with torch.inference_mode():
            got_l, tgen = llama.verify_step(
                tp, port_cfg(GEMMA_TINY), torch.from_numpy(te),
                torch.from_numpy(pos0 + gl), tpc, torch.from_numpy(seg), tgen,
                torch.from_numpy(gl))
        assert got_l.shape == (b, kq, GEMMA_TINY.vocab_size)
        _close(got_l, want_l, 1e-5 if cache == "bf16" else 1e-3)
        for key, want in gen.items():
            _cache_close(tgen[key], want, key)


@pytest.mark.parametrize("kv", ["int4", "int8"])
def test_decode_step_w4_matches_pallas_route(kv, monkeypatch):
    """The int4g tree's decode step: the port's K6 and K4 route (their plain
    versions here) against the reference's `_decode_step_w4`, which runs
    its Pallas kernels in interpret mode at head dim 256 (dh % 128 == 0)."""
    traced = []
    real = jllama._decode_step_w4
    monkeypatch.setattr(jllama, "_decode_step_w4",
                        lambda *a, **k: traced.append(1) or real(*a, **k))
    params = jllama.init_params(jax.random.PRNGKey(4), GEMMA_TINY,
                                jnp.float32)
    q_np = quantize_params_int4_host(jax.tree.map(np.asarray, params),
                                     group_size=64)
    jp = jax.tree.map(jnp.asarray, q_np)
    tp = tree.to_torch(q_np, device="cpu")
    (_, seg, _), (_, jc), _ = _prefill_both(jp, tp, GEMMA_TINY, kv, s=13)
    prompt_np = jax.tree.map(np.asarray, jc)
    step = 3
    gen_np = jax.tree.map(np.array, jllama.init_gen_cache(
        GEMMA_TINY, 2, 8, quantized=True))
    rng = np.random.RandomState(5)
    for key in ("k", "v"):
        shape = gen_np[key][:, :, :, :step].shape
        gen_np[key][:, :, :, :step] = rng.randint(-127, 128, shape)
        gen_np[key + "_scale"][:, :, :, :step] = np.asarray(jnp.asarray(
            rng.uniform(0.01, 0.03, shape[:-1]), jnp.bfloat16))
    tok_emb = rng.randn(2, 1, GEMMA_TINY.hidden_size).astype(np.float32)
    positions = np.array([13 + step, 9 + step], np.int32)
    want_logits, want_gen = jllama.decode_step(
        jp, GEMMA_TINY, jnp.asarray(tok_emb), jnp.asarray(positions),
        jax.tree.map(jnp.asarray, prompt_np), jnp.asarray(seg),
        jax.tree.map(jnp.asarray, gen_np), jnp.int32(step))
    gen_t = tree.to_torch(gen_np, device="cpu")
    with torch.inference_mode():
        got_logits, got_gen = llama.decode_step(
            tp, port_cfg(GEMMA_TINY), torch.from_numpy(tok_emb),
            torch.from_numpy(positions), tree.to_torch(prompt_np, device="cpu"),
            torch.from_numpy(seg), gen_t, step)
    assert traced  # the reference ran its Pallas route
    np.testing.assert_allclose(_np(got_logits), _np(want_logits),
                               rtol=1e-4, atol=1e-4)
    for key in gen_np:
        _cache_close(got_gen[key], want_gen[key], key)


@pytest.fixture(scope="module")
def llava_trees():
    return shared_trees(LLAVA_GEMMA)


def _port(tp, fn, **kw):
    ids, imgs, lens = _generate_inputs()
    with torch.inference_mode():
        return fn(tp, port_cfg(LLAVA_GEMMA), torch.from_numpy(ids),
                  torch.from_numpy(imgs), torch.from_numpy(lens), **kw)


def _ref(jp, fn, **kw):
    ids, imgs, lens = _generate_inputs()
    return fn(jp, LLAVA_GEMMA, jnp.asarray(ids), jnp.asarray(imgs),
              jnp.asarray(lens), **kw)


@pytest.mark.parametrize("kv_quant", [False, "int4"])
def test_generate_greedy_token_exact(llava_trees, kv_quant):
    jp, tp = llava_trees
    kw = dict(max_new_tokens=MAX_NEW, eos_id=-1, kv_quant=kv_quant)
    want_tok, want_num = _ref(jp, jgenerate.generate_greedy, **kw)
    got_tok, got_num = _port(tp, generate.generate_greedy, **kw)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_num.numpy(), np.asarray(want_num))
    assert int(got_num[0]) == MAX_NEW and int(got_num[2]) == 0  # dead row


def test_generate_beam_token_exact(llava_trees):
    jp, tp = llava_trees
    kw = dict(max_new_tokens=MAX_NEW, eos_id=-1, num_beams=2)
    want_tok, want_num = _ref(jp, jbeam.generate_beam, attn_impl="xla", **kw)
    got_tok, got_num = _port(tp, beam.generate_beam, **kw)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_num.numpy(), np.asarray(want_num))


@pytest.mark.parametrize("kv_quant", [False, "int4"])
def test_generate_speculative_token_exact(llava_trees, kv_quant):
    jp, tp = llava_trees
    kw = dict(max_new_tokens=MAX_NEW, eos_id=-1, draft_k=4,
              kv_quant=kv_quant)
    want_t, want_n, want_stats = _ref(jp, jspec.generate_speculative,
                                      attn_impl="xla", **kw)
    got_t, got_n, stats = _port(tp, speculative.generate_speculative, **kw)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert stats == want_stats


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_kernel_route_by_head_dim_and_grad(head_dim, grad, monkeypatch):
    """"auto" takes the kernels at 128 and 256, the plain versions at 64,
    whether or not the forward needs a gradient (K2 and K3 take 128 and
    256, as K1 does): `attention` with grad enabled or not reaches K1's
    wrapper at 128 and 256 and the plain attention at 64. A named route is
    never overruled."""
    from halva_tpu_torch.ops import flash_attention as fa

    want = "kernel" if head_dim in (128, 256) else "plain"
    assert attn.kernel_route("auto", head_dim) == want
    assert attn.kernel_route("kernel", head_dim) == "kernel"
    assert attn.kernel_route("plain", head_dim) == "plain"
    took = []
    real_k, real_p = fa.flash_attention, fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: took.append(
        "kernel") or real_k(*a, **k))
    monkeypatch.setattr(fa, "flash_attention_plain", lambda *a, **k: took
                        .append("plain") or real_p(*a, **k))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 2, head_dim, generator=g,
                           requires_grad=grad) for _ in range(3))
    seg = torch.ones(1, 4, dtype=torch.int32)
    with torch.set_grad_enabled(grad):
        out = attn.attention(q, k, v, seg, seg)
    assert took[0] == want  # on the CPU the wrapper then runs the plain one
    assert out.requires_grad == grad
    if grad:
        out.sum().backward()
        assert all(t.grad is not None for t in (q, k, v))


def test_gemma_attention_route_follows_grad(monkeypatch):
    """Gemma's prefill reaches K1's wrapper under no_grad (serving), and so
    does a forward with grad enabled (training), once a layer: the rule is
    decided before any launch, from the config and torch.is_grad_enabled(),
    and at head dim 256 both take the kernels."""
    from halva_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(
                            *a, **k))
    _, tp = _llm_trees(GEMMA_TINY)
    pcfg = port_cfg(GEMMA_TINY)
    ids = torch.randint(0, 256, (2, 9), generator=torch.Generator()
                        .manual_seed(0), dtype=torch.int32)
    with torch.no_grad():
        served = llama.forward(tp, pcfg, ids)
    assert len(calls) == GEMMA_TINY.num_layers
    assert all(s[-1] == 256 for s in calls)
    calls.clear()
    trained = llama.forward(tp, pcfg, ids)
    assert len(calls) == GEMMA_TINY.num_layers
    assert all(s[-1] == 256 for s in calls)
    torch.testing.assert_close(trained.detach(), served, rtol=0, atol=0)
