"""Nucleus sampling and the per-row gen validity of the port's decode step
(halva_tpu_torch/ops/generate.py, models/llama.py) against the JAX package on
the CPU, on LLAVA_TINY fp32 trees from a numpy seed.

- `decode_step` with `gen_valid_override` and `write_slot` against the
  reference's `decode_step` with the same arguments (bf16, int8 and int4
  prompt KV, and a packed-int4 tree): logits within rtol 1e-5 (fp32), the
  gen cache written at `write_slot` only; the refusal on ALiBi and window
  configs in both packages;
- `generate(temperature=0)` equals `generate_greedy`, and `top_p=1e-6`
  equals greedy (the reference's tests/test_generate.py::
  test_sampling_modes); one seed repeats, two seeds differ;
- the sampler in frequency: the port's draws and the reference's
  `_select_token` drawn over many JAX keys, each by a chi-square test against
  the filtered softmax computed in float64 (p > 1e-3), and no token outside
  the port's nucleus drawn by either;
- the draw is a pure function of (seed, step, row, vocab index): a 0-d
  tensor step gives the int step's noise bit for bit, and every token a
  sampled loop emits lies in its step's nucleus.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.constants import IMAGE_TOKEN_INDEX
from halva_tpu.models import llama as jllama
from halva_tpu.ops import generate as jgenerate
from halva_tpu.ops.w4_matmul import quantize_params_int4_host
from halva_tpu_torch import tree
from halva_tpu_torch.models import llama
from halva_tpu_torch.ops import generate

from test_torch_tree import jax_tree, port_cfg, shared_trees

torch.set_num_threads(2)

TCFG = port_cfg(LLAVA_TINY)
RTOL = 1e-5  # fp32 logits: only the summation order differs
CHI2_P = 1e-3


@pytest.fixture(scope="module")
def trees():
    return shared_trees()


def _inputs(seed=5, b=3, s=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 250, (b, s)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    lens = np.array([12, 7, 9][:b], np.int32)
    for r, n in enumerate(lens):
        ids[r, n:] = 0
    size = LLAVA_TINY.vision.image_size
    imgs = rng.randn(b, 3, size, size).astype(np.float32)
    return ids, imgs, lens


MAX_NEW = 8  # the gen cache rounds it up to SG slots
SG = 128
WRITE_SLOT = 5
# a ring mask: per-row valid slots that are no prefix, the written one among
# them
RING = np.random.RandomState(3).rand(3, SG) < 0.3
RING[:, WRITE_SLOT] = True


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:  # bf16 -> fp32 -> bf16 is exact
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _override_step(jp, tp, kv_quant):
    """One decode step with the ring mask and a write slot in both
    packages, on the port's prefill (its prompt cache, first tokens and
    lengths handed to both) and the same filled gen cache: (port logits,
    port gen cache, reference logits, reference gen cache)."""
    ids, imgs, lens = (torch.from_numpy(a) for a in _inputs())
    with torch.inference_mode():
        first, _, slen, pc, pseg = generate._prefill_impl(
            tp, TCFG, ids, imgs, lens, kv_quant=kv_quant)
    b = first.shape[0]
    gen = generate.init_gen_cache_like(TCFG.llm, b, MAX_NEW, pc)
    assert gen["k"].shape[3] == SG
    rng = np.random.RandomState(1)
    for key in sorted(gen):  # every slot holds something
        if gen[key].dtype == torch.int8:
            fill = torch.from_numpy(
                rng.randint(-127, 128, gen[key].shape).astype(np.int8))
        else:
            fill = torch.from_numpy(
                (rng.rand(*gen[key].shape) + 0.5).astype(np.float32))
        gen[key].copy_(fill.to(gen[key].dtype))
    jgen = {k: _to_jax(v) for k, v in gen.items()}
    jpc = {k: _to_jax(v) for k, v in pc.items()}
    with torch.inference_mode():
        emb = llama.embed(tp["llm"], first[:, None])
        logits, gen = llama.decode_step(
            tp["llm"], TCFG.llm, emb, slen + 3, pc, pseg, gen,
            torch.tensor(7), gen_valid_override=torch.from_numpy(RING),
            write_slot=torch.tensor(WRITE_SLOT))
    jlogits, jgen = jllama.decode_step(
        jp["llm"], LLAVA_TINY.llm,
        jllama.embed(jp["llm"], _to_jax(first)[:, None]),
        _to_jax(slen) + 3, jpc, _to_jax(pseg), jgen, jnp.int32(7),
        gen_valid_override=jnp.asarray(RING),
        write_slot=jnp.int32(WRITE_SLOT))
    return logits, gen, np.asarray(jlogits), jgen


@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
def test_decode_step_override_matches_reference(trees, kv_quant):
    """Logits rtol = atol = 1e-5; the written slot within one bf16 step
    (values) or one int8 unit and one bf16 step of its scale, as
    test_torch_llama states; every other slot untouched, bit for bit."""
    jp, tp = trees
    logits, gen, jlogits, jgen = _override_step(jp, tp, kv_quant)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=RTOL,
                               atol=RTOL)
    for key in gen:
        got = gen[key].float().numpy()
        want = np.asarray(jgen[key]).astype(np.float32)
        int8 = gen[key].dtype == torch.int8
        np.testing.assert_allclose(got[:, :, :, WRITE_SLOT],
                                   want[:, :, :, WRITE_SLOT],
                                   rtol=0 if int8 else 2**-7,
                                   atol=1.0 if int8 else 0)
        keep = [s for s in range(SG) if s != WRITE_SLOT]
        np.testing.assert_array_equal(got[:, :, :, keep],
                                      want[:, :, :, keep])


def test_decode_step_override_on_a_packed_int4_tree():
    """`_decode_step_w4` takes the write slot and the mask: against the
    reference's generic step on the same packed tree (its dense
    dequantizes; off the TPU its w4 step needs head dim 128). Logits
    rtol = atol = 1e-4, test_torch_llama's int4 decode-step tolerance."""
    q = quantize_params_int4_host(jax_tree(LLAVA_TINY), group_size=32)
    jp = jax.tree.map(jnp.asarray, q)
    tp = tree.to_torch(q, device="cpu")
    logits, gen, jlogits, jgen = _override_step(jp, tp, "int4")
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(
        gen["k"][:, :, :, :WRITE_SLOT].numpy(),
        np.asarray(jgen["k"])[:, :, :, :WRITE_SLOT])


def test_override_gives_the_lockstep_step_when_it_is_the_prefix(trees):
    """The ring mask equal to the lockstep one and write_slot == step give
    the plain step's logits and cache, bit for bit."""
    _, tp = trees
    ids, imgs, lens = (torch.from_numpy(a) for a in _inputs())
    outs = []
    with torch.inference_mode():
        first, _, slen, pc, pseg = generate._prefill_impl(
            tp, TCFG, ids, imgs, lens)
        for override in (False, True):
            gen = generate.init_gen_cache_like(TCFG.llm, 3, MAX_NEW, pc)
            gen["k"].fill_(0.25)
            kw = {}
            if override:
                kw = dict(gen_valid_override=(torch.arange(SG) <= 4)
                          .expand(3, SG), write_slot=4)
            outs.append(llama.decode_step(
                tp["llm"], TCFG.llm, llama.embed(tp["llm"], first[:, None]),
                slen + 4, pc, pseg, gen, 4, **kw))
    (want, want_gen), (got, got_gen) = outs
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for key in want_gen:
        torch.testing.assert_close(got_gen[key], want_gen[key], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("alibi,window", [(True, None), (False, 16)])
def test_override_refused_on_alibi_and_window(trees, alibi, window):
    jp, tp = trees
    b, sp = 2, 6
    for pkg in ("port", "reference"):
        if pkg == "port":
            cfg = dataclasses.replace(
                TCFG.llm, position_embedding="alibi" if alibi else "rope",
                sliding_window=window)
            kvh, dh = cfg.kv_heads, cfg.head_size
            pc = {n: torch.zeros((cfg.num_layers, b, kvh, sp, dh))
                  for n in ("k", "v")}
            gen = llama.init_gen_cache(cfg, b, MAX_NEW, dtype=torch.float32,
                                       device="cpu")
            call = lambda: llama.decode_step(  # noqa: E731
                tp["llm"], cfg, torch.zeros((b, 1, cfg.hidden_size)),
                torch.full((b,), 6), pc, torch.ones((b, sp),
                                                    dtype=torch.int32),
                gen, 0, gen_valid_override=torch.ones((b, SG), dtype=bool),
                write_slot=0)
        else:
            cfg = dataclasses.replace(
                LLAVA_TINY.llm,
                position_embedding="alibi" if alibi else "rope",
                sliding_window=window)
            kvh, dh = cfg.kv_heads, cfg.head_size
            pc = {n: jnp.zeros((cfg.num_layers, b, kvh, sp, dh))
                  for n in ("k", "v")}
            gen = jllama.init_gen_cache(cfg, b, MAX_NEW, dtype=jnp.float32)
            call = lambda: jllama.decode_step(  # noqa: E731
                jp["llm"], cfg, jnp.zeros((b, 1, cfg.hidden_size)),
                jnp.full((b,), 6), pc, jnp.ones((b, sp), jnp.int32), gen,
                jnp.int32(0), gen_valid_override=jnp.ones((b, SG), bool),
                write_slot=jnp.int32(0))
        with pytest.raises(NotImplementedError, match="lockstep"):
            call()


def _gen(tp, **kw):
    ids, imgs, lens = (torch.from_numpy(a) for a in _inputs())
    with torch.inference_mode():
        return generate.generate(tp, TCFG, ids, imgs, lens,
                                 max_new_tokens=8, eos_id=-1, **kw)


def test_sampling_modes(trees):
    """The reference's test_sampling_modes, on the port: temperature 0 is
    greedy; a tiny top_p keeps only the argmax; seeds repeat and differ."""
    _, tp = trees
    ids, imgs, lens = (torch.from_numpy(a) for a in _inputs())
    with torch.inference_mode():
        greedy, gnum = generate.generate_greedy(
            tp, TCFG, ids, imgs, lens, max_new_tokens=8, eos_id=-1)
    tok0, num0 = _gen(tp, temperature=0.0, seed=3)
    np.testing.assert_array_equal(tok0.numpy(), greedy.numpy())
    np.testing.assert_array_equal(num0.numpy(), gnum.numpy())
    tiny, _ = _gen(tp, temperature=0.7, top_p=1e-6, seed=3)
    np.testing.assert_array_equal(tiny.numpy(), greedy.numpy())
    a, _ = _gen(tp, temperature=1.5, top_p=0.95, seed=11)
    again, _ = _gen(tp, temperature=1.5, top_p=0.95, seed=11)
    other, _ = _gen(tp, temperature=1.5, top_p=0.95, seed=12)
    np.testing.assert_array_equal(a.numpy(), again.numpy())
    assert not np.array_equal(a.numpy(), other.numpy())
    assert not np.array_equal(a.numpy(), greedy.numpy())
    assert ((a >= 0) & (a < TCFG.llm.vocab_size)).all()


def test_generate_refuses_a_mesh_and_bad_sampling_values(trees):
    """A mesh runs now (tests/test_torch_mesh_generate.py on gloo ranks): a
    {1, 1} one, which reaches no collective, samples the meshless call's
    tokens (data shard 0 keeps the seed); bad sampling values are refused
    with a mesh or without."""
    from halva_tpu_torch.parallel.mesh import mesh_shape

    _, tp = trees
    one = mesh_shape({"data": 1, "model": 1})
    for kw in (dict(temperature=0.9, top_p=0.9, seed=5), {}):
        want, wnum = _gen(tp, **kw)
        got, gnum = _gen(tp, mesh=one, **kw)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(gnum.numpy(), wnum.numpy())
    with pytest.raises(ValueError, match="top_p"):
        _gen(tp, mesh=one, top_p=0.0)
    for bad in (dict(temperature=-0.1), dict(top_p=0.0), dict(top_p=1.5)):
        with pytest.raises(ValueError, match="top_p"):
            _gen(tp, **bad)


def test_every_sampled_token_lies_in_its_steps_nucleus(trees, monkeypatch):
    _, tp = trees
    seen = []
    select = generate._select_token

    def recording(logits, temperature, top_p, seed, step):
        tok = select(logits, temperature, top_p, seed, step)
        kept = generate.nucleus_logits(logits, temperature, top_p)
        seen.append(kept.gather(1, tok.long()[:, None]))
        return tok

    monkeypatch.setattr(generate, "_select_token", recording)
    _gen(tp, temperature=0.8, top_p=0.5, seed=4)
    assert len(seen) == 1 + 8  # the first token and every step's
    assert all(torch.isfinite(v).all() for v in seen)


def test_draw_is_a_pure_function_of_its_counters():
    logits = torch.from_numpy(np.random.RandomState(0).randn(
        5, 40).astype(np.float32))
    for step in (0, 9, generate.FIRST_STEP):
        want = generate.gumbel_noise(7, step, 5, 40, "cpu")
        got = generate.gumbel_noise(7, torch.tensor(step), 5, 40, "cpu")
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(
            generate._select_token(logits, 0.9, 0.8, 7, torch.tensor(step)),
            generate._select_token(logits, 0.9, 0.8, 7, step), rtol=0,
            atol=0)
    # another seed, step or row draws other noise
    base = generate.gumbel_noise(7, 9, 5, 40, "cpu")
    assert not torch.equal(base, generate.gumbel_noise(8, 9, 5, 40, "cpu"))
    assert not torch.equal(base, generate.gumbel_noise(7, 10, 5, 40, "cpu"))
    assert not torch.equal(base[0], base[1])
    # standard Gumbel moments over many draws
    many = generate.gumbel_noise(1, 0, 400, 1000, "cpu").double()
    assert abs(float(many.mean()) - 0.5772157) < 0.01
    assert abs(float(many.std()) - np.pi / np.sqrt(6)) < 0.01


V = 24
DRAWS = 6000


def _row_logits():
    """A peaked row with ties at its top and a long tail."""
    rng = np.random.RandomState(2)
    row = rng.randn(V).astype(np.float32)
    row[:4] = [3.0, 3.0, 2.5, 2.0]
    return row


def _filtered_probs(row, temperature, top_p):
    """float64 softmax of the port's filtered logits."""
    kept = generate.nucleus_logits(torch.from_numpy(row[None]), temperature,
                                   top_p)[0].double().numpy()
    p = np.exp(kept - kept.max())
    return p / p.sum()


def _chi2_p(counts, probs):
    live = probs > 0
    expected = probs[live] * counts.sum()
    return stats.chisquare(counts[live], expected).pvalue


@pytest.mark.parametrize("temperature,top_p", [(0.7, 0.9), (1.0, 0.6),
                                               (1.3, 1.0)])
def test_sampler_frequencies_match_the_references(temperature, top_p):
    row = _row_logits()
    probs = _filtered_probs(row, temperature, top_p)
    if top_p < 1:
        assert 0 < (probs > 0).sum() < V  # the nucleus cuts something
    assert probs[0] > 0 and probs[1] > 0  # ties with the top stay in
    # the port: DRAWS rows of the same logits over 6 steps
    per = DRAWS // 6
    logits = torch.from_numpy(np.repeat(row[None], per, 0))
    port = np.concatenate([
        generate._select_token(logits, temperature, top_p, 5, s).numpy()
        for s in range(6)])
    # the reference's `_select_token` over many keys
    keys = jax.random.split(jax.random.PRNGKey(0), 6)
    jl = jnp.asarray(np.repeat(row[None], per, 0))
    ref = np.concatenate([
        np.asarray(jgenerate._select_token(jl, temperature, top_p, k))
        for k in keys])
    for name, draws in (("port", port), ("reference", ref)):
        assert draws.shape == (DRAWS,)
        assert (probs[draws] > 0).all(), f"{name} drew outside the nucleus"
        counts = np.bincount(draws, minlength=V).astype(np.float64)
        assert _chi2_p(counts, probs) > CHI2_P, name


def test_noise_is_finite_at_the_extreme_counters(monkeypatch):
    """The largest and smallest 32-bit hashes give finite noise: a +inf
    would turn a token outside the nucleus (-inf) into NaN, which argmax
    picks."""
    monkeypatch.setattr(generate, "_hash32", lambda x: torch.where(
        x % 2 == 0, torch.zeros_like(x), torch.full_like(x, 0xFFFFFFFF)))
    noise = generate.gumbel_noise(0, 0, 2, 8, "cpu")
    assert torch.isfinite(noise).all()
    assert noise.max() > 15 and noise.min() < -2.5
