"""K5 and K4's beam mode on the CPU: the port's plain versions against the
reference's Pallas entry points called directly (interpret mode on the CPU).

`fold_attend_plain` (per-beam gen stage; shared gen stage with candidates)
against `fold_attend_layer`, and `decode_attend_plain(beam_k=K)` against
`decode_attend_layer(beam_k=K)` on its grid route, on the same seeded numpy
inputs: bf16, int8 and int4 prompt caches, MHA and GQA (G = 4), Gemma's
head dim 256 with 8 query heads over 1 kv head (32 rows an item), a prompt
length that is no multiple of anything, a single valid gen slot, and an item
whose every key is masked (both sides give 0 there).

Tolerances: fp32 queries 1e-5 relative / 1e-4 absolute (sum order only);
bf16 queries 2e-2 absolute on unit-scale values (the probabilities round to
bf16 before the PV product, at different tile boundaries in the two).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.ops.decode_attention import decode_attend_layer as jax_decode
from halva_tpu.ops.decode_attention import fold_attend_layer as jax_fold
from halva_tpu_torch import tree
from halva_tpu_torch.ops.decode_attention import (
    decode_attend_layer,
    decode_attend_plain,
    fold_attend_layer,
    fold_attend_plain,
)

torch.set_num_threads(2)

D = 128
LAYERS = 2


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _caches(fmt, rng, b, gen_rows, kvh, sp, sg, d=D):
    """Stacked prompt cache at b rows and gen cache at gen_rows rows of head
    dim d in format `fmt` (bf16 | int8 | int4; the quantized ones with int8
    gen)."""

    def int8(*shape):
        return np.clip(np.round(rng.randn(*shape) * 40), -127,
                       127).astype(np.int8)

    if fmt == "bf16":
        prompt = {"k": _bf16(rng.randn(LAYERS, b, kvh, sp, d)),
                  "v": _bf16(rng.randn(LAYERS, b, kvh, sp, d))}
        gen = {"k": _bf16(rng.randn(LAYERS, gen_rows, kvh, sg, d)),
               "v": _bf16(rng.randn(LAYERS, gen_rows, kvh, sg, d))}
        return prompt, gen
    if fmt == "int4":
        s2 = -(-sp // 2)
        prompt = {
            "k4": rng.randint(-128, 128, (LAYERS, b, kvh, s2, d)).astype(
                np.int8),
            "v4": rng.randint(-128, 128, (LAYERS, b, kvh, s2, d)).astype(
                np.int8),
            "k_scale": _bf16(rng.uniform(0.1, 0.3, (LAYERS, b, 2, kvh, s2))),
            "v_scale": _bf16(rng.uniform(0.1, 0.3, (LAYERS, b, 2, kvh, s2))),
        }
    else:
        prompt = {
            "k": int8(LAYERS, b, kvh, sp, d), "v": int8(LAYERS, b, kvh, sp, d),
            "k_scale": _bf16(rng.uniform(0.01, 0.04, (LAYERS, b, kvh, sp))),
            "v_scale": _bf16(rng.uniform(0.01, 0.04, (LAYERS, b, kvh, sp))),
        }
    gen = {
        "k": int8(LAYERS, gen_rows, kvh, sg, d),
        "v": int8(LAYERS, gen_rows, kvh, sg, d),
        "k_scale": _bf16(rng.uniform(0.01, 0.04, (LAYERS, gen_rows, kvh, sg))),
        "v_scale": _bf16(rng.uniform(0.01, 0.04, (LAYERS, gen_rows, kvh, sg))),
    }
    return prompt, gen


def _inputs(fmt, k, h, kvh, sp, sg, shared, q_dtype, dead=None, seed=0,
            d=D):
    """dead: None | "prompt" (item 1's prompt all masked) | "all" (item 1's
    prompt and gen both masked: rows with no visible key)."""
    rng = np.random.RandomState(seed)
    b = 2
    gen_rows = b if shared else b * k
    q = np.asarray(jnp.asarray(rng.randn(b, k, h, d), q_dtype))
    prompt, gen = _caches(fmt, rng, b, gen_rows, kvh, sp, sg, d)
    seg = np.ones((b, sp), np.int32)
    seg[0, sp - 50:] = 0
    seg[1, sp // 3:] = 0
    steps = rng.randint(0, sg, gen_rows)
    steps[0] = 0  # a single valid gen slot
    gv = np.arange(sg)[None, :] <= steps[:, None]
    if dead:
        seg[1] = 0
    if dead == "all":
        gv[gen_rows // 2:] = False
    cand = None
    if shared:
        cand = (_bf16(rng.randn(b, k, kvh, d)), _bf16(rng.randn(b, k, kvh, d)))
    return q, prompt, seg, gen, gv, cand


def _tol(q_dtype):
    if q_dtype == "f32":
        return dict(rtol=1e-5, atol=1e-4)
    return dict(rtol=0, atol=2e-2)


def _layer(t, li):
    return {key: v[li] for key, v in t.items()}


# name: (k, h, kvh, sp, sg, dead, head dim)
BEAM_CASES = {
    "mha_k4": (4, 4, 4, 301, 16, None, D),
    "gqa_k3": (3, 8, 2, 301, 16, None, D),
    "mha_k2_dead_prompt": (2, 4, 4, 130, 16, "prompt", D),
    "mha_k4_no_visible_key": (4, 4, 4, 130, 16, "all", D),
    # Gemma: 8 query heads over 1 kv head at head dim 256, 32 rows an item
    "gemma_k4_d256": (4, 8, 1, 301, 16, None, 256),
}


@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("name", list(BEAM_CASES))
def test_fold_per_beam_matches_reference(name, fmt, q_dtype):
    k, h, kvh, sp, sg, dead, d = BEAM_CASES[name]
    jdt = jnp.float32 if q_dtype == "f32" else jnp.bfloat16
    q, prompt, seg, gen, gv, _ = _inputs(fmt, k, h, kvh, sp, sg, False, jdt,
                                         dead, d=d)
    tq, tseg, tgv = tree.to_torch([q, seg, gv], device="cpu")
    tprompt = tree.to_torch(prompt, device="cpu")
    tgen = tree.to_torch(gen, device="cpu")
    for li in range(LAYERS):
        got = fold_attend_layer(tq, _layer(tprompt, li), tseg,
                                _layer(tgen, li), tgv, fold_k=k)
        assert got.dtype == tq.dtype and got.shape == q.shape
        want = np.asarray(jax_fold(
            jnp.asarray(q), jax.tree.map(jnp.asarray, prompt),
            jnp.asarray(seg), jax.tree.map(jnp.asarray, gen),
            jnp.asarray(gv), jnp.int32(li), fold_k=k), np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, **_tol(q_dtype))
        if dead == "all":
            assert not got[1].any() and not want[1].any()
            assert got[0].abs().sum() > 0


@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("name", ["mha_k4", "gqa_k3", "mha_k2_dead_prompt",
                                  "gemma_k4_d256"])
def test_decode_plain_beam_matches_reference_grid(name, fmt, q_dtype,
                                                  monkeypatch):
    """K4's beam mode: B*K single-query rows against B prompt rows, held
    against the reference's beam-grid kernel, and the plain fold equal to it
    row for row."""
    monkeypatch.setenv("HALVA_BEAM_DOT", "grid")
    k, h, kvh, sp, sg, dead, d = BEAM_CASES[name]
    jdt = jnp.float32 if q_dtype == "f32" else jnp.bfloat16
    q, prompt, seg, gen, gv, _ = _inputs(fmt, k, h, kvh, sp, sg, False, jdt,
                                         dead, d=d)
    b = q.shape[0]
    q1 = q.reshape(b * k, 1, h, d)
    tq, tseg, tgv = tree.to_torch([q1, seg, gv], device="cpu")
    tprompt = tree.to_torch(prompt, device="cpu")
    tgen = tree.to_torch(gen, device="cpu")
    li = 1
    got = decode_attend_layer(tq, _layer(tprompt, li), tseg, _layer(tgen, li),
                              tgv, beam_k=k)
    assert got.dtype == tq.dtype and got.shape == q1.shape
    want = np.asarray(jax_decode(
        jnp.asarray(q1), jax.tree.map(jnp.asarray, prompt), jnp.asarray(seg),
        jax.tree.map(jnp.asarray, gen), jnp.asarray(gv), jnp.int32(li),
        beam_k=k), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(q_dtype))
    folded = fold_attend_plain(tq.reshape(b, k, h, d), _layer(tprompt, li),
                               tseg, _layer(tgen, li), tgv, fold_k=k)
    torch.testing.assert_close(folded.reshape(b * k, 1, h, d), got,
                               rtol=1e-5, atol=1e-5 if q_dtype == "f32"
                               else 8e-3)


# name: (k, h, kvh, sp, sg, dead, head dim)
SHARED_CASES = {
    "mha_k4": (4, 4, 4, 301, 16, None, D),
    "gqa_k8": (8, 8, 2, 300, 24, None, D),
    "mha_k3_dead_prompt": (3, 4, 4, 130, 16, "prompt", D),
    "gemma_k4_d256": (4, 8, 1, 300, 24, None, 256),
}


@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("name", list(SHARED_CASES))
def test_fold_shared_gen_with_candidates_matches_reference(name, fmt,
                                                           q_dtype):
    k, h, kvh, sp, sg, dead, d = SHARED_CASES[name]
    jdt = jnp.float32 if q_dtype == "f32" else jnp.bfloat16
    q, prompt, seg, gen, gv, cand = _inputs(fmt, k, h, kvh, sp, sg, True,
                                            jdt, dead, d=d)
    tq, tseg, tgv = tree.to_torch([q, seg, gv], device="cpu")
    tprompt = tree.to_torch(prompt, device="cpu")
    tgen = tree.to_torch(gen, device="cpu")
    tcand = tuple(tree.to_torch(list(cand), device="cpu"))
    if q_dtype == "f32":  # candidates arrive in the queries' type
        tcand = tuple(t.float() for t in tcand)
    li = 0
    got = fold_attend_layer(tq, _layer(tprompt, li), tseg, _layer(tgen, li),
                            tgv, fold_k=k, shared_gen=True, candidates=tcand)
    assert got.dtype == tq.dtype and got.shape == q.shape
    want = np.asarray(jax_fold(
        jnp.asarray(q), jax.tree.map(jnp.asarray, prompt), jnp.asarray(seg),
        jax.tree.map(jnp.asarray, gen), jnp.asarray(gv), jnp.int32(li),
        fold_k=k, shared_gen=True,
        candidates=tuple(jnp.asarray(c).astype(jdt) for c in cand)),
        np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(q_dtype))


def test_cpu_wrappers_are_the_plain_versions():
    q, prompt, seg, gen, gv, _ = _inputs("int8", 3, 8, 2, 40, 8, False,
                                         jnp.float32)
    tq, tseg, tgv = tree.to_torch([q, seg, gv], device="cpu")
    pc = _layer(tree.to_torch(prompt, device="cpu"), 0)
    gc = _layer(tree.to_torch(gen, device="cpu"), 0)
    torch.testing.assert_close(
        fold_attend_layer(tq, pc, tseg, gc, tgv, fold_k=3),
        fold_attend_plain(tq, pc, tseg, gc, tgv, fold_k=3), rtol=0, atol=0)
    q1 = tq.reshape(6, 1, 8, D)
    for route in ("auto", "fold", "grid"):
        torch.testing.assert_close(
            decode_attend_layer(q1, pc, tseg, gc, tgv, beam_k=3,
                                beam_route=route),
            decode_attend_plain(q1, pc, tseg, gc, tgv, beam_k=3),
            rtol=0, atol=0)


def test_garbage_scales_of_masked_keys_do_not_leak_into_the_fold():
    q, prompt, seg, gen, gv, cand = _inputs("int8", 4, 4, 4, 40, 16, True,
                                            jnp.float32)
    tq, tseg, tgv = tree.to_torch([q, seg, gv], device="cpu")
    pc = _layer(tree.to_torch(prompt, device="cpu"), 0)
    gc = _layer(tree.to_torch(gen, device="cpu"), 0)
    tcand = tuple(t.float() for t in tree.to_torch(list(cand), device="cpu"))
    want = fold_attend_plain(tq, pc, tseg, gc, tgv, 4, True, tcand)
    pc["v_scale"] = pc["v_scale"].masked_fill((tseg == 0)[:, None, :],
                                              float("nan"))
    gc["v_scale"] = gc["v_scale"].masked_fill(~tgv[:, None, :], float("inf"))
    got = fold_attend_plain(tq, pc, tseg, gc, tgv, 4, True, tcand)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_argument_checks():
    q, prompt, seg, gen, gv, cand = _inputs("bf16", 2, 4, 4, 20, 8, False,
                                            jnp.float32)
    tq, tseg, tgv = tree.to_torch([q, seg, gv], device="cpu")
    pc = _layer(tree.to_torch(prompt, device="cpu"), 0)
    gc = _layer(tree.to_torch(gen, device="cpu"), 0)
    with pytest.raises(ValueError, match="fold_k"):
        fold_attend_plain(tq, pc, tseg, gc, tgv, fold_k=3)
    with pytest.raises(ValueError, match="gen rows"):
        fold_attend_plain(tq, pc, tseg, gc, tgv, fold_k=2, shared_gen=True)
    with pytest.raises(ValueError, match="shared_gen"):
        fold_attend_plain(tq, pc, tseg, gc, tgv, fold_k=2,
                          candidates=(tq[:, :, :4], tq[:, :, :4]))
    with pytest.raises(ValueError, match="beam_route"):
        decode_attend_layer(tq.reshape(4, 1, 4, D), pc, tseg, gc, tgv,
                            beam_k=2, beam_route="folded")
    with pytest.raises(ValueError, match="beam_k=3"):
        decode_attend_plain(tq.reshape(4, 1, 4, D), pc, tseg, gc, tgv,
                            beam_k=3)
