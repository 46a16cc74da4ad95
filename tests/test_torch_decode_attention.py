"""K4 in the port (halva_tpu_torch/ops/decode_attention.py) against the
reference's Pallas decode kernel (interpret mode on the CPU, as
tests/test_decode_attention.py runs it) and its XLA oracle
llama._decode_attend: bf16 prompt and gen caches at the shapes the
reference's own tests use (MHA, GQA, a prompt shorter than one block, a
single valid gen slot), and int8-prompt/int8-gen and int4-prompt/int8-gen
caches (MHA and GQA, odd and even prompt lengths, a padded prompt row),
each also at Gemma's head dim 256 with 8 query heads over 1 kv head,
the int4 oracle fed the even/odd view as tests/test_kv4.py feeds it. On CPU
tensors the port's wrapper takes its plain version.

Tolerances: with an fp32 query every operand is exact in fp32 on both
sides, so rtol = atol = 1e-5 (int8/int4: atol 1e-4, the scales put the
outputs at a few units and the even/odd and per-block orders differ). With
a bf16 query the outputs are rounded to bf16 and may differ by one bf16
step: rtol = 2^-7 (one step just above a power of two), atol = 8e-3 near
zero; quantized caches also round probability * v scale to bf16 before the
PV product, the Pallas kernel unnormalized and the oracle normalized, so
rtol = 2^-6, atol = 2e-2 there. Every row here is live (gen slot 0 is
always visible, as in decode): on a row with no visible key the Pallas
kernel gives 0 and the oracle a uniform average."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.models.llama import _decode_attend as jax_decode_attend
from halva_tpu.models.llama import _unpack_kv4 as jax_unpack_kv4
from halva_tpu.ops.decode_attention import decode_attend_layer as jax_layer
from halva_tpu.ops.decode_attention import seg_even_odd as jax_seg_even_odd
from halva_tpu_torch import tree
from halva_tpu_torch.ops.decode_attention import (
    decode_attend_layer,
    decode_attend_plain,
    seg_even_odd,
    unpack_kv4,
)

torch.set_num_threads(2)

# name: (b, h, kvh, sp, d, sg, gen steps per row, dead prompt row)
CASES = {
    "mha": (2, 8, 8, 300, 64, 16, (3, 7), False),
    "gqa": (2, 8, 2, 300, 64, 16, (3, 7), False),
    "short_prompt": (2, 8, 8, 130, 64, 16, (5, 1), True),
    "single_gen_slot": (2, 8, 8, 300, 64, 16, (0, 0), False),
    # Gemma's head dim and grouping: 8 query heads over 1 kv head, D = 256
    "gemma_g8_d256": (2, 8, 1, 300, 256, 16, (3, 7), False),
}


def _inputs(b, h, kvh, sp, d, sg, steps, dead_row, q_dtype, seed=0):
    rng = np.random.RandomState(seed)
    layers = 2

    def bf16(*shape):
        return np.asarray(jnp.asarray(rng.randn(*shape), jnp.bfloat16))

    q = np.asarray(jnp.asarray(rng.randn(b, 1, h, d), q_dtype))
    kp, vp = bf16(layers, b, kvh, sp, d), bf16(layers, b, kvh, sp, d)
    kg, vg = bf16(layers, b, kvh, sg, d), bf16(layers, b, kvh, sg, d)
    seg = np.ones((b, sp), np.int32)
    seg[0, sp - 50:] = 0
    seg[1, sp // 3:] = 0
    if dead_row:
        seg[1] = 0  # only its gen slots stay visible
    gv = np.arange(sg)[None, :] <= np.asarray(steps)[:, None]
    return q, kp, vp, kg, vg, seg, gv


@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_reference(name, q_dtype):
    b, h, kvh, sp, d, sg, steps, dead_row = CASES[name]
    jdt = jnp.float32 if q_dtype == "f32" else jnp.bfloat16
    arrays = _inputs(b, h, kvh, sp, d, sg, steps, dead_row, jdt)
    q, kp, vp, kg, vg, seg, gv = arrays
    tq, tkp, tvp, tkg, tvg, tseg, tgv = tree.to_torch(list(arrays), device="cpu")
    tol = dict(rtol=1e-5, atol=1e-5) if q_dtype == "f32" else dict(
        rtol=2**-7, atol=8e-3)
    for li in range(kp.shape[0]):
        got = decode_attend_layer(
            tq, {"k": tkp[li], "v": tvp[li]}, tseg,
            {"k": tkg[li], "v": tvg[li]}, tgv,
        )
        assert got.dtype == tq.dtype and got.shape == (b, 1, h, d)
        got = got.float().numpy()
        pallas = np.asarray(jax_layer(
            jnp.asarray(q), {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
            jnp.asarray(seg), {"k": jnp.asarray(kg), "v": jnp.asarray(vg)},
            jnp.asarray(gv), jnp.int32(li),
        ), np.float32)
        oracle = np.asarray(jax.jit(jax_decode_attend)(
            jnp.asarray(q), jnp.asarray(kp[li]), jnp.asarray(vp[li]),
            jnp.asarray(kg[li]), jnp.asarray(vg[li]), jnp.asarray(seg),
            jnp.asarray(gv),
        ), np.float32)
        np.testing.assert_allclose(got, oracle, **tol)
        np.testing.assert_allclose(got, pallas, **tol)


def test_cpu_wrapper_is_the_plain_version():
    arrays = _inputs(2, 8, 2, 40, 16, 8, (2, 5), False, jnp.float32)
    q, kp, vp, kg, vg, seg, gv = tree.to_torch(list(arrays), device="cpu")
    pc, gc = {"k": kp[0], "v": vp[0]}, {"k": kg[0], "v": vg[0]}
    torch.testing.assert_close(
        decode_attend_layer(q, pc, seg, gc, gv),
        decode_attend_plain(q, pc, seg, gc, gv), rtol=0, atol=0,
    )


# name: (prompt format, b, h, kvh, sp, d, sg, gen steps per row)
QCASES = {
    "int8_mha_odd": ("int8", 2, 4, 4, 301, 128, 16, (3, 7)),
    "int8_gqa_even": ("int8", 2, 8, 2, 300, 128, 16, (0, 9)),
    "int4_mha_odd": ("int4", 2, 4, 4, 301, 128, 16, (3, 7)),
    "int4_gqa_even": ("int4", 2, 8, 2, 300, 128, 16, (5, 0)),
    "int8_g8_d256": ("int8", 2, 8, 1, 301, 256, 16, (3, 7)),
    "int4_g8_d256": ("int4", 2, 8, 1, 301, 256, 16, (5, 0)),
}


def _quant_inputs(fmt, b, h, kvh, sp, d, sg, steps, q_dtype, seed=0):
    """Stacked (2-layer) int8 or int4 prompt caches and int8 gen caches of
    random bytes (-8 nibbles included) with bf16 scales that put the
    dequantized values near unit size; row 1 of the prompt is padded."""
    rng = np.random.RandomState(seed)
    layers = 2

    def bf16(x):
        return np.asarray(jnp.asarray(x, jnp.bfloat16))

    def int8(*shape):
        return np.clip(np.round(rng.randn(*shape) * 40), -127,
                       127).astype(np.int8)

    q = np.asarray(jnp.asarray(rng.randn(b, 1, h, d), q_dtype))
    if fmt == "int4":
        s2 = -(-sp // 2)
        prompt = {
            "k4": rng.randint(-128, 128, (layers, b, kvh, s2, d)).astype(
                np.int8),
            "v4": rng.randint(-128, 128, (layers, b, kvh, s2, d)).astype(
                np.int8),
            "k_scale": bf16(rng.uniform(0.1, 0.3, (layers, b, 2, kvh, s2))),
            "v_scale": bf16(rng.uniform(0.1, 0.3, (layers, b, 2, kvh, s2))),
        }
    else:
        prompt = {
            "k": int8(layers, b, kvh, sp, d), "v": int8(layers, b, kvh, sp, d),
            "k_scale": bf16(rng.uniform(0.01, 0.04, (layers, b, kvh, sp))),
            "v_scale": bf16(rng.uniform(0.01, 0.04, (layers, b, kvh, sp))),
        }
    gen = {
        "k": int8(layers, b, kvh, sg, d), "v": int8(layers, b, kvh, sg, d),
        "k_scale": bf16(rng.uniform(0.01, 0.04, (layers, b, kvh, sg))),
        "v_scale": bf16(rng.uniform(0.01, 0.04, (layers, b, kvh, sg))),
    }
    seg = np.ones((b, sp), np.int32)
    seg[0, sp - 50:] = 0
    seg[1, sp // 3:] = 0
    gv = np.arange(sg)[None, :] <= np.asarray(steps)[:, None]
    return q, prompt, seg, gen, gv


def _oracle(q, prompt, seg, gen, gv, li):
    """llama._decode_attend as the reference's generic decode scan calls it
    (the int4 cache as its even/odd int8 view)."""
    if "k4" in prompt:
        klo, khi = jax_unpack_kv4(jnp.asarray(prompt["k4"][li]))
        vlo, vhi = jax_unpack_kv4(jnp.asarray(prompt["v4"][li]))
        kp = jnp.concatenate([klo, khi], axis=2).astype(jnp.int8)
        vp = jnp.concatenate([vlo, vhi], axis=2).astype(jnp.int8)
        ks, vs = prompt["k_scale"][li], prompt["v_scale"][li]
        kps = np.concatenate([ks[:, 0], ks[:, 1]], axis=2)
        vps = np.concatenate([vs[:, 0], vs[:, 1]], axis=2)
        seg_in = jax_seg_even_odd(jnp.asarray(seg)).reshape(seg.shape[0], -1)
    else:
        kp, vp = prompt["k"][li], prompt["v"][li]
        kps, vps = prompt["k_scale"][li], prompt["v_scale"][li]
        seg_in = seg
    return np.asarray(jax.jit(jax_decode_attend)(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(gen["k"][li]), jnp.asarray(gen["v"][li]),
        jnp.asarray(seg_in), jnp.asarray(gv),
        kp_scale=jnp.asarray(kps), vp_scale=jnp.asarray(vps),
        kg_scale=jnp.asarray(gen["k_scale"][li]),
        vg_scale=jnp.asarray(gen["v_scale"][li]),
    ), np.float32)


@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(QCASES))
def test_quantized_caches_match_reference(name, q_dtype):
    fmt, b, h, kvh, sp, d, sg, steps = QCASES[name]
    jdt = jnp.float32 if q_dtype == "f32" else jnp.bfloat16
    q, prompt, seg, gen, gv = _quant_inputs(fmt, b, h, kvh, sp, d, sg,
                                            steps, jdt)
    tq, tseg, tgv = tree.to_torch([q, seg, gv], device="cpu")
    tprompt, tgen = tree.to_torch(prompt, device="cpu"), tree.to_torch(gen, device="cpu")
    tol = dict(rtol=1e-5, atol=1e-4) if q_dtype == "f32" else dict(
        rtol=2**-6, atol=2e-2)
    for li in (0, 1):
        got = decode_attend_layer(
            tq, {k: v[li] for k, v in tprompt.items()}, tseg,
            {k: v[li] for k, v in tgen.items()}, tgv)
        assert got.dtype == tq.dtype and got.shape == (b, 1, h, d)
        got = got.float().numpy()
        pallas = np.asarray(jax_layer(
            jnp.asarray(q), jax.tree.map(jnp.asarray, prompt),
            jnp.asarray(seg), jax.tree.map(jnp.asarray, gen),
            jnp.asarray(gv), jnp.int32(li),
        ), np.float32)
        np.testing.assert_allclose(got, _oracle(q, prompt, seg, gen, gv, li),
                                   **tol)
        np.testing.assert_allclose(got, pallas, **tol)


@pytest.mark.parametrize("sp", [9, 10])
def test_even_odd_helpers_match_reference(sp):
    rng = np.random.RandomState(sp)
    seg = rng.randint(0, 3, (2, sp)).astype(np.int32)
    np.testing.assert_array_equal(
        seg_even_odd(torch.from_numpy(seg)).numpy(),
        np.asarray(jax_seg_even_odd(jnp.asarray(seg))))
    packed = rng.randint(-128, 128, (2, 3, 5, 4)).astype(np.int8)
    for got, want in zip(unpack_kv4(torch.from_numpy(packed)),
                         jax_unpack_kv4(jnp.asarray(packed))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_garbage_scales_of_masked_keys_do_not_leak():
    """A masked key contributes exactly 0 whatever its scale holds (the
    plain version selects, as the kernel must)."""
    q, prompt, seg, gen, gv = _quant_inputs(
        "int8", 2, 4, 4, 40, 128, 16, (2, 3), jnp.float32)
    tq, tseg, tgv = tree.to_torch([q, seg, gv], device="cpu")
    pc = {k: v[0] for k, v in tree.to_torch(prompt, device="cpu").items()}
    gc = {k: v[0] for k, v in tree.to_torch(gen, device="cpu").items()}
    want = decode_attend_plain(tq, pc, tseg, gc, tgv)
    dead = (tseg == 0)[:, None, :]
    pc["v_scale"] = pc["v_scale"].masked_fill(dead, float("nan"))
    gc["v_scale"] = gc["v_scale"].masked_fill(~tgv[:, None, :], float("inf"))
    got = decode_attend_plain(tq, pc, tseg, gc, tgv)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- K4's key-axis split: the launch plan, and the split-then-merge plain
# version held against the reference under forced plans

from halva_tpu_torch import _kernels  # noqa: E402
from halva_tpu_torch.ops.decode_attention import (  # noqa: E402
    TILE,
    decode_attend_split_plain,
    decode_plan,
    split_ranges,
)

# (rows, kvh, sp, sg, int4 prompt, sms, forced aim)
PLAN_CASES = {
    "llava_b4": (4, 32, 623, 128, False, 132, None),
    "llava_b4_int4": (4, 32, 623, 128, True, 132, None),
    "llava_b80_int4": (80, 32, 623, 128, True, 132, None),
    "llava_beams": (16, 32, 623, 128, True, 132, None),
    "mistral_b4": (4, 8, 623, 128, False, 132, None),
    "gemma_b4": (4, 1, 623, 128, False, 132, None),
    "gemma_beams_int4": (16, 1, 623, 128, True, 132, None),
    "odd_int4": (2, 8, 301, 128, True, 132, None),
    "prompt_under_a_tile": (2, 8, 40, 16, False, 132, None),
    "no_gen_span": (2, 4, 300, 0, False, 132, None),
    "no_prompt": (2, 4, 0, 128, True, 132, None),
    "long_prompt": (1, 1, 4097, 256, True, 132, None),
    "small_card": (4, 32, 623, 128, True, 8, None),
    "forced_1": (2, 8, 517, 128, True, 132, 1),
    "forced_2": (2, 8, 517, 128, True, 132, 2),
    "forced_5": (2, 8, 517, 128, True, 132, 5),
    "forced_past_the_tiles": (2, 8, 517, 128, True, 132, 64),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_split_plan_covers_every_key_once(name):
    rows, kvh, sp, sg, int4, sms, forced = PLAN_CASES[name]
    plan = decode_plan(rows, kvh, sp, sg, sms, forced)
    splits, tps = plan
    ranges = split_ranges(plan, sp, sg)
    assert len(ranges) == splits >= 1
    assert all(ranges) or sp == sg == 0, "an empty split"
    seen = {"prompt": np.zeros(sp, int), "gen": np.zeros(sg, int)}
    for mine in ranges:
        for span, lo, hi in mine:
            assert lo < hi
            seen[span][lo:hi] += 1
            if span == "prompt":
                assert lo % TILE == 0 and (hi % TILE == 0 or hi == sp)
                if int4:  # a boundary never splits a packed token pair
                    assert lo % 2 == 0 and (hi % 2 == 0 or hi == sp)
    assert (seen["prompt"] == 1).all() and (seen["gen"] == 1).all()
    # the gen span is whole, in the last split, and alone there if split
    gens = [i for i, mine in enumerate(ranges) for s, _, _ in mine
            if s == "gen"]
    assert gens == ([splits - 1] if sg else [])
    if splits > 1 and sg:
        assert ranges[-1] == [("gen", 0, sg)]
        assert rows * kvh <= _kernels.MAX_TICKETS
    if forced is not None:
        assert splits <= max(forced, 1)


def test_split_plan_fills_the_card_or_stays_whole():
    """At B=4 the 7B shape (128 (row, kv head) pairs) splits until at least
    three blocks fall to every one of 132 SMs; at batch 80 (2,560 pairs) it
    does not split."""
    splits, _ = decode_plan(4, 32, 623, 128, 132)
    assert splits > 1 and 4 * 32 * splits >= 3 * 132
    assert decode_plan(80, 32, 623, 128, 132) == (1, 10)
    assert decode_plan(80, 32, 623, 128, 132, splits=1) == (1, 10)
    with pytest.raises(ValueError):
        decode_plan(4, 32, 623, 128, 132, splits=0)


SPLIT_MODES = {  # mode: (b, h, kvh, sp, d, sg)
    "bf16": (3, 8, 2, 517, 64, 16),
    "int8": (3, 4, 4, 517, 128, 16),
    "int4": (3, 8, 2, 517, 128, 16),
}


@functools.lru_cache(maxsize=None)
def _split_case(mode, q_dtype):
    """Inputs (row 0 with prompt tile [64, 128) masked, so a whole split of
    a fine plan sees no prompt key; row 2 with no visible key at all) and
    the reference's outputs: the oracle on the live rows, the Pallas kernel
    (interpret mode) on every row."""
    b, h, kvh, sp, d, sg = SPLIT_MODES[mode]
    jdt = jnp.float32 if q_dtype == "f32" else jnp.bfloat16
    steps = (3, 7, 0)
    if mode == "bf16":
        q, kp, vp, kg, vg, seg, gv = _inputs(b, h, kvh, sp, d, sg, steps,
                                             False, jdt)
        prompt, gen = {"k": kp, "v": vp}, {"k": kg, "v": vg}
    else:
        q, prompt, seg, gen, gv = _quant_inputs(mode, b, h, kvh, sp, d, sg,
                                                steps, jdt)
    seg[0, 64:128] = 0
    seg[2] = 0
    gv[2] = False
    pallas = np.asarray(jax_layer(
        jnp.asarray(q), jax.tree.map(jnp.asarray, prompt), jnp.asarray(seg),
        jax.tree.map(jnp.asarray, gen), jnp.asarray(gv), jnp.int32(0)),
        np.float32)
    oracle = _oracle(q, prompt, seg, gen, gv, 0) if mode != "bf16" else (
        np.asarray(jax.jit(jax_decode_attend)(
            jnp.asarray(q), jnp.asarray(prompt["k"][0]),
            jnp.asarray(prompt["v"][0]), jnp.asarray(gen["k"][0]),
            jnp.asarray(gen["v"][0]), jnp.asarray(seg), jnp.asarray(gv)),
            np.float32))
    return q, prompt, seg, gen, gv, pallas, oracle


@pytest.mark.parametrize("forced", list(range(1, 9)))
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", list(SPLIT_MODES))
def test_split_then_merge_matches_reference(mode, q_dtype, forced):
    """The plain split-then-merge version under forced plans of 1 to 8
    splits (at most the 9 prompt tiles and the gen span allow) against the
    oracle on the live rows and the Pallas kernel on every row: the row
    with no visible key comes out as exactly 0, as both kernels give it.
    Tolerances as in test_plain_matches_reference and
    test_quantized_caches_match_reference: the merge is exact algebra, only
    the fp32 summation order differs."""
    q, prompt, seg, gen, gv, pallas, oracle = _split_case(mode, q_dtype)
    b, _, _, sp, _, sg = SPLIT_MODES[mode]
    plan = decode_plan(b, prompt["k4" if mode == "int4" else "k"].shape[2],
                       sp, sg, 132, forced)
    tq, tseg, tgv = tree.to_torch([q, seg, gv], device="cpu")
    tprompt = {k: v[0] for k, v in tree.to_torch(prompt,
                                                  device="cpu").items()}
    tgen = {k: v[0] for k, v in tree.to_torch(gen, device="cpu").items()}
    got = decode_attend_split_plain(tq, tprompt, tseg, tgen, tgv, plan)
    assert got.dtype == tq.dtype and got.shape == q.shape
    got = got.float().numpy()
    if q_dtype == "f32":
        tol = dict(rtol=1e-5, atol=1e-5 if mode == "bf16" else 1e-4)
    else:
        tol = dict(rtol=2**-7, atol=8e-3) if mode == "bf16" else dict(
            rtol=2**-6, atol=2e-2)
    assert (got[2] == 0).all()
    np.testing.assert_allclose(got, pallas, **tol)
    np.testing.assert_allclose(got[:2], oracle[:2], **tol)


@pytest.mark.parametrize("forced", [1, 3, 8])
@pytest.mark.parametrize("mode", list(SPLIT_MODES))
def test_split_then_merge_beam_mode(mode, forced):
    """Beam mode (2 beams an item, the prompt stored once per item): the
    split version against decode_attend_plain(beam_k), fp32 queries."""
    q, prompt, seg, gen, gv, _, _ = _split_case(mode, "f32")
    b, h, kvh, sp, d, sg = SPLIT_MODES[mode]
    rng = np.random.RandomState(1)
    tq = torch.from_numpy(rng.randn(2 * b, 1, h, d).astype(np.float32))
    tseg = torch.from_numpy(seg)
    tgv = torch.from_numpy(np.repeat(gv, 2, axis=0))
    tgv[1] = False  # a beam with an empty gen cache
    tprompt = {k: v[0] for k, v in tree.to_torch(prompt,
                                                  device="cpu").items()}
    tgen = {k: v[0].repeat_interleave(2, dim=0)
            for k, v in tree.to_torch(gen, device="cpu").items()}
    plan = decode_plan(2 * b, kvh, sp, sg, 132, forced)
    got = decode_attend_split_plain(tq, tprompt, tseg, tgen, tgv, plan,
                                    beam_k=2)
    want = decode_attend_plain(tq, tprompt, tseg, tgen, tgv, beam_k=2)
    live = slice(0, 2 * b - 2)  # the last item sees no key
    assert (got[live.stop:] == 0).all()
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=1e-4)
