"""Beam search in the port (halva_tpu_torch/ops/beam.py) against the
reference's (halva_tpu/ops/beam.py) on LLAVA_TINY fp32: the same seeded
prompts, images and weights give the same tokens and the same content-token
counts, exactly. Covered: K = 2 and 4, length_penalty 1.0 and 2.0, an eos
that fires mid-stream, the budget finalize (no eos), a dead pad row, a
vocabulary smaller than the 2K candidates per beam (exact ties of -1e9
everywhere: the order among equals must be the reference's), and int8 and
int4 KV caches as a smoke (quantized caches round differently in the two
frameworks, so only shapes, counts and the budget are held there)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.constants import IMAGE_TOKEN_INDEX
from halva_tpu.ops import beam as jbeam
from halva_tpu_torch.ops import beam

from test_torch_tree import port_cfg, shared_trees

torch.set_num_threads(2)

MAX_NEW = 8


def _inputs(cfg, vocab_hi, seed=5):
    rng = np.random.RandomState(seed)
    b, s = 3, 12
    ids = rng.randint(1, vocab_hi, (b, s)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    lens = np.array([12, 0, 9], np.int32)  # row 1 is a dead pad row
    for r, n in enumerate(lens):
        ids[r, n:] = 0
    size = cfg.vision.image_size
    imgs = rng.randn(b, 3, size, size).astype(np.float32)
    return ids, imgs, lens


def _both(cfg, trees, inputs, k, lp, eos, max_new=MAX_NEW):
    jp, tp = trees
    ids, imgs, lens = inputs
    want_tok, want_num = jbeam.generate_beam(
        jp, cfg, jnp.asarray(ids), jnp.asarray(imgs), jnp.asarray(lens),
        max_new_tokens=max_new, eos_id=eos, num_beams=k, length_penalty=lp,
        attn_impl="xla")
    with torch.inference_mode():
        got_tok, got_num = beam.generate_beam(
            tp, port_cfg(cfg), torch.from_numpy(ids), torch.from_numpy(imgs),
            torch.from_numpy(lens), max_new_tokens=max_new, eos_id=eos,
            num_beams=k, length_penalty=lp)
    assert got_tok.dtype == torch.int32 and got_tok.shape == (3, max_new)
    return (got_tok.numpy(), got_num.numpy(), np.asarray(want_tok),
            np.asarray(want_num))


@pytest.fixture(scope="module")
def tiny():
    return shared_trees(), _inputs(LLAVA_TINY, 250)


@pytest.mark.parametrize("lp", [1.0, 2.0])
@pytest.mark.parametrize("k", [2, 4])
def test_beam_token_exact_budget_finalize(tiny, k, lp):
    """No eos in reach: every hypothesis finishes on the budget."""
    got_tok, got_num, want_tok, want_num = _both(
        LLAVA_TINY, *tiny, k, lp, eos=-1)
    np.testing.assert_array_equal(got_tok, want_tok)
    np.testing.assert_array_equal(got_num, want_num)
    assert want_num[0] == MAX_NEW and want_num[1] == 0  # dead row: empty


@pytest.mark.parametrize("lp", [1.0, 2.0])
@pytest.mark.parametrize("k", [2, 4])
def test_beam_token_exact_with_mid_stream_eos(tiny, k, lp):
    """An eos the search really meets: the third token of row 0's best
    budget hypothesis, so hypotheses finish at different steps."""
    free, _, _, _ = _both(LLAVA_TINY, *tiny, k, lp, eos=-1)
    eos = int(free[0, 2])
    got_tok, got_num, want_tok, want_num = _both(
        LLAVA_TINY, *tiny, k, lp, eos=eos)
    np.testing.assert_array_equal(got_tok, want_tok)
    np.testing.assert_array_equal(got_num, want_num)
    assert (want_tok == eos).any()


@pytest.mark.parametrize("k", [2, 4])
def test_beam_ties_small_vocabulary(k):
    """V = 6 < 2K for K = 4: the frontier, the finished set and the demoted
    candidates all hold exact ties of -1e9; the hypotheses agree only if
    equal scores keep the reference's (lowest index first) order."""
    cfg = dataclasses.replace(
        LLAVA_TINY, llm=dataclasses.replace(LLAVA_TINY.llm, vocab_size=6))
    trees = shared_trees(cfg)
    inputs = _inputs(cfg, 6)
    for eos in (-1, 3):
        got_tok, got_num, want_tok, want_num = _both(
            cfg, trees, inputs, k, 1.0, eos=eos)
        np.testing.assert_array_equal(got_tok, want_tok)
        np.testing.assert_array_equal(got_num, want_num)


def test_top_k_stable_orders_equal_values_by_index():
    x = torch.tensor([[1.0, -1e9, 3.0, -1e9, 3.0, -1e9]])
    vals, idx = beam.top_k_stable(x, 5)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    assert idx.tolist() == [[2, 4, 0, 1, 3]]


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_beam_quantized_kv_smoke(tiny, kv_quant):
    (_, tp), (ids, imgs, lens) = tiny
    with torch.inference_mode():
        tok, num = beam.generate_beam(
            tp, port_cfg(LLAVA_TINY), torch.from_numpy(ids),
            torch.from_numpy(imgs), torch.from_numpy(lens),
            max_new_tokens=MAX_NEW, eos_id=-1, num_beams=2,
            kv_quant=kv_quant)
        grid, _ = beam.generate_beam(
            tp, port_cfg(LLAVA_TINY), torch.from_numpy(ids),
            torch.from_numpy(imgs), torch.from_numpy(lens),
            max_new_tokens=MAX_NEW, eos_id=-1, num_beams=2,
            kv_quant=kv_quant, beam_route="grid")
    assert tok.shape == (3, MAX_NEW) and num.tolist() == [MAX_NEW, 0, MAX_NEW]
    assert (tok[1] == -1).all()
    torch.testing.assert_close(tok, grid, rtol=0, atol=0)


def test_beam_argument_checks_and_stats(tiny):
    (_, tp), (ids, imgs, lens) = tiny
    args = (tp, port_cfg(LLAVA_TINY), torch.from_numpy(ids),
            torch.from_numpy(imgs), torch.from_numpy(lens))
    with pytest.raises(ValueError, match="num_beams >= 2"):
        beam.generate_beam(*args, max_new_tokens=4, eos_id=-1, num_beams=1)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        beam.generate_beam(*args, max_new_tokens=4, eos_id=-1, num_beams=2,
                           mesh=object())
    stats = {}
    with torch.inference_mode():
        beam.generate_beam(*args, max_new_tokens=4, eos_id=-1, num_beams=2,
                           stats=stats)
    assert stats["steps"] == 4
    assert torch.isfinite(stats["best_scores"]).all()
    assert stats["best_scores"][1] == beam.NEG_INF  # the dead row


def test_reorder_gen_cache_takes_parent_rows():
    # (L, B*K, KVH, Sg, D) leaves, B=2 items of K=3 beams
    rng = np.random.RandomState(3)
    cache = {"k": torch.from_numpy(rng.randn(2, 6, 1, 4, 2).astype(np.float32)),
             "k_scale": torch.from_numpy(
                 rng.randn(2, 6, 1, 4).astype(np.float32))}
    parent = torch.tensor([[2, 0, 0], [1, 1, 2]])
    rows = [2, 0, 0, 4, 4, 5]
    out = beam.reorder_gen_cache(cache, parent)
    for key, t in cache.items():
        torch.testing.assert_close(out[key], t[:, rows], rtol=0, atol=0)


def _beam_int4_route(tiny, monkeypatch, group_size):
    """Beam tokens on a packed-int4 tree with the row rule at W4_GEMV_MAX_ROWS
    and at 1, and the row counts that reached w4_gemm (K7's wrapper)."""
    from halva_tpu.ops.w4_matmul import quantize_params_int4_host
    from halva_tpu_torch import tree
    from halva_tpu_torch.ops import w4_matmul

    from test_torch_tree import jax_tree

    (_, _), (ids, imgs, lens) = tiny
    tp = tree.to_torch(quantize_params_int4_host(jax_tree(LLAVA_TINY),
                                                 group_size=group_size),
                       device="cpu")

    def run():
        with torch.inference_mode():
            return beam.generate_beam(
                tp, port_cfg(LLAVA_TINY), torch.from_numpy(ids),
                torch.from_numpy(imgs), torch.from_numpy(lens),
                max_new_tokens=MAX_NEW, eos_id=-1, num_beams=2,
                kv_quant="int4", attn_impl="kernel")

    # "kernel" named: at LLAVA_TINY's head dim "auto" takes the plain route
    want_tok, want_num = run()
    calls = []
    real = w4_matmul.w4_gemm
    monkeypatch.setattr(w4_matmul, "W4_GEMV_MAX_ROWS", 1)
    monkeypatch.setattr(w4_matmul, "w4_gemm",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    tok, num = run()
    torch.testing.assert_close(tok, want_tok, rtol=0, atol=0)
    torch.testing.assert_close(num, want_num, rtol=0, atol=0)
    return calls, ids.shape[0]


def test_beam_on_int4_tree_row_rule_changes_no_token(tiny, monkeypatch):
    """A packed-int4 tree under beam search: with the row rule at 1 every
    beam step's B * K rows take w4_gemm (K7's wrapper); the tokens equal
    those of the K6 route exactly (one arithmetic on CPU tensors). Scale
    groups of 64 rows, which K7 takes at LLAVA_TINY's K of 64 and 128 (at
    32 rows a group, `w4_route` keeps them on K6: the test below)."""
    calls, b = _beam_int4_route(tiny, monkeypatch, group_size=64)
    layers = LLAVA_TINY.llm.num_layers
    assert calls and set(calls) == {b * 2}
    assert len(calls) % (7 * layers) == 0


def test_beam_on_int4_group32_tree_stays_on_k6(tiny, monkeypatch):
    """Scale groups of 32 rows, which K7 refuses: `w4_route` sends every
    beam step's matmuls to K6 whatever the row rule, and the tokens are
    those of the K6 route (on the card K7's wrapper used to raise here)."""
    calls, _ = _beam_int4_route(tiny, monkeypatch, group_size=32)
    assert calls == []
