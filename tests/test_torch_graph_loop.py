"""The decode loops as bodies over a state of device tensors
(halva_tpu_torch/ops/graph_loop.py), on the CPU, where the bodies run
eagerly (the card replays them from CUDA graphs:
tests/test_torch_cuda_kernels.py holds the two against each other there).

- `decode_step`, `decode_positions` and the beam `select_step` with the
  step as a 0-d tensor equal them with the step as a host int, exactly;
- greedy, beam search (length_penalty 1.0 and 0.7) and speculative decode
  stay token-exact against the JAX package on LLAVA_TINY fp32;
- the beam penalty table equals the reference's fp32 `gen_len **
  length_penalty`, bit for bit;
- `run_loop`: the stop rule, bodies in turn, a graph asked for on the CPU
  raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.constants import IMAGE_TOKEN_INDEX
from halva_tpu.ops import beam as jbeam
from halva_tpu.ops import generate as jgenerate
from halva_tpu.ops import speculative as jspec
from halva_tpu_torch.models import llama
from halva_tpu_torch.ops import beam, generate, graph_loop, speculative

from test_torch_tree import port_cfg, shared_trees

torch.set_num_threads(2)

TCFG = port_cfg(LLAVA_TINY)


def _inputs(seed=5):
    rng = np.random.RandomState(seed)
    b, s = 3, 12
    ids = rng.randint(1, 250, (b, s)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    lens = np.array([12, 0, 9], np.int32)  # row 1 is a dead pad row
    for r, n in enumerate(lens):
        ids[r, n:] = 0
    size = LLAVA_TINY.vision.image_size
    imgs = rng.randn(b, 3, size, size).astype(np.float32)
    return ids, imgs, lens


@pytest.fixture(scope="module")
def trees():
    return shared_trees()


def _prompt(tp, kv_quant):
    ids, imgs, lens = (torch.from_numpy(a) for a in _inputs())
    with torch.inference_mode():
        return generate._prefill_impl(tp, TCFG, ids, imgs, lens,
                                      kv_quant=kv_quant)


@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
@pytest.mark.parametrize("beam_k", [1, 2])
def test_decode_step_tensor_step_equals_int_step(trees, kv_quant, beam_k):
    _, tp = trees
    first_tok, _, slen, pc, pseg = _prompt(tp, kv_quant)
    b = first_tok.shape[0] * beam_k
    tok = first_tok.repeat_interleave(beam_k)[:, None]
    pos = slen.repeat_interleave(beam_k) + 3
    out = []
    with torch.inference_mode():
        for step in (3, torch.tensor(3)):
            gen = generate.init_gen_cache_like(TCFG.llm, b, 8, pc)
            fill = torch.Generator().manual_seed(1)
            for key in sorted(gen):  # earlier slots hold something
                gen[key].copy_(torch.randn(gen[key].shape, generator=fill))
            emb = llama.embed(tp["llm"], tok)
            logits, gen = llama.decode_step(
                tp["llm"], TCFG.llm, emb, pos, pc, pseg, gen, step,
                beam_k=beam_k)
            out.append((logits, gen))
    (want, want_gen), (got, got_gen) = out
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for key in want_gen:
        torch.testing.assert_close(got_gen[key], want_gen[key], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("alibi,window", [(True, None), (False, 16)])
def test_decode_positions_tensor_step_equals_int_step(alibi, window):
    cfg = dataclasses.replace(
        TCFG.llm, position_embedding="alibi" if alibi else "rope",
        sliding_window=window)
    rng = np.random.RandomState(0)
    positions = torch.from_numpy(rng.randint(9, 14, (4,)).astype(np.int32))
    prompt_seg = torch.ones((2, 12), dtype=torch.int32)
    gen_valid = (torch.arange(8) <= 5).expand(4, 8).contiguous()
    want = llama.decode_positions(cfg, positions, prompt_seg, gen_valid, 5,
                                  beam_k=2)
    got = llama.decode_positions(cfg, positions, prompt_seg, gen_valid,
                                 torch.tensor(5), beam_k=2)
    assert got[4] == want[4]  # pos_ok: from shapes alone
    for g, w in zip(got[:4], want[:4]):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("lp", [1.0, 0.7])
def test_select_step_tensor_step_equals_int_step(lp):
    b, k, v, max_new = 3, 4, 11, 6
    rng = np.random.RandomState(3)
    slen = torch.tensor([5, 0, 7])
    state = beam.init_beam_state(b, k, max_new, slen)
    table = beam.penalty_table(max_new, lp, "cpu")
    for step in range(max_new):
        logits = torch.from_numpy(rng.randn(b * k, v).astype(np.float32))
        want, wp = beam.select_step(state, logits, step, 2, table)
        got, gp = beam.select_step(state, logits, torch.tensor(step), 2,
                                   table)
        torch.testing.assert_close(gp, wp, rtol=0, atol=0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        state = want


def _port_run(tp, kind, lp, eos, max_new):
    ids, imgs, lens = (torch.from_numpy(a) for a in _inputs())
    loop_stats = {}
    with torch.inference_mode():
        if kind == "greedy":
            tok, num = generate.generate_greedy(
                tp, TCFG, ids, imgs, lens, max_new_tokens=max_new,
                eos_id=eos, loop_stats=loop_stats)
        elif kind == "beam":
            tok, num = beam.generate_beam(
                tp, TCFG, ids, imgs, lens, max_new_tokens=max_new,
                eos_id=eos, num_beams=4, length_penalty=lp,
                loop_stats=loop_stats)
        else:
            tok, num, _ = speculative.generate_speculative(
                tp, TCFG, ids, imgs, lens, max_new_tokens=max_new,
                eos_id=eos, draft_k=4, loop_stats=loop_stats)
    assert loop_stats["graph"] is False and loop_stats["capture_s"] == 0.0
    assert 1 <= loop_stats["steps"] <= max_new
    return tok.numpy(), num.numpy()


def _ref_run(jp, kind, lp, eos, max_new):
    ids, imgs, lens = (jnp.asarray(a) for a in _inputs())
    if kind == "greedy":
        tok, num = jgenerate.generate_greedy(
            jp, LLAVA_TINY, ids, imgs, lens, max_new_tokens=max_new,
            eos_id=eos, attn_impl="xla")
    elif kind == "beam":
        tok, num = jbeam.generate_beam(
            jp, LLAVA_TINY, ids, imgs, lens, max_new_tokens=max_new,
            eos_id=eos, num_beams=4, length_penalty=lp, attn_impl="xla")
    else:
        tok, num, _ = jspec.generate_speculative(
            jp, LLAVA_TINY, ids, imgs, lens, max_new_tokens=max_new,
            eos_id=eos, draft_k=4, attn_impl="xla")
    return np.asarray(tok), np.asarray(num)


@pytest.mark.parametrize("kind,lp", [("greedy", None), ("beam", 1.0),
                                     ("beam", 0.7), ("speculative", None)])
def test_loops_token_exact_with_the_reference(trees, kind, lp):
    jp, tp = trees
    # eos=-1 runs the whole budget; then an eos the model emits mid-stream
    want_tok, _ = _ref_run(jp, kind, lp, -1, 8)
    got_tok, got_num = _port_run(tp, kind, lp, -1, 8)
    np.testing.assert_array_equal(got_tok, want_tok)
    eos = int(want_tok[0, 3])
    want = _ref_run(jp, kind, lp, eos, 8)
    got = _port_run(tp, kind, lp, eos, 8)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("lp", [0.7, 1.0, 2.0])
def test_penalty_table_equals_the_references_fp32_values(lp):
    max_new = 512

    @jax.jit
    def ref_pen(step):  # halva_tpu/ops/beam.py: gen_len ** length_penalty
        gen_len = (step + 1).astype(jnp.float32)
        return gen_len ** lp

    want = np.array([np.asarray(ref_pen(jnp.int32(s)))
                     for s in range(max_new)], np.float32)
    got = beam.penalty_table(max_new, lp, "cpu")
    assert got.dtype == torch.float32 and got.shape == (max_new,)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_run_loop_stop_rule_and_bodies_in_turn():
    calls = []
    count = torch.zeros((), dtype=torch.long)

    def body(i):
        def run():
            calls.append(i)
            count.add_(1)
        return run

    stats = {}
    n = graph_loop.run_loop([body(0), body(1)], lambda: int(count) < 5, 8,
                            torch.device("cpu"), stats=stats)
    assert n == 5 and calls == [0, 1, 0, 1, 0]
    assert stats.pop("loop_s") >= stats.pop("first_step_s") > 0
    assert stats == {"steps": 5, "graph": False, "capture_s": 0.0}
    assert graph_loop.run_loop([body(0)], lambda: True, 3, "cpu") == 3
    assert graph_loop.run_loop([body(0)], lambda: False, 3, "cpu") == 0
    with pytest.raises(ValueError, match="CUDA graph"):
        graph_loop.run_loop([body(0)], lambda: True, 3, "cpu", graph=True)


def test_run_loop_kept_graphs_on_the_cpu():
    """`keep` carries a loop's graphs across calls; on the CPU the bodies
    run eagerly, so nothing is captured and every call counts its own
    steps."""
    count = torch.zeros((), dtype=torch.long)
    keep = graph_loop.LoopGraphs()
    for _ in range(3):
        stats = {}
        n = graph_loop.run_loop([lambda: count.add_(1)],
                                lambda: int(count) % 4 != 3, 8, "cpu",
                                stats=stats, keep=keep)
        assert stats["graph"] is False and stats["capture_s"] == 0.0
        assert keep.graphs is None
        count.add_(1)  # past the stop value
    assert n == 3 and int(count) == 12
