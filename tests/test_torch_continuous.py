"""Continuous batching (halva_tpu_torch/ops/continuous.py) against the JAX
package's ContinuousEngine on the CPU, on a LLAVA_TINY fp32 tree from a
numpy seed: the five cases of tests/test_continuous.py, each token for token
against the reference's engine on the same requests (and against the port's
own one-shot greedy decode of each prompt, cut to its budget).

- refills at several bucket sizes, with ring wrap;
- sub-batch refills (max_refill below the batch);
- an EOS exit freeing slots;
- int8 and int4 prompt KV;
- rows cycling through slots past Sg tokens (stale KV unseen).

Also: `_ring_valid` and `_seq_pad` against the reference's, the engine's
chunks replaying one graph state across refills (`graph_loop.LoopGraphs`
on the CPU: no capture, eager bodies), the runner's continuous path
against its drain with the reference's guards, and
`python -m halva_tpu_torch.bench_continuous` at a tiny preset.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.constants import IMAGE_TOKEN_INDEX
from halva_tpu.evals import runner as jrunner
from halva_tpu.mm_utils import ImageProcessor
from halva_tpu.ops import continuous as jcont
from halva_tpu_torch import bench_continuous
from halva_tpu_torch.evals import runner
from halva_tpu_torch.ops import continuous, generate, graph_loop

from test_data_pipeline import SPTok
from test_torch_tree import port_cfg, shared_trees

torch.set_num_threads(2)

CFG = LLAVA_TINY
TCFG = port_cfg(CFG)
PAD = 24
MAX_NEW = 16


@pytest.fixture(scope="module")
def trees():
    return shared_trees()


def _requests(module, n, seed=0):
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        s = int(rng.randint(10, PAD + 1))
        ids = rng.randint(5, 200, (s,)).astype(np.int32)
        ids[1] = IMAGE_TOKEN_INDEX
        img = rng.randn(3, CFG.vision.image_size,
                        CFG.vision.image_size).astype(np.float32)
        budget = int(rng.randint(3, MAX_NEW + 1))
        reqs.append(module.Request(ids=ids, image=img, budget=budget))
    return reqs


def _oneshot(tp, req, eos=-1, kv_quant=False):
    """The port's one-shot greedy decode of one prompt, cut to its
    budget."""
    ids = np.zeros((1, PAD), np.int32)
    ids[0, :len(req.ids)] = req.ids
    with torch.inference_mode():
        toks, _ = generate.generate_greedy(
            tp, TCFG, torch.from_numpy(ids),
            torch.from_numpy(req.image[None]),
            torch.tensor([len(req.ids)], dtype=torch.int32), MAX_NEW,
            eos_id=eos, kv_quant=kv_quant)
    return toks.numpy()[0, :req.budget]


def _both(trees, reqs_of, eos=-1, **kw):
    """(port results, port engine) of the requests through the port's
    engine, after asserting them equal to the reference engine's, with
    equal stats."""
    jp, tp = trees
    jeng = jcont.ContinuousEngine(jp, CFG, max_new_tokens=MAX_NEW,
                                  eos_id=eos, prompt_pad=PAD, chunk=4,
                                  attn_impl="xla", **kw)
    want = jeng.run(reqs_of(jcont))
    eng = continuous.ContinuousEngine(tp, TCFG, max_new_tokens=MAX_NEW,
                                      eos_id=eos, prompt_pad=PAD, chunk=4,
                                      **kw)
    with torch.inference_mode():
        got = eng.run(reqs_of(continuous))
    assert eng.stats == jeng.stats
    assert eng.refill_sizes == jeng.refill_sizes
    assert len(got) == len(want) and all(r is not None for r in got)
    for i, ((gt, gn), (wt, wn)) in enumerate(zip(got, want)):
        assert gn == wn, i
        np.testing.assert_array_equal(gt, wt, err_msg=f"request {i}")
    return got, eng


def test_token_parity_with_refills(trees):
    # 22 ragged requests through an 8-slot engine: ~3 generations of
    # occupancy, refills at several bucket sizes, ring wrap
    got, eng = _both(trees, lambda m: _requests(m, 22), batch=8)
    reqs = _requests(continuous, 22)
    for i, (toks, n) in enumerate(got):
        assert n == reqs[i].budget
        np.testing.assert_array_equal(toks[:n], _oneshot(trees[1], reqs[i]),
                                      err_msg=f"request {i}")
    assert eng.stats["refills"] >= 2
    assert eng.stats["steps"] < 22 * MAX_NEW


def test_token_parity_sub_batch_refills(trees):
    got, eng = _both(trees, lambda m: _requests(m, 20, seed=3), batch=16,
                     max_refill=8)
    assert max(eng.refill_sizes) == 8 < eng.b
    reqs = _requests(continuous, 20, seed=3)
    for i, (toks, n) in enumerate(got):
        assert n == reqs[i].budget
        np.testing.assert_array_equal(toks[:n], _oneshot(trees[1], reqs[i]),
                                      err_msg=f"request {i}")
    assert eng.stats["refills"] >= 2


def test_eos_exit_frees_slots(trees):
    reqs = _requests(continuous, 6, seed=3)
    probe = _oneshot(trees[1], reqs[0]._replace(budget=MAX_NEW))
    eos = int(probe[2])
    got, _ = _both(trees, lambda m: [r._replace(budget=MAX_NEW)
                                     for r in _requests(m, 6, seed=3)],
                   eos=eos, batch=8)
    toks0, n0 = got[0]
    assert n0 <= 3 or toks0[2] == eos
    np.testing.assert_array_equal(toks0[:3], probe[:3])


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_kv_quant_paths(trees, kv_quant):
    got, _ = _both(trees, lambda m: _requests(m, 10, seed=5), batch=8,
                   kv_quant=kv_quant)
    reqs = _requests(continuous, 10, seed=5)
    for i, (toks, n) in enumerate(got):
        np.testing.assert_array_equal(
            toks[:n], _oneshot(trees[1], reqs[i], kv_quant=kv_quant)[:n],
            err_msg=f"kv={kv_quant} request {i}")


def test_ring_wrap_reuses_slots(trees):
    got, eng = _both(trees, lambda m: [r._replace(budget=MAX_NEW)
                                       for r in _requests(m, 9, seed=7)],
                     batch=8)
    reqs = _requests(continuous, 9, seed=7)
    for i, (toks, n) in enumerate(got):
        np.testing.assert_array_equal(
            toks[:n], _oneshot(trees[1], reqs[i]._replace(budget=MAX_NEW)),
            err_msg=f"request {i}")
    # a slot served a second row past the first's Sg-ring lifetime
    assert eng.stats["steps"] > MAX_NEW


@pytest.mark.parametrize("g", [0, 5, 127, 128, 300])
def test_ring_valid_matches_reference(g):
    rng = np.random.RandomState(g)
    row_start = rng.randint(0, g + 1, (6,)).astype(np.int32)
    want = np.asarray(jcont._ring_valid(jnp.int32(g),
                                        jnp.asarray(row_start), 128))
    got = continuous._ring_valid(torch.tensor(g),
                                 torch.from_numpy(row_start).long(), 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_seq_pad_matches_reference():
    rng = np.random.RandomState(0)
    small = {"k": rng.randn(2, 3, 4, 10, 8).astype(np.float32),
             "k_scale": rng.rand(2, 3, 4, 10).astype(np.float32)}
    like = {"k": np.zeros((2, 7, 4, 14, 8), np.float32),
            "k_scale": np.zeros((2, 7, 4, 14), np.float32)}
    want = jcont._seq_pad({k: jnp.asarray(v) for k, v in small.items()},
                          {k: jnp.asarray(v) for k, v in like.items()})
    got = continuous._seq_pad(
        {k: torch.from_numpy(v) for k, v in small.items()},
        {k: torch.from_numpy(v) for k, v in like.items()})
    for k in small:
        assert got[k].shape == (2, 3) + like[k].shape[2:]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        continuous._seq_pad({"k": torch.zeros(2, 3, 4, 20, 8)},
                            {"k": torch.zeros(2, 7, 4, 14, 8)})


def test_chunks_keep_one_loop_state(trees):
    """Every chunk runs the one body over the one state made at the first
    refill; refills write into it in place. On the CPU `LoopGraphs` holds
    no graph and a graph asked for raises."""
    _, tp = trees
    eng = continuous.ContinuousEngine(tp, TCFG, batch=8,
                                      max_new_tokens=MAX_NEW, eos_id=-1,
                                      prompt_pad=PAD, chunk=4)
    seen = []
    run_loop = graph_loop.run_loop

    def spy(bodies, more, max_steps, device, graph=None, stats=None,
            keep=None):
        seen.append((bodies[0], keep, eng.state.tokens.data_ptr(),
                     eng.state.prompt_cache["k"].data_ptr()))
        return run_loop(bodies, more, max_steps, device, graph, stats, keep)

    with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph_loop, "run_loop", spy)
        eng.run(_requests(continuous, 12))
    assert len(seen) == eng.stats["chunks"] >= 3
    assert eng.stats["refills"] >= 2
    assert len({s[:2] for s in seen}) == 1 and len(set(seen)) == 1
    assert seen[0][1].graphs is None  # eager on the CPU
    eager = continuous.ContinuousEngine(tp, TCFG, batch=8,
                                        max_new_tokens=MAX_NEW, eos_id=-1,
                                        prompt_pad=PAD, graph=True)
    with pytest.raises(ValueError, match="CUDA graph"):
        eager.run(_requests(continuous, 2))


def test_engine_refuses_what_the_reference_refuses(trees):
    import dataclasses

    _, tp = trees
    with pytest.raises(ValueError, match="buckets of 8"):
        continuous.ContinuousEngine(tp, TCFG, batch=6, max_new_tokens=4,
                                    eos_id=-1, prompt_pad=PAD)
    alibi = dataclasses.replace(TCFG, llm=dataclasses.replace(
        TCFG.llm, position_embedding="alibi"))
    eng = continuous.ContinuousEngine(tp, alibi, batch=8, max_new_tokens=4,
                                      eos_id=-1, prompt_pad=PAD)
    with torch.inference_mode(), pytest.raises(NotImplementedError,
                                               match="RoPE"):
        eng.run(_requests(continuous, 2))


def _eval_requests(tmp_path, module):
    rng = np.random.RandomState(1)
    reqs = []
    for i in range(10):
        p = tmp_path / f"cimg{i}.png"
        Image.fromarray(rng.randint(0, 255, (32, 40, 3), dtype=np.uint8)
                        ).save(p)
        reqs.append(module.EvalRequest(
            question_id=i,
            text=f"Describe item number {i} in detail." * (1 + i % 3),
            image_path=str(p)))
    return reqs


def test_batched_generator_continuous_matches_drain(tmp_path, trees):
    """The reference's test on the port: --continuous gives the drain's
    texts (greedy, budget exits only), and the reference's continuous
    texts."""
    jp, tp = trees
    common = dict(image_processor=ImageProcessor(size=28, crop_size=28),
                  batch_size=8, max_new_tokens=6, prompt_bucket=16)
    drain = runner.BatchedGenerator(tp, TCFG, SPTok(), **common)
    cont = runner.BatchedGenerator(tp, TCFG, SPTok(), continuous=True,
                                   prefetch_workers=2, **common)
    t_drain = drain.run(_eval_requests(tmp_path, runner))
    seen = []
    t_cont = cont.run(_eval_requests(tmp_path, runner),
                      on_result=lambda r, text: seen.append(r.question_id))
    assert t_cont == t_drain
    assert sorted(seen) == list(range(10))
    assert cont.last_stats["continuous"] is True
    assert cont.last_stats["refills"] >= 1
    jcont_gen = jrunner.BatchedGenerator(jp, CFG, SPTok(), continuous=True,
                                         attn_impl="xla", **common)
    assert jcont_gen.run(_eval_requests(tmp_path, jrunner)) == t_cont
    assert set(cont.last_stats) == set(jcont_gen.last_stats)


@pytest.mark.parametrize("kw", [
    dict(continuous=True, num_beams=2),
    dict(continuous=True, temperature=0.7),
    dict(num_beams=2, temperature=0.7),
    dict(spec_k=4, temperature=0.7),
    dict(spec_k=4, continuous=True),
])
def test_guards_as_the_reference(trees, kw):
    jp, tp = trees
    with pytest.raises(ValueError):
        jrunner.BatchedGenerator(jp, CFG, SPTok(), None, **kw)
    with pytest.raises(ValueError):
        runner.BatchedGenerator(tp, TCFG, SPTok(), None, **kw)


def test_bench_continuous_line(monkeypatch, capsys):
    """The bench's JSON line at a tiny preset on the CPU: the reference
    script's keys (scripts/bench_continuous.py), every request at its
    budget."""
    monkeypatch.setenv("HALVA_BENCH_PRESET", "llava-tiny")
    monkeypatch.setenv("HALVA_W4A8", "0")
    got = bench_continuous.main(["--batch", "8", "--requests", "24",
                                 "--cap", "12", "--chunk", "4"],
                                device="cpu")
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0]) == got
    assert {"metric", "batch", "requests", "cap_tokens", "chunk", "weights",
            "kv", "budget_mean", "budget_p10_p90", "continuous", "drain",
            "speedup", "note"} <= set(got)
    assert {"wall_s", "imgs_per_sec", "tokens_per_sec", "lockstep_steps",
            "chunks", "refills"} <= set(got["continuous"])
    assert {"wall_s", "imgs_per_sec", "steps"} <= set(got["drain"])
    budgets = bench_continuous.chair_like_budgets(24, 12)
    assert got["drain"]["steps"] == 3 * 12
    assert got["continuous"]["lockstep_steps"] >= budgets.max()
    assert got["weights"] == "int4g" and got["kv"] == "int4"
    assert got["backend"] == "cpu"


def test_chair_like_budgets_are_the_references():
    """The reference script's function, taken from its source (importing
    the script sets up its JAX environment)."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "bench_continuous.py")
    src = open(path).read()
    start = src.index("def chair_like_budgets")
    ns = {"np": np}
    exec(src[start:src.index("\n\n\n", start)], ns)  # the function alone
    for n, cap in ((240, 128), (24, 12)):
        np.testing.assert_array_equal(
            bench_continuous.chair_like_budgets(n, cap),
            ns["chair_like_budgets"](n, cap))
