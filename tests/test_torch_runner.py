"""The port's BatchedGenerator (halva_tpu_torch/evals/runner.py) against
the reference's on the tiny model: same prompts (the v1 template, an
SPTok tokenizer), same PNG images, same weights -> the same answer texts,
exactly. Five requests at batch 2 exercise length sorting, bucketing and a
tail batch padded with a dead row. The int4g serving tree, which has no
float `embedding` leaf once its table is int8, answers with int4 and int8
KV caches (its int8 table gives bf16 rows, so the LLM runs in bf16, where
the two frameworks round differently: its token parity with the reference
is held in test_torch_llava on a float table)."""

import json

import numpy as np
import pytest
from PIL import Image

from halva_tpu.config import LLAVA_TINY
from halva_tpu.evals import runner as jrunner
from halva_tpu.mm_utils import ImageProcessor
from halva_tpu.ops.w4_matmul import quantize_params_int4_host
from halva_tpu_torch import tree
from halva_tpu_torch.evals import runner

from test_data_pipeline import SPTok
from test_torch_tree import jax_tree, port_cfg, shared_trees

TCFG = port_cfg(LLAVA_TINY)
# the reference's last_stats keys (halva_tpu/evals/runner.py)
STATS = {"host_ms_per_img", "device_ms_per_img", "host_s", "device_s",
         "first_batch_s", "overlapped"}


def _requests(tmp_path, module):
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(5):
        p = tmp_path / f"img{i}.png"
        Image.fromarray(
            rng.randint(0, 255, (32, 40, 3), dtype=np.uint8)).save(p)
        reqs.append(module.EvalRequest(
            question_id=i,
            text=f"Describe item number {i} in detail please." * (1 + i % 2),
            image_path=str(p),
        ))
    return reqs


def test_batched_generator_texts_match_reference(tmp_path):
    jp, tp = shared_trees()
    kw = dict(batch_size=2, max_new_tokens=4, prompt_bucket=16)
    proc = ImageProcessor(size=28, crop_size=28)
    jgen = jrunner.BatchedGenerator(
        jp, LLAVA_TINY, SPTok(), proc, attn_impl="xla", **kw)
    want = jgen.run(_requests(tmp_path, jrunner))
    gen = runner.BatchedGenerator(tp, TCFG, SPTok(), proc, **kw)
    got = gen.run(_requests(tmp_path, runner))
    assert got == want
    assert len(got) == 5 and all(isinstance(t, str) for t in got)
    assert set(gen.last_stats) == set(jgen.last_stats) == STATS
    st = gen.last_stats
    assert st["overlapped"] is False and st["first_batch_s"] > 0
    assert st["device_s"] >= st["first_batch_s"]
    for key in ("host_s", "device_s", "first_batch_s"):
        assert st[key] == round(st[key], 3)
    for key in ("host_ms_per_img", "device_ms_per_img"):
        assert st[key] == round(st[key], 2)


def test_answers_jsonl_schema(tmp_path):
    reqs = _requests(tmp_path, runner)
    reqs[0].extra["image_id"] = 7
    out = tmp_path / "answers.jsonl"
    runner.write_answers_jsonl(str(out), reqs, ["a", "b", "c", "d", "e"],
                               model_id="tiny")
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["question_id"] for r in rows] == list(range(5))
    assert set(rows[0]) == {"question_id", "prompt", "text", "answer_id",
                            "model_id", "metadata", "image_id"}
    assert rows[0]["prompt"] == reqs[0].text and rows[4]["text"] == "e"
    assert runner.build_prompt("Hi", "v1") == jrunner.build_prompt("Hi", "v1")


@pytest.mark.parametrize("kv_quant", ["int4", "int8"])
def test_batched_generator_quantized_tree(tmp_path, kv_quant):
    t = jax_tree(LLAVA_TINY)
    # a vocab-sized table, so that the int8 pass makes embedding_q and the
    # tree has no float embedding leaf
    t["llm"]["embed"]["embedding"] = np.random.RandomState(1).randn(
        4096, LLAVA_TINY.llm.hidden_size).astype(np.float32) * 0.02
    q = quantize_params_int4_host(t, group_size=32)
    assert "embedding" not in q["llm"]["embed"]
    kw = dict(batch_size=2, max_new_tokens=4, prompt_bucket=16,
              kv_quant=kv_quant)
    proc = ImageProcessor(size=28, crop_size=28)
    reqs = _requests(tmp_path, runner)[:3]
    gen = runner.BatchedGenerator(tree.to_torch(q, device="cpu"), TCFG,
                                  SPTok(), proc, **kw)
    assert gen.device.type == "cpu"
    seen = []
    got = gen.run(reqs, on_result=lambda r, text: seen.append(r.question_id))
    assert len(got) == 3 and all(isinstance(x, str) for x in got)
    assert sorted(seen) == [0, 1, 2]
    assert set(gen.last_stats) == STATS


def test_unported_options_raise():
    _, tp = shared_trees()
    for unported, item in (({"temperature": 0.5}, "item 9"),
                           ({"top_p": 0.9}, "item 9"),
                           ({"continuous": True}, "item 9"),
                           ({"mesh": object()}, "item 10"),
                           ({"prefetch_workers": 2}, "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            runner.BatchedGenerator(tp, TCFG, SPTok(), None, **unported)
    with pytest.raises(TypeError):  # not an argument of either package
        runner.BatchedGenerator(tp, TCFG, SPTok(), None, no_such_option=1)
    # the reference's argument checks
    with pytest.raises(ValueError, match="drop num_beams"):
        runner.BatchedGenerator(tp, TCFG, SPTok(), None, num_beams=2,
                                spec_k=4)
    with pytest.raises(ValueError, match="spec_k"):
        runner.BatchedGenerator(tp, TCFG, SPTok(), None, spec_k=1)
    with pytest.raises(ValueError, match="drop"):
        jrunner.BatchedGenerator(None, LLAVA_TINY, SPTok(), None,
                                 num_beams=2, spec_k=4)


@pytest.mark.parametrize("length_penalty", [1.0, 2.0])
def test_batched_generator_beams_match_reference(tmp_path, length_penalty):
    jp, tp = shared_trees()
    kw = dict(batch_size=2, max_new_tokens=4, prompt_bucket=16, num_beams=2,
              length_penalty=length_penalty)
    proc = ImageProcessor(size=28, crop_size=28)
    want = jrunner.BatchedGenerator(
        jp, LLAVA_TINY, SPTok(), proc, attn_impl="xla", **kw
    ).run(_requests(tmp_path, jrunner)[:3])
    gen = runner.BatchedGenerator(tp, TCFG, SPTok(), proc, **kw)
    got = gen.run(_requests(tmp_path, runner)[:3])
    assert got == want and len(got) == 3
    assert set(gen.last_stats) == STATS


def test_batched_generator_speculative_matches_greedy(tmp_path):
    jp, tp = shared_trees()
    kw = dict(batch_size=2, max_new_tokens=6, prompt_bucket=16)
    proc = ImageProcessor(size=28, crop_size=28)
    reqs = _requests(tmp_path, runner)[:3]
    greedy = runner.BatchedGenerator(tp, TCFG, SPTok(), proc, **kw).run(reqs)
    gen = runner.BatchedGenerator(tp, TCFG, SPTok(), proc, spec_k=4, **kw)
    got = gen.run(reqs)
    assert got == greedy
    jgen = jrunner.BatchedGenerator(jp, LLAVA_TINY, SPTok(), proc,
                                    attn_impl="xla", spec_k=4, **kw)
    assert jgen.run(_requests(tmp_path, jrunner)[:3]) == got
    for key in ("spec_verify_steps", "spec_emitted_tokens"):
        assert gen.last_stats[key] == jgen.last_stats[key] > 0


def test_reference_arguments_pass_at_their_neutral_values(tmp_path):
    """A caller written for the reference passes every argument of its
    constructor; at their neutral values the port takes them all, by the
    reference's names and defaults."""
    import inspect

    want = inspect.signature(jrunner.BatchedGenerator.__init__).parameters
    got = inspect.signature(runner.BatchedGenerator.__init__).parameters
    assert list(got) == list(want)
    for name, p in want.items():
        if name not in ("self", "image_processor"):
            assert got[name].default == p.default, name
    _, tp = shared_trees()
    proc = ImageProcessor(size=28, crop_size=28)
    kw = dict(batch_size=2, max_new_tokens=3, prompt_bucket=16)
    neutral = dict(temperature=0.0, top_p=1.0, seed=7, mesh=None,
                   prefetch_workers=0, continuous=False, num_beams=1,
                   length_penalty=1.0, spec_k=0, kv_quant=False)
    reqs = _requests(tmp_path, runner)[:2]
    plain = runner.BatchedGenerator(tp, TCFG, SPTok(), proc, **kw).run(reqs)
    assert runner.BatchedGenerator(tp, TCFG, SPTok(), proc, **kw,
                                   **neutral).run(reqs) == plain
