"""The port's BatchedGenerator (halva_tpu_torch/evals/runner.py) against
the reference's on the tiny model: same prompts (the v1 template, an
SPTok tokenizer), same PNG images, same weights -> the same answer texts,
exactly. Five requests at batch 2 exercise length sorting, bucketing and a
tail batch padded with a dead row."""

import json

import numpy as np
from PIL import Image

from halva_tpu.config import LLAVA_TINY
from halva_tpu.evals import runner as jrunner
from halva_tpu.mm_utils import ImageProcessor
from halva_tpu_torch.evals import runner

from test_data_pipeline import SPTok
from test_torch_tree import shared_trees


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
    want = jrunner.BatchedGenerator(
        jp, LLAVA_TINY, SPTok(), proc, attn_impl="xla", **kw
    ).run(_requests(tmp_path, jrunner))
    gen = runner.BatchedGenerator(tp, LLAVA_TINY, SPTok(), proc, **kw)
    got = gen.run(_requests(tmp_path, runner))
    assert got == want
    assert len(got) == 5 and all(isinstance(t, str) for t in got)
    assert set(gen.last_stats) == {"host_ms_per_img", "device_ms_per_img"}


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


def test_unported_options_raise():
    import pytest

    _, tp = shared_trees()
    with pytest.raises(NotImplementedError):
        runner.BatchedGenerator(tp, LLAVA_TINY, SPTok(), None, num_beams=2)
