"""The port's eval CLI (halva_tpu_torch/evals/cli.py) end to end on the
CPU: a tiny HF-format LLaVA checkpoint (tests/test_torch_builder.py), a
tokenizer from tests/tokutil.py, PNG images, `--prefetch-workers 2`.

- `chair` and `pope` write answers JSONL with the reference CLI's rows
  (the same question ids, in the same order) and keys, the reference CLI
  run on the same checkpoint and requests;
- the texts equal those of the port's BatchedGenerator on the same loaded
  tree (the reference's texts may differ: its bf16 tree rounds in another
  framework);
- `pope` with an annotation dir scores with the copied POPE scorer;
- `--temperature`, `--top-p` and `--continuous` run end to end; a device
  mesh on two gloo ranks writes the one-process answers, and a mesh whose
  size is not the world's is refused before anything is loaded;
- the runner's prefetch pool gives the texts of the serial run.
"""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from halva_tpu.evals import cli as jcli
from halva_tpu_torch.evals import cli, runner
from halva_tpu_torch.mm_utils import processor_for_vision
from halva_tpu_torch.models import builder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tokutil import build_tiny_tokenizer  # noqa: E402
from test_torch_builder import _hf_dir, tiny_configs  # noqa: E402,F401

N_CHAIR = 5  # the first chunk of 100 of the CHAIR-500 list


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    build_tiny_tokenizer(str(root / "tok"))
    rng = np.random.RandomState(0)
    coco = root / "val2014"
    coco.mkdir()
    for name in runner.chair500_image_list()[:N_CHAIR]:
        Image.fromarray(rng.randint(0, 255, (30, 40, 3), dtype=np.uint8)
                        ).save(coco / name, format="JPEG")
    imgs = root / "pope_imgs"
    imgs.mkdir()
    rows = []
    for i in range(5):
        Image.fromarray(rng.randint(0, 255, (40, 30, 3), dtype=np.uint8)
                        ).save(imgs / f"q_{i}.png")
        rows.append({"question_id": i, "image": f"q_{i}.png",
                     "text": f"Is there a dog in the image {i}?",
                     "category": "random"})
    qfile = root / "pope_questions.jsonl"
    qfile.write_text("".join(json.dumps(r) + "\n" for r in rows))
    ann = root / "pope_ann"
    ann.mkdir()
    (ann / "coco_pope_random.json").write_text("".join(
        json.dumps({"label": "yes" if i % 2 else "no"}) + "\n"
        for i in range(5)))
    return {"ckpt": _hf_dir(root, "ckpt"), "tok": str(root / "tok"),
            "coco": str(coco), "pope_imgs": str(imgs), "qfile": str(qfile),
            "ann": str(ann), "root": root}


def _common(setup, out):
    return ["--model-path", setup["ckpt"], "--tokenizer", setup["tok"],
            "--answers-file", out, "--batch-size", "2",
            "--max-new-tokens", "4", "--prefetch-workers", "2"]


def _args(setup, cmd, out):
    if cmd == "chair":
        return ["chair", *_common(setup, out), "--image-folder",
                setup["coco"], "--num-chunks", "100", "--chunk-idx", "0"]
    return ["pope", *_common(setup, out), "--question-file", setup["qfile"],
            "--image-folder", setup["pope_imgs"]]


def _rows(path):
    return [json.loads(line) for line in open(path)]


def _port_texts(setup, reqs):
    """The port's BatchedGenerator on the tree the CLI loads."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(setup["tok"])
    params, cfg = builder.load_pretrained_model(
        setup["ckpt"], tokenizer=tok, device="cpu")
    gen = runner.BatchedGenerator(
        params, cfg, tok, processor_for_vision(cfg.vision),
        image_aspect_ratio=cfg.image_aspect_ratio, batch_size=2,
        max_new_tokens=4)
    return gen.run(reqs)


@pytest.mark.parametrize("cmd", ["chair", "pope"])
def test_cli_answers_like_the_reference(setup, tmp_path, cmd):
    out, ref_out = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    cli.main(_args(setup, cmd, out) + ["--device", "cpu"])
    jcli.main(_args(setup, cmd, ref_out))
    got, want = _rows(out), _rows(ref_out)
    n = N_CHAIR if cmd == "chair" else 5
    assert len(got) == len(want) == n
    assert [r["question_id"] for r in got] == [r["question_id"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["prompt"] == w["prompt"]
        assert g["model_id"] == cli.MODEL_ID and w["model_id"] == "halva-tpu"
    if cmd == "chair":
        reqs = runner.chair_requests(setup["coco"], 100, 0)
        assert [g["image_id"] for g in got] == [w["image_id"] for w in want]
        assert [g["caption"] for g in got] == [g["text"] for g in got]
    else:
        reqs = runner.vqa_requests(setup["qfile"], setup["pope_imgs"])
    assert [g["text"] for g in got] == _port_texts(setup, reqs)


def test_pope_cli_scores_with_the_annotations(setup, tmp_path, capsys):
    out = str(tmp_path / "port.jsonl")
    cli.main(_args(setup, "pope", out)
             + ["--device", "cpu", "--annotation-dir", setup["ann"]])
    printed = capsys.readouterr().out
    scores = json.loads(printed[printed.index("{"):])
    assert set(scores) == {"random", "avg_f1"}
    assert scores["random"]["TP"] + scores["random"]["FP"] + scores[
        "random"]["TN"] + scores["random"]["FN"] == 5


@pytest.mark.parametrize("flags,item", [
    (["--mesh-data", "2"], "2x1 != 1 devices"),
    (["--mesh-model", "2"], "1x2 != 1 devices"),
])
def test_unported_flags_raise_naming_their_items(setup, tmp_path, flags,
                                                 item, monkeypatch):
    """A mesh runs one process a GPU (torchrun): a world of another size is
    refused before anything loads (--mesh-model alone means data 1)."""
    def no_load(*a, **k):
        raise AssertionError("the model was loaded")

    monkeypatch.setattr(builder, "load_pretrained_model", no_load)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=item):
        cli.main(_args(setup, "pope", str(tmp_path / "a.jsonl"))
                 + ["--device", "cpu", *flags])


def test_two_rank_cli_writes_the_one_process_answers(setup, tmp_path):
    """`--mesh-data 2` on two gloo ranks (RANK / WORLD_SIZE as torchrun
    sets them): rank 0 writes the answers of the one-process run, row for
    row (a batch of 4 puts each rank on the rows of one batch of 2)."""
    import dataclasses

    import torch_mesh_workers as W
    from test_torch_builder import TTINY

    one, two = str(tmp_path / "one.jsonl"), str(tmp_path / "two.jsonl")
    world = W.World(W.cli_rank, 2, {
        "llm": dataclasses.asdict(TTINY.llm),
        "vision": dataclasses.asdict(TTINY.vision),
        "argv": _args(setup, "pope", two) + [
            "--device", "cpu", "--batch-size", "4", "--mesh-data", "2"]})
    cli.main(_args(setup, "pope", one) + ["--device", "cpu"])
    ranks = world.results()
    assert all(not [m for m in loaded if m.startswith("halva_tpu")]
               for _, loaded in ranks)
    got, want = _rows(two), _rows(one)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        g.pop("answer_id"), w.pop("answer_id")
        assert g == w


@pytest.mark.parametrize("flags", [
    ["--temperature", "0.5"],
    ["--top-p", "0.9"],
    ["--continuous", "--batch-size", "8"],
])
def test_decode_variant_flags_answer_every_question(setup, tmp_path, flags):
    """The reference's sampling and continuous-batching flags run end to end
    on the CPU and write a row for every question; top-p alone and
    continuous batching are greedy, so they answer as the default run."""
    out = str(tmp_path / "port.jsonl")
    cli.main(_args(setup, "pope", out) + ["--device", "cpu", *flags])
    got = _rows(out)
    assert [r["question_id"] for r in got] == list(range(5))
    assert all(isinstance(r["text"], str) for r in got)
    if flags[0] != "--temperature":
        reqs = runner.vqa_requests(setup["qfile"], setup["pope_imgs"])
        assert [r["text"] for r in got] == _port_texts(setup, reqs)


def test_prefetch_pool_answers_like_the_serial_run(setup):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(setup["tok"])
    params, cfg = builder.load_pretrained_model(setup["ckpt"], device="cpu")
    reqs = runner.vqa_requests(setup["qfile"], setup["pope_imgs"])
    texts = {}
    for workers in (0, 2):
        gen = runner.BatchedGenerator(
            params, cfg, tok, processor_for_vision(cfg.vision),
            batch_size=2, max_new_tokens=4, prefetch_workers=workers)
        texts[workers] = gen.run(reqs)
        assert gen.last_stats["overlapped"] is (workers > 0)
    assert texts[2] == texts[0]
