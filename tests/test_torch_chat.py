"""The port's chat (python -m halva_tpu_torch.chat, the counterpart of
scripts/chat.py) end to end on the CPU: the tiny HF-format LLaVA
checkpoint of tests/test_torch_builder.py, a tests/tokutil.py tokenizer
and a small PNG.

- `--question`, greedy and with `--num-beams 2`: the printed answer equals
  the reference script's on the same files. Both loaders are patched to
  fp32 trees, where greedy and beam decode are token-exact across the two
  frameworks (a bf16 tree rounds differently in each);
- the question loop: stdin "q1\\nq2\\n\\n" gives two answers, each the
  one-shot answer to its question, then the loop exits;
- `--quant int8` answers with the text of the port's own generate_greedy
  on the loaded int8 tree (an int8 embedding table makes the LLM compute
  in bf16, so the two packages are not compared at tiny widths);
- `ChatSession` keeps no state across questions: an answer does not
  depend on the one before it.

scripts/chat.py is loaded by path, with the reference's persistent
compilation cache made a no-op.
"""

import functools
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from halva_tpu.models import builder as jbuilder
from halva_tpu_torch import chat
from halva_tpu_torch.conversation import get_template
from halva_tpu_torch.mm_utils import process_images, processor_for_vision
from halva_tpu_torch.models import builder
from halva_tpu_torch.ops.generate import decode_tokens, generate_greedy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tokutil import build_tiny_tokenizer  # noqa: E402
from test_torch_builder import _hf_dir, tiny_configs  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_TOKENS = "8"
QUESTION = "What is in the image?"

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("chat")
    build_tiny_tokenizer(str(root / "tok"))
    rng = np.random.RandomState(0)
    Image.fromarray(rng.randint(0, 255, (30, 40, 3), dtype=np.uint8)).save(
        root / "cat.png")
    return {"ckpt": _hf_dir(root, "ckpt"), "tok": str(root / "tok"),
            "image": str(root / "cat.png")}


@pytest.fixture(scope="module")
def ref_chat():
    spec = importlib.util.spec_from_file_location(
        "ref_chat", os.path.join(REPO, "scripts", "chat.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fp32(monkeypatch):
    """Both loaders give fp32 trees."""
    monkeypatch.setattr(builder, "load_pretrained_model", functools.partial(
        builder.load_pretrained_model, dtype=torch.float32))
    monkeypatch.setattr(jbuilder, "load_pretrained_model", functools.partial(
        jbuilder.load_pretrained_model, dtype=jnp.float32))


def _args(setup, *extra):
    return ["--model-path", setup["ckpt"], "--image", setup["image"],
            "--tokenizer", setup["tok"], "--max-new-tokens", NEW_TOKENS,
            *extra]


def _port(setup, capsys, *extra):
    chat.main(_args(setup, *extra, "--device", "cpu"))
    return capsys.readouterr().out


@pytest.mark.parametrize("beams", [1, 2], ids=["greedy", "beams2"])
def test_answer_equals_the_reference_script(setup, ref_chat, fp32, capsys,
                                            monkeypatch, beams):
    import halva_tpu.utils.jaxcache as jaxcache

    monkeypatch.setattr(jaxcache, "enable_persistent_cache", lambda: None)
    extra = ("--question", QUESTION, "--num-beams", str(beams))
    got = _port(setup, capsys, *extra)
    monkeypatch.setattr(sys, "argv", ["chat.py", *_args(setup, *extra)])
    ref_chat.main()
    want = capsys.readouterr().out
    assert got == want
    assert got.strip()  # 8 random tokens decode to some text


def test_question_loop_answers_each_line_until_an_empty_one(
        setup, fp32, capsys, monkeypatch):
    one_shot = [_port(setup, capsys, "--question", q).strip()
                for q in ("q1", "q2")]
    monkeypatch.setattr(sys, "stdin", io.StringIO("q1\nq2\n\nq3\n"))
    out = _port(setup, capsys)
    lines = out.split("USER: ")
    assert lines[0] == "Ask about the image (empty line to quit).\n"
    answers = [ln for ln in lines[1:] if ln.startswith("ASSISTANT:")]
    assert [a[len("ASSISTANT:"):].strip() for a in answers] == one_shot
    assert len(lines) == 4  # q1, q2, then the empty line: q3 is not read


def test_int8_answer_equals_generate_greedy_on_the_int8_tree(setup, capsys):
    got = _port(setup, capsys, "--quant", "int8", "--question",
                QUESTION).strip()
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(setup["tok"])
    params, cfg = builder.load_pretrained_model(setup["ckpt"], quant="int8",
                                                device="cpu")
    assert "kernel_q" in params["llm"]["layers"]["attn"]["wq"]
    template = get_template("v1")
    pixels = process_images([Image.open(setup["image"]).convert("RGB")],
                            processor_for_vision(cfg.vision),
                            cfg.image_aspect_ratio)
    ids = chat.ChatSession(params, cfg, tok, pixels, template).prompt_ids(
        QUESTION)
    with torch.inference_mode():
        toks, num = generate_greedy(
            params, cfg, torch.tensor([ids], dtype=torch.int32),
            torch.from_numpy(pixels), torch.tensor([len(ids)],
                                                   dtype=torch.int32),
            max_new_tokens=int(NEW_TOKENS), eos_id=tok.eos_token_id)
    want = decode_tokens(toks.numpy(), num.numpy(), tok, tok.eos_token_id,
                         stop_strs=(template.stop_str(),))[0]
    assert got == want


def test_session_keeps_nothing_across_questions(setup):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(setup["tok"])
    params, cfg = builder.load_pretrained_model(setup["ckpt"], device="cpu")
    pixels = process_images([Image.open(setup["image"]).convert("RGB")],
                            processor_for_vision(cfg.vision),
                            cfg.image_aspect_ratio)
    s = chat.ChatSession(params, cfg, tok, pixels, get_template("v1"),
                         max_new_tokens=int(NEW_TOKENS))
    first = s.answer(QUESTION)
    last = s.last
    s.answer("q2")
    assert s.answer(QUESTION) == first
    assert s.last["ids"] == last["ids"] and torch.equal(
        s.last["tokens"], last["tokens"])
    assert s.last["tokens"].shape == (1, int(NEW_TOKENS))
