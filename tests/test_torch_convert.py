"""The port's converter (python -m halva_tpu_torch.convert_checkpoint, the
counterpart of scripts/convert_checkpoint.py) on the CPU.

Tiny HF-format LLaVA dirs at llava-tiny's widths (an HF LlamaForCausalLM,
a CLIPVisionModel and a 2-layer projector) with fp16 shards, the dtype of
the released checkpoints, and one without its tower beside a standalone
CLIP dir (`--vision-tower-dir`). Converted with `--dtype bfloat16` and
`float32`, `train/checkpoint.load_params` of the output equals, leaf for
leaf and bit for bit, the reference's `load_pretrained_model(hf_dir,
dtype=)` (whose fp16 -> bf16 cast rounds to nearest even, as torch's
does) and the port's own; `load_pretrained_model(out)` reads it through
its save_params branch; and `train.run --model-path <out>` takes a
micro-step from it. `config_from_hf` maps a dir to llava-v1.5-7b: it is
patched to llava-tiny's widths in both packages.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY as J_TINY
from halva_tpu.models import builder as jbuilder
from halva_tpu_torch import convert_checkpoint, tree
from halva_tpu_torch.config import LLAVA_TINY
from halva_tpu_torch.models import builder
from halva_tpu_torch.train import checkpoint as ckpt
from halva_tpu_torch.train import run

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_builder import assert_same_tree  # noqa: E402
from test_train_e2e import _make_data  # noqa: E402
from tokutil import build_tiny_tokenizer  # noqa: E402

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

TOWER = "model.vision_tower.vision_tower."


def _state_dict(seed=0):
    """An HF LLaVA state dict at llava-tiny's widths, fp32."""
    torch.manual_seed(seed)
    llm, vit = LLAVA_TINY.llm, LLAVA_TINY.vision
    lm = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=llm.vocab_size, hidden_size=llm.hidden_size,
        intermediate_size=llm.intermediate_size,
        num_hidden_layers=llm.num_layers, num_attention_heads=llm.num_heads,
        max_position_embeddings=llm.max_position_embeddings,
        tie_word_embeddings=False, rms_norm_eps=llm.rms_norm_eps)).eval()
    vt = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=vit.hidden_size, intermediate_size=vit.intermediate_size,
        num_hidden_layers=vit.num_layers, num_attention_heads=vit.num_heads,
        image_size=vit.image_size, patch_size=vit.patch_size,
        hidden_act="quick_gelu")).eval()
    sd = dict(lm.state_dict())
    sd.update({TOWER + k: v for k, v in vt.state_dict().items()})
    for i, (din, dout) in ((0, (vit.hidden_size, llm.hidden_size)),
                           (2, (llm.hidden_size, llm.hidden_size))):
        lin = torch.nn.Linear(din, dout)
        sd[f"model.mm_projector.{i}.weight"] = lin.weight.data
        sd[f"model.mm_projector.{i}.bias"] = lin.bias.data
    return {k: v.detach().clone() for k, v in sd.items()}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """fp16 shards: the whole checkpoint, and the LLM + projector alone
    beside a standalone CLIP dir (vision_model.* keys)."""
    root = tmp_path_factory.mktemp("convert")
    sd = {k: v.half() for k, v in _state_dict().items()}
    out = {}
    for name, keep in (("full", lambda k: True),
                       ("no_tower", lambda k: not k.startswith(TOWER))):
        d = root / name
        d.mkdir()
        torch.save({k: v for k, v in sd.items() if keep(k)},
                   d / "pytorch_model.bin")
        (d / "config.json").write_text(json.dumps(
            {"hidden_size": LLAVA_TINY.llm.hidden_size,
             "model_type": "llava"}))
        out[name] = str(d)
    d = root / "tower"
    d.mkdir()
    torch.save({k[len(TOWER):]: v for k, v in sd.items()
                if k.startswith(TOWER)}, d / "pytorch_model.bin")
    out["tower"] = str(d)
    out["root"] = root
    return out


@pytest.fixture(autouse=True)
def tiny_configs(monkeypatch):
    """config_from_hf keeps the file's flags at llava-tiny's widths, in
    both packages."""
    real_j, real_t = jbuilder.config_from_hf, builder.config_from_hf
    monkeypatch.setattr(jbuilder, "config_from_hf", lambda d: dataclasses.replace(
        real_j(d), llm=J_TINY.llm, vision=J_TINY.vision))
    monkeypatch.setattr(builder, "config_from_hf", lambda d: dataclasses.replace(
        real_t(d), llm=LLAVA_TINY.llm, vision=LLAVA_TINY.vision))
    monkeypatch.setenv("HALVA_QUANT_CACHE", "off")


def _convert(dirs, out, dtype, separate):
    argv = ["--hf-dir", dirs["no_tower" if separate else "full"],
            "--out", str(out), "--dtype", dtype, "--device", "cpu"]
    if separate:
        argv += ["--vision-tower-dir", dirs["tower"]]
    convert_checkpoint.main(argv)


@pytest.mark.parametrize("separate", [False, True], ids=["whole", "tower_dir"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_converted_tree_equals_both_loaders(dirs, tmp_path, capsys, dtype,
                                            separate):
    out = tmp_path / "out"
    _convert(dirs, out, dtype, separate)
    said = capsys.readouterr().out
    assert said.startswith(f"wrote {out}: ") and "B params, config " in said
    got = ckpt.load_params(str(out), device="cpu")
    src = dirs["no_tower" if separate else "full"]
    tower = dirs["tower"] if separate else None
    want, _ = jbuilder.load_pretrained_model(
        src, vision_tower_path=tower,
        dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    assert_same_tree(got, want)
    own, _ = builder.load_pretrained_model(
        src, vision_tower_path=tower,
        dtype=convert_checkpoint.DTYPES[dtype], device="cpu")
    g, o = dict(tree.flatten(got)), dict(tree.flatten(own))
    assert g.keys() == o.keys()
    for p in o:
        assert g[p].dtype == o[p].dtype and torch.equal(g[p], o[p]), p
    # the eval loader reads the dir through its save_params branch
    loaded, _ = builder.load_pretrained_model(
        str(out), dtype=convert_checkpoint.DTYPES[dtype], device="cpu")
    for p, t in tree.flatten(loaded):
        assert torch.equal(t, o[p]), p


def test_fp16_shards_round_to_nearest_even_in_bf16(dirs, tmp_path):
    """The cast is not a truncation: some fp16 weights land on bf16
    values that truncating would not give."""
    out = tmp_path / "out"
    _convert(dirs, out, "bfloat16", False)
    got = ckpt.load_params(str(out), device="cpu")
    sd = torch.load(os.path.join(dirs["full"], "pytorch_model.bin"),
                    weights_only=True)
    w = sd["model.layers.0.mlp.up_proj.weight"].t()
    k = got["llm"]["layers"]["mlp"]["up"]["kernel"][0]
    assert torch.equal(k, w.bfloat16())
    truncated = (w.float().view(torch.int32) & ~0xFFFF).view(
        torch.float32).bfloat16()
    assert not torch.equal(k, truncated)


def test_train_cli_takes_a_step_from_the_converted_tree(dirs, tmp_path,
                                                        monkeypatch):
    out = tmp_path / "base"
    _convert(dirs, out, "float32", False)
    build_tiny_tokenizer(str(tmp_path / "tok"))
    dp, rp, img = _make_data(tmp_path, tags=("closed", "open"))
    monkeypatch.setenv("HALVA_TOKENIZER", str(tmp_path / "tok"))
    run_dir = tmp_path / "run"
    run.main(["--model", "llava-tiny", "--model-path", str(out),
              "--data-path", dp, "--ref-data-path", rp, "--image-folder",
              img, "--per-device-batch", "1", "--grad-accum-steps", "1",
              "--lora-r", "4", "--max-length", "256", "--max-steps", "1",
              "--dtype", "float32", "--output-dir", str(run_dir),
              "--device", "cpu"])
    m = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    assert [r["step"] for r in m] == [1] and np.isfinite(m[0]["loss"])
    # the base it trained from is the converted tree, not a random init
    base = ckpt.load_params(str(out), device="cpu")
    _, frozen, _ = run.build_models(
        run.parse_args(["--model", "llava-tiny", "--model-path", str(out),
                        "--dtype", "float32", "--device", "cpu"]),
        LLAVA_TINY)
    frozen = dict(tree.flatten(frozen))
    for p, t in tree.flatten(base):
        assert torch.equal(frozen[p], t), p
