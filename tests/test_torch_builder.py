"""The port's checkpoint loader (halva_tpu_torch/models/builder.py) against
the reference's (halva_tpu/models/builder.py) on tiny HF-format LLaVA dirs,
built as tests/test_builder.py builds them (HF LlamaForCausalLM +
CLIPVisionModel + a 2-layer projector, saved as pytorch_model.bin in bf16,
the released layout, or as fp32 model.safetensors).

Both loaders run on the CPU and must give the same tree, leaf for leaf and
bit for bit as numpy: for quant none, int8, int4 and int4g; for a base plus
a PEFT adapter (.bin and .safetensors), plus the reference's adapter.npz,
and for a checkpoint that records mm_use_im_start_end, with a tokenizer
from tests/tokutil.py (the vocab extension). The LLM's widths are
multiples of 64 (hidden 128, MLP 256): at such output widths the fp32 LoRA
delta, a matmul in both packages, sums in the same order in XLA's CPU dot
and in torch's, so the merged kernels agree bit for bit (at other widths
the two libraries round some sums differently in the last place). Also:
the quantized-tree cache written by either package loads in the other,
and the loader's refusals.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LlamaConfig, LlavaConfig, ViTConfig
from halva_tpu.models import builder as jbuilder
from halva_tpu.utils import treecache as jtreecache
from halva_tpu_torch import tree
from halva_tpu_torch.models import builder
from halva_tpu_torch.train import checkpoint as tcheckpoint
from halva_tpu_torch.utils import treecache

from test_torch_tree import port_cfg

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tokutil import build_tiny_tokenizer  # noqa: E402

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

TINY = LlavaConfig(
    llm=LlamaConfig(
        vocab_size=128, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=4, max_position_embeddings=128,
    ),
    vision=ViTConfig(
        image_size=28, patch_size=14, hidden_size=32,
        intermediate_size=64, num_layers=2, num_heads=2,
    ),
)
TTINY = port_cfg(TINY)
PROJS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
         "down_proj")


def _state_dict(seed=0):
    torch.manual_seed(seed)
    lm = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=128, tie_word_embeddings=False,
        rms_norm_eps=1e-5)).eval()
    vt = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, image_size=28, patch_size=14,
        hidden_act="quick_gelu")).eval()
    proj0, proj2 = torch.nn.Linear(32, 128), torch.nn.Linear(128, 128)
    sd = dict(lm.state_dict())
    sd.update({"model.vision_tower.vision_tower." + k: v
               for k, v in vt.state_dict().items()})
    for i, lin in ((0, proj0), (2, proj2)):
        sd[f"model.mm_projector.{i}.weight"] = lin.weight.data
        sd[f"model.mm_projector.{i}.bias"] = lin.bias.data
    return {k: v.detach().clone() for k, v in sd.items()}


def _hf_dir(root, name, fmt="bin", with_tower=True, hf_cfg=None):
    sd = _state_dict()
    if not with_tower:
        sd = {k: v for k, v in sd.items() if "vision_tower" not in k}
    d = root / name
    d.mkdir()
    if fmt == "bin":
        torch.save({k: v.bfloat16() for k, v in sd.items()},
                   d / "pytorch_model.bin")
    else:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()},
                  str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(
        {"hidden_size": 128, "model_type": "llava", **(hf_cfg or {})}))
    return str(d)


def _peft_dir(root, name, fmt="bin", r=8, alpha=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(7)
    dims = {"q_proj": (128, 128), "k_proj": (128, 128),
            "v_proj": (128, 128), "o_proj": (128, 128),
            "gate_proj": (128, 256), "up_proj": (128, 256),
            "down_proj": (256, 128)}
    sd = {}
    for li in range(2):
        for proj in PROJS:
            part = "mlp" if proj in ("gate_proj", "up_proj", "down_proj") \
                else "self_attn"
            din, dout = dims[proj]
            key = f"base_model.model.model.layers.{li}.{part}.{proj}"
            sd[f"{key}.lora_A.weight"] = (
                torch.randn(r, din, generator=g) * 0.05).to(dtype)
            sd[f"{key}.lora_B.weight"] = (
                torch.randn(dout, r, generator=g) * 0.05).to(dtype)
    d = root / name
    d.mkdir()
    if fmt == "bin":
        torch.save(sd, d / "adapter_model.bin")
    else:
        from safetensors.torch import save_file

        save_file(sd, str(d / "adapter_model.safetensors"))
    (d / "adapter_config.json").write_text(json.dumps(
        {"r": r, "lora_alpha": alpha,
         "target_modules": list(PROJS)}))
    return str(d)


def _npz_adapter_dir(root, name):
    """An adapter.npz as the train CLI writes it: {path/lora_a, lora_b,
    lora_scale} for the attention projections only (the MLP keeps no
    adapter)."""
    rng = np.random.RandomState(3)
    sd = {}
    for proj in ("wq", "wk", "wv", "wo"):
        path = f"llm/layers/attn/{proj}"
        sd[f"{path}/lora_a"] = (rng.randn(2, 128, 4) * 0.05).astype(
            np.float32)
        sd[f"{path}/lora_b"] = (rng.randn(2, 4, 128) * 0.05).astype(
            np.float32)
        sd[f"{path}/lora_scale"] = np.full((2,), 2.0, np.float32)
    d = root / name
    d.mkdir()
    tcheckpoint.save_adapter(str(d / "adapter.npz"), sd)
    return str(d)


@pytest.fixture(autouse=True)
def tiny_configs(monkeypatch):
    """config_from_hf maps a dir to llava-v1.5-7b/13b: keep its flags and
    swap in the tiny widths, in both packages."""
    real_j, real_t = jbuilder.config_from_hf, builder.config_from_hf
    monkeypatch.setattr(jbuilder, "config_from_hf", lambda d: dataclasses.replace(
        real_j(d), llm=TINY.llm, vision=TINY.vision))
    monkeypatch.setattr(builder, "config_from_hf", lambda d: dataclasses.replace(
        real_t(d), llm=TTINY.llm, vision=TTINY.vision))
    monkeypatch.setenv("HALVA_QUANT_CACHE", "off")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {
        "bin": _hf_dir(root, "bin"),
        "st": _hf_dir(root, "st", fmt="safetensors"),
        "peft": _peft_dir(root, "peft"),
        "peft_st": _peft_dir(root, "peft_st", fmt="safetensors",
                             dtype=torch.bfloat16),
        "npz": _npz_adapter_dir(root, "npz"),
        "start_end": _hf_dir(root, "start_end",
                             hf_cfg={"mm_use_im_start_end": True}),
        "no_tower": _hf_dir(root, "no_tower", with_tower=False),
        "tok": str(root / "tok"),
        "root": root,
    }


def _flat(t, prefix=""):
    if isinstance(t, dict):
        out = {}
        for k in sorted(t):
            out.update(_flat(t[k], f"{prefix}{k}/"))
        return out
    if isinstance(t, (list, tuple)):
        out = {}
        for i, v in enumerate(t):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): t}


def assert_same_tree(port_params, ref_params):
    got = _flat(tree.to_numpy(port_params))
    want = _flat(jax.tree.map(np.asarray, ref_params))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype.name == w.dtype.name, (path, g.dtype, w.dtype)
        assert g.shape == w.shape, path
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), path


def _both(model_path, quant, **kw):
    port_kw = dict(kw)
    ref_kw = dict(kw)
    if "tokenizer" in kw:
        port_kw["tokenizer"] = build_tiny_tokenizer(kw["tokenizer"])
        ref_kw["tokenizer"] = build_tiny_tokenizer(kw["tokenizer"])
    tp, tcfg = builder.load_pretrained_model(model_path, quant=quant,
                                             device="cpu", **port_kw)
    jp, jcfg = jbuilder.load_pretrained_model(model_path, quant=quant,
                                              **ref_kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return tp, jp


@pytest.mark.parametrize("quant", ["none", "int8", "int4", "int4g"])
@pytest.mark.parametrize("fmt", ["bin", "st"])
def test_full_checkpoint_equals_the_reference(dirs, quant, fmt):
    tp, jp = _both(dirs[fmt], quant)
    assert_same_tree(tp, jp)
    if quant == "int4g":  # 128-row groups on the LLM's stacks
        s = tp["llm"]["layers"]["mlp"]["down"]["kernel_scale4p"]
        assert s.shape == (2, 2, 2, 64) and s.dtype == torch.bfloat16


@pytest.mark.parametrize("quant", ["none", "int8", "int4", "int4g"])
@pytest.mark.parametrize("adapter", ["peft", "peft_st", "npz"])
def test_base_plus_adapter_equals_the_reference(dirs, quant, adapter):
    tp, jp = _both(dirs[adapter], quant, model_base=dirs["bin"])
    assert_same_tree(tp, jp)
    assert "lora_a" not in tp["llm"]["layers"]["attn"]["wq"]  # merged


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_im_start_end_vocab_extension_equals_the_reference(dirs, quant):
    build_tiny_tokenizer(dirs["tok"])
    tp, jp = _both(dirs["start_end"], quant, tokenizer=dirs["tok"])
    assert_same_tree(tp, jp)
    emb = tp["llm"]["embed"]["embedding"]
    assert emb.shape[0] > TINY.llm.vocab_size  # the table grew


def test_merge_differs_from_the_base(dirs):
    """The adapter is really in the merged kernels (and not in the ones it
    does not touch)."""
    base, _ = builder.load_pretrained_model(dirs["bin"], device="cpu")
    merged, _ = builder.load_pretrained_model(
        dirs["npz"], model_base=dirs["bin"], device="cpu")
    lb, lm = base["llm"]["layers"], merged["llm"]["layers"]
    assert not torch.equal(lb["attn"]["wq"]["kernel"],
                           lm["attn"]["wq"]["kernel"])
    assert torch.equal(lb["mlp"]["up"]["kernel"], lm["mlp"]["up"]["kernel"])


def test_refusals(dirs, tmp_path):
    with pytest.raises(FileNotFoundError, match="vision_tower_path"):
        builder.load_pretrained_model(dirs["no_tower"], device="cpu")
    tp, _ = builder.load_pretrained_model(
        dirs["no_tower"], vision_tower_path=_tower_dir(tmp_path),
        device="cpu")
    assert "vision" in tp
    # a component checkpoint loads since the train CLI's port
    # (test_torch_checkpoint.py); one without its config.json is refused
    comp = tmp_path / "components"
    (comp / "llm").mkdir(parents=True)
    (comp / "mm_projector").mkdir()
    with pytest.raises(FileNotFoundError, match="config.json"):
        builder.load_pretrained_model(str(comp), device="cpu")
    with pytest.raises(ValueError, match="quant"):
        builder.load_pretrained_model(dirs["bin"], quant="int3",
                                      device="cpu")


@pytest.mark.parametrize("quant", ["int4", "int4g"])
@pytest.mark.parametrize("quant_tp", [2, 4])
def test_tp_packed_load_equals_the_reference(dirs, quant, quant_tp):
    """quant_tp packs the column-split stacks for a manual-TP mesh and
    stamps the tree, as the reference's loader (tp 4 too: the tiny heads
    and mlp divide it)."""
    tp, jp = _both(dirs["bin"], quant, quant_tp=quant_tp)
    assert int(tp.pop("w4_pack_tp")) == int(jp.pop("w4_pack_tp")) == quant_tp
    assert_same_tree(tp, jp)


def _tower_dir(tmp_path):
    """A standalone CLIP tower dir (vision_model.* keys)."""
    sd = {k[len("model.vision_tower.vision_tower."):]: v
          for k, v in _state_dict().items() if "vision_tower" in k}
    d = tmp_path / "tower"
    d.mkdir()
    torch.save(sd, d / "pytorch_model.bin")
    return str(d)


@pytest.mark.parametrize("first", ["port", "reference"])
def test_quantized_tree_cache_loads_in_both_packages(dirs, tmp_path,
                                                     monkeypatch, first):
    """One package loads cold and writes the npz; the other finds it under
    the same key and loads warm; a second call of the first loads warm
    too. All four trees are the same."""
    monkeypatch.setenv("HALVA_QUANT_CACHE", str(tmp_path / "cache"))
    kw = dict(model_base=dirs["bin"], quant="int4g")
    port = lambda: builder.load_pretrained_model(dirs["peft"], device="cpu",
                                                 **kw)[0]
    ref = lambda: jbuilder.load_pretrained_model(dirs["peft"], **kw)[0]
    if first == "port":
        cold_t = port()
        files = os.listdir(tmp_path / "cache")
        warm_j = ref()
        warm_t = port()
        assert_same_tree(cold_t, warm_j)
        assert_same_tree(warm_t, warm_j)
    else:
        cold_j = ref()
        files = os.listdir(tmp_path / "cache")
        warm_t = port()
        assert_same_tree(warm_t, cold_j)
    assert len(files) == 1 and files[0].startswith("qtree_")
    assert os.listdir(tmp_path / "cache") == files  # one key, one file


def test_treecache_files_cross_both_ways(tmp_path):
    """save_tree / load_tree of each package against the other's, on a
    tree with bf16, int8, fp32 and a list."""
    rng = np.random.RandomState(0)
    params = {"b": {"kernel_q": rng.randint(-127, 128, (3, 4)).astype(
                  np.int8),
                    "kernel_scale": rng.randn(1, 4).astype(jnp.bfloat16)},
              "a": [{"w": rng.randn(2, 2).astype(np.float32)},
                    {"w": rng.randn(5).astype(jnp.bfloat16)}]}
    cfg = TINY
    jtreecache.save_tree(str(tmp_path / "j.npz"), params, cfg)
    got, got_cfg = treecache.load_tree(str(tmp_path / "j.npz"))
    assert_same_tree(got, params)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    treecache.save_tree(str(tmp_path / "t.npz"),
                        tree.to_torch(params, device="cpu"), TTINY)
    back, back_cfg = jtreecache.load_tree(str(tmp_path / "t.npz"))
    assert_same_tree(tree.to_torch(back, device="cpu"), params)
    assert dataclasses.asdict(back_cfg) == dataclasses.asdict(cfg)
    for dt in (jnp.bfloat16, jnp.int8, jnp.float32):
        assert treecache.cache_key("int4g", 1, getattr(torch, jnp.dtype(
            dt).name), ["x"]) == jtreecache.cache_key("int4g", 1, dt, ["x"])
