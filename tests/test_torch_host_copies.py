"""The port keeps its own copies of the host-side modules it needs
(halva_tpu_torch/{config,constants,conversation,mm_utils}.py) and imports
nothing of halva_tpu. This holds each copy equal to its original: every
preset field for field, every constant, every conversation template's
rendered prompt, and `tokenizer_image_token` / the image processors on
seeded inputs, exactly."""

import dataclasses
import os

import numpy as np
import pytest
from PIL import Image

from halva_tpu import config as jconfig
from halva_tpu import constants as jconstants
from halva_tpu import conversation as jconv
from halva_tpu import mm_utils as jmm
from halva_tpu_torch import config as tconfig
from halva_tpu_torch import constants as tconstants
from halva_tpu_torch import conversation as tconv
from halva_tpu_torch import mm_utils as tmm

from test_data_pipeline import SPTok


def _upper(module):
    return {n: getattr(module, n) for n in dir(module) if n.isupper()}


def test_presets_equal_field_for_field():
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS)
    for name, want in jconfig.PRESETS.items():
        got = tconfig.PRESETS[name]
        assert type(got).__module__ == "halva_tpu_torch.config", name
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


def test_config_module_constants_and_derived_properties_equal():
    want, got = _upper(jconfig), _upper(tconfig)
    assert set(got) == set(want)
    for name, w in want.items():
        if dataclasses.is_dataclass(w):
            assert dataclasses.asdict(got[name]) == dataclasses.asdict(w), name
    for cls in ("LlamaConfig", "ViTConfig", "LlavaConfig"):
        jf = [(f.name, f.default) for f in dataclasses.fields(
            getattr(jconfig, cls))]
        tf = [(f.name, f.default) for f in dataclasses.fields(
            getattr(tconfig, cls))]
        assert [n for n, _ in jf] == [n for n, _ in tf], cls
    for name in ("LLAVA_V15_7B", "LLAVA_TINY", "VILA_13B_384"):
        j, t = getattr(jconfig, name), getattr(tconfig, name)
        for prop in ("num_image_tokens", "vision_feature_size"):
            if (name, prop) == ("VILA_13B_384", "num_image_tokens"):
                # ROADMAP queue 3, reference behaviours: the reference
                # counts 729 // 4 = 182 for a 27 x 27 grid it cannot fold;
                # the port pads it to 28 x 28 and folds 14 x 14
                assert (getattr(j, prop), getattr(t, prop)) == (182, 196)
                continue
            assert getattr(t, prop) == getattr(j, prop), (name, prop)
        for prop in ("kv_heads", "head_size"):
            assert getattr(t.llm, prop) == getattr(j.llm, prop), (name, prop)
        assert t.vision.num_patches == j.vision.num_patches


def test_constants_equal():
    assert _upper(tconstants) == _upper(jconstants)
    assert tconstants.IMAGE_TOKEN_INDEX == -200
    assert tconstants.IGNORE_INDEX == -100


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_templates_render_the_same_prompt(name):
    assert set(tconv.conv_templates) == set(jconv.conv_templates)
    j, t = jconv.get_template(name), tconv.get_template(name)
    user = "<image>\nWhat is in the picture?"
    assert t.prompt(user) == j.prompt(user)
    assert t.prompt(user, "A cat.") == j.prompt(user, "A cat.")
    assert t.stop_str() == j.stop_str()
    msgs = [(j.roles[0], user), (j.roles[1], "A cat."),
            (j.roles[0], "And now?"), (j.roles[1], None)]
    assert t.render(msgs) == j.render(msgs)


def test_unknown_template_raises():
    with pytest.raises(KeyError):
        tconv.get_template("no-such-template")


@pytest.mark.parametrize("prompt", [
    "<image>\nDescribe the image in detail.",
    "no image at all",
    "two <image> markers <image> here",
])
def test_tokenizer_image_token_equal(prompt):
    tok = SPTok()
    want = jmm.tokenizer_image_token(prompt, tok)
    got = tmm.tokenizer_image_token(prompt, tok)
    assert got == want
    assert got.count(tconstants.IMAGE_TOKEN_INDEX) == prompt.count("<image>")


@pytest.mark.parametrize("aspect", ["pad", None])
@pytest.mark.parametrize("make", ["clip_vit_l_336_processor",
                                  "siglip_384_processor"])
def test_process_images_equal(make, aspect):
    rng = np.random.RandomState(0)
    imgs = [Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
            for h, w in ((40, 64), (50, 30))]
    want = jmm.process_images(imgs, getattr(jmm, make)(), aspect)
    got = tmm.process_images(imgs, getattr(tmm, make)(), aspect)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_processor_for_vision_equal():
    for name in ("LLAVA_V15_7B", "VILA_13B_384", "LLAVA_TINY"):
        j = jmm.processor_for_vision(getattr(jconfig, name).vision)
        t = tmm.processor_for_vision(getattr(tconfig, name).vision)
        assert vars(t) == vars(j), name
    assert tmm.get_model_name_from_path("a/b/checkpoint-5") == (
        jmm.get_model_name_from_path("a/b/checkpoint-5"))


# ---- the eval slice's copies: scorers, phases, prefetch, convert_hf,
# vocab and the runner's request builders ---------------------------------

COPIED = ["evals/lemmatize", "evals/chair", "evals/pope", "evals/amber",
          "evals/mme", "evals/mmhal", "evals/hallusion", "evals/judge",
          "evals/merge", "utils/phases", "train/data", "utils/cluster",
          "data/wids", "data/mixtures"]


def _source(pkg, name):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, pkg, name + ".py")) as f:
        return f.read()


@pytest.mark.parametrize("name", COPIED)
def test_host_modules_are_copies(name):
    """The scorers, the phase timer and the train CLI's host modules (data,
    cluster lifecycle, the wids reader and the dataset mixtures; the
    sampler differs in its docstring and is held by its outputs) are the
    reference's text, with the package name in their imports
    changed and nothing else."""
    want = _source("halva_tpu", name).replace("halva_tpu.",
                                              "halva_tpu_torch.")
    assert _source("halva_tpu_torch", name) == want


def test_chair500_list_is_a_copy():
    from halva_tpu.evals import runner as jrunner
    from halva_tpu_torch.evals import runner as trunner

    assert trunner.chair500_image_list() == jrunner.chair500_image_list()
    assert len(trunner.chair500_image_list()) == 500


def test_prefetch_yields_in_order_and_raises_the_workers_error():
    from halva_tpu.utils import prefetch as jprefetch
    from halva_tpu_torch.utils import prefetch as tprefetch

    assert list(tprefetch.prefetch(iter(range(7)), depth=2)) == list(
        jprefetch.prefetch(iter(range(7)), depth=2))

    def broken():
        yield 1
        raise KeyError("host batch")

    for mod in (tprefetch, jprefetch):
        it = mod.prefetch(broken(), depth=2)
        assert next(it) == 1
        with pytest.raises(KeyError, match="host batch"):
            next(it)


def _hf_llama_sd(rng, n=2, d=8, f=12, v=10, tie=False):
    sd = {"model.embed_tokens.weight": rng.randn(v, d),
          "model.norm.weight": rng.randn(d)}
    for i in range(n):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (d, d)),
                            ("self_attn.k_proj", (d, d)),
                            ("self_attn.v_proj", (d, d)),
                            ("self_attn.o_proj", (d, d)),
                            ("mlp.gate_proj", (f, d)), ("mlp.up_proj", (f, d)),
                            ("mlp.down_proj", (d, f))):
            sd[p + name + ".weight"] = rng.randn(*shape)
        sd[p + "input_layernorm.weight"] = rng.randn(d)
        sd[p + "post_attention_layernorm.weight"] = rng.randn(d)
    if not tie:
        sd["lm_head.weight"] = rng.randn(v, d)
    return {k: a.astype(np.float32) for k, a in sd.items()}


def _assert_tree_equal(got, want):
    import torch

    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        assert isinstance(got, torch.Tensor) and got.is_contiguous()
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_hf_equals_the_reference(dtype):
    """Every converter on the same state dict: the reference's fp32 numpy
    leaves equal the port's torch leaves (in the state dict's dtype)."""
    import torch

    from halva_tpu.config import LLAMA_TINY, MPT_7B, VIT_TINY
    from halva_tpu.models import convert_hf as jconv
    from halva_tpu_torch.models import convert_hf as tconv

    rng = np.random.RandomState(0)
    tdt = getattr(torch, dtype)

    def both(sd):  # the port's input and the reference's (its fp32 values)
        t = {k: torch.from_numpy(a).to(tdt) for k, a in sd.items()}
        return t, {k: v.float() for k, v in t.items()}

    cfg = dataclasses.replace(LLAMA_TINY, hidden_size=8, intermediate_size=12,
                              num_layers=2, num_heads=2, vocab_size=10)
    t, j = both(_hf_llama_sd(rng))
    got = tconv.llama_from_hf(t, cfg)
    assert got["layers"]["attn"]["wq"]["kernel"].dtype == tdt
    _assert_tree_equal(got, jconv.llama_from_hf(j, cfg))

    mpt = dataclasses.replace(MPT_7B, hidden_size=8, num_layers=2,
                              num_heads=2, intermediate_size=12)
    sd = {"transformer.wte.weight": rng.randn(10, 8),
          "transformer.norm_f.weight": rng.randn(8)}
    for i in range(2):
        p = f"transformer.blocks.{i}."
        sd[p + "attn.Wqkv.weight"] = rng.randn(24, 8)
        sd[p + "attn.out_proj.weight"] = rng.randn(8, 8)
        sd[p + "ffn.up_proj.weight"] = rng.randn(12, 8)
        sd[p + "ffn.down_proj.weight"] = rng.randn(8, 12)
        sd[p + "norm_1.weight"] = rng.randn(8)
        sd[p + "norm_2.weight"] = rng.randn(8)
    t, j = both({k: a.astype(np.float32) for k, a in sd.items()})
    _assert_tree_equal(tconv.mpt_from_hf(t, mpt), jconv.mpt_from_hf(j, mpt))

    vit = dataclasses.replace(VIT_TINY, num_layers=2)
    d, f, pz = vit.hidden_size, vit.intermediate_size, vit.patch_size
    pre = "vision_model."
    sd = {pre + "embeddings.patch_embedding.weight": rng.randn(d, 3, pz, pz),
          pre + "embeddings.position_embedding.weight": rng.randn(
              vit.num_positions, d),
          pre + "embeddings.class_embedding": rng.randn(d),
          pre + "pre_layrnorm.weight": rng.randn(d),
          pre + "pre_layrnorm.bias": rng.randn(d),
          pre + "post_layernorm.weight": rng.randn(d),
          pre + "post_layernorm.bias": rng.randn(d)}
    for i in range(2):
        e = f"{pre}encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            sd[e + n + ".weight"] = rng.randn(d)
            sd[e + n + ".bias"] = rng.randn(d)
        for n, (o, k) in (("self_attn.q_proj", (d, d)),
                          ("self_attn.k_proj", (d, d)),
                          ("self_attn.v_proj", (d, d)),
                          ("self_attn.out_proj", (d, d)),
                          ("mlp.fc1", (f, d)), ("mlp.fc2", (d, f))):
            sd[e + n + ".weight"] = rng.randn(o, k)
            sd[e + n + ".bias"] = rng.randn(o)
    t, j = both({k: np.asarray(a, np.float32) for k, a in sd.items()})
    _assert_tree_equal(tconv.clip_vit_from_hf(t, vit),
                       jconv.clip_vit_from_hf(j, vit))

    sd = {"model.mm_projector.0.weight": rng.randn(6, 4),
          "model.mm_projector.0.bias": rng.randn(6),
          "model.mm_projector.2.weight": rng.randn(6, 6),
          "model.mm_projector.2.bias": rng.randn(6)}
    t, j = both({k: a.astype(np.float32) for k, a in sd.items()})
    _assert_tree_equal(tconv.projector_from_hf(t, "mlp2x_gelu"),
                       jconv.projector_from_hf(j, "mlp2x_gelu"))
    lin = {"model.mm_projector.weight": sd["model.mm_projector.0.weight"],
           "model.mm_projector.bias": sd["model.mm_projector.0.bias"]}
    t, j = both({k: a.astype(np.float32) for k, a in lin.items()})
    _assert_tree_equal(tconv.projector_from_hf(t, "linear"),
                       jconv.projector_from_hf(j, "linear"))
    with pytest.raises(KeyError):
        tconv.projector_from_hf({}, "mlp2x_gelu")
    cast = tconv.cast_tree({"a": [torch.ones(2)]}, torch.bfloat16)
    assert cast["a"][0].dtype == torch.bfloat16


def test_vocab_extension_equals_the_reference():
    import torch

    from halva_tpu.models import vocab as jvocab
    from halva_tpu_torch.models import vocab as tvocab

    rng = np.random.RandomState(2)
    emb = rng.randn(50, 8).astype(np.float32)
    # the reference's loader hands it lm_head as convert_hf makes it, a
    # transposed view of the (V, D) HF weight; numpy's mean sums in an order
    # that follows the layout, and the port's follows that view's
    head = rng.randn(50, 8).astype(np.float32).T
    want = jvocab.extend_embeddings(
        {"embed": {"embedding": emb}, "lm_head": {"kernel": head}}, 3)
    got = tvocab.extend_embeddings(
        {"embed": {"embedding": torch.from_numpy(emb)},
         "lm_head": {"kernel": torch.from_numpy(
             np.ascontiguousarray(head))}}, 3)
    for path in (("embed", "embedding"), ("lm_head", "kernel")):
        g, w = got[path[0]][path[1]], want[path[0]][path[1]]
        assert g.shape == (53, 8) if path[0] == "embed" else (8, 53)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="unquantized"):
        tvocab.extend_embeddings({"embed": {"embedding_q": None}}, 1)


def test_request_builders_equal_the_reference(tmp_path):
    import json

    from halva_tpu.evals import runner as jrunner
    from halva_tpu_torch.evals import runner as trunner

    def same(got, want):
        assert [dataclasses.asdict(r) for r in got] == [
            dataclasses.asdict(r) for r in want]

    for n, k in ((10, 3), (3, 5), (1, 2)):
        for i in range(k):
            assert trunner.split_chunk(list(range(n)), k, i) == (
                jrunner.split_chunk(list(range(n)), k, i))
    same(trunner.chair_requests("/imgs", 7, 2),
         jrunner.chair_requests("/imgs", 7, 2))
    qf = tmp_path / "q.jsonl"
    qf.write_text("".join(json.dumps({"question_id": i, "image": f"{i}.jpg",
                                      "text": f"q{i}"}) + "\n"
                          for i in range(5)))
    same(trunner.vqa_requests(str(qf), "/imgs", 2, 1, " Answer."),
         jrunner.vqa_requests(str(qf), "/imgs", 2, 1, " Answer."))
    af = tmp_path / "amber.json"
    af.write_text(json.dumps([{"id": i, "image": f"a{i}.jpg",
                               "query": "Describe."} for i in range(3)]))
    same(trunner.amber_requests(str(af), "/imgs"),
         jrunner.amber_requests(str(af), "/imgs"))
    mm = [{"image_src": "http://x/y/abc.jpg", "question": "What?",
           "question_type": "attr", "image_content": ["dog"],
           "gt_answer": "a dog"},
          {"image_id": "img7", "question": "Why?"}]
    same(trunner.mmhal_requests(mm, "/imgs"),
         jrunner.mmhal_requests(mm, "/imgs"))
    hb = [{"visual_input": "1", "filename": "./VD/fig1.png", "question": "Q?",
           "category": "VD", "gt_answer": "1"},
          {"visual_input": "0", "question": "Text only?", "category": "VS"}]
    same(trunner.hallusion_requests(hb, "/imgs"),
         jrunner.hallusion_requests(hb, "/imgs"))


# ---- the train CLI's host modules on the reference tests' own inputs ------
#
# Each case is one test function of the reference's own test files, run with
# the reference modules it exercises swapped for the port's: its names
# rebound, and the modules it imports inside its body (conversation,
# checkpoint, tario) taken from the port. The reference's assertions then
# hold the port on the reference's inputs; the plain run of the same file
# holds the reference. Cases whose inputs are JAX or orbax objects are held
# in test_torch_checkpoint.py and below instead.

SWAPPED = {
    "test_data_pipeline": ("train.data", "mm_utils", "conversation",
                           "constants"),
    "test_sampler": ("train.sampler",),
    "test_vila_cluster": ("train.vila", "utils.cluster"),
    "test_wids": ("data.tario", "data.wids"),
    "test_mixtures": ("data.mixtures",),
}
NOT_SWAPPED = {
    # save_components of a JAX tree: test_torch_checkpoint.py
    ("test_vila_cluster", "test_component_checkpoint_roundtrip"),
}


def _reference_cases():
    import importlib

    out = []
    for mod_name in SWAPPED:
        mod = importlib.import_module(mod_name)
        for name, fn in vars(mod).items():
            if (name.startswith("test_") and callable(fn)
                    and (mod_name, name) not in NOT_SWAPPED):
                out.append((mod_name, name))
    return out


def _rebound(fn, swaps):
    """fn with the names of its module that come from a swapped reference
    module bound to the port's objects of the same names."""
    import types

    g = dict(fn.__globals__)
    for name, val in fn.__globals__.items():
        if isinstance(val, types.ModuleType) and val.__name__ in swaps:
            g[name] = swaps[val.__name__]
        elif getattr(val, "__module__", None) in swaps and hasattr(
                val, "__name__") and not name.isupper():
            g[name] = getattr(swaps[val.__module__], val.__name__)
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


@pytest.mark.parametrize("mod_name,name", _reference_cases())
def test_reference_tests_hold_the_port(mod_name, name, tmp_path,
                                       monkeypatch):
    import importlib
    import inspect
    import sys

    swaps = {}
    for sub in SWAPPED[mod_name]:
        ref = importlib.import_module("halva_tpu." + sub)
        port = importlib.import_module("halva_tpu_torch." + sub)
        swaps[ref.__name__] = port
        monkeypatch.setitem(sys.modules, ref.__name__, port)
        parent, _, child = ref.__name__.rpartition(".")
        monkeypatch.setattr(sys.modules[parent], child, port)
    fn = getattr(importlib.import_module(mod_name), name)
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    params = inspect.signature(fn).parameters
    assert set(params) <= set(args), params
    if mod_name == "test_mixtures":  # the file's autouse registry fixture
        swaps["halva_tpu.data.mixtures"].DATASETS.clear()
    try:
        _rebound(fn, swaps)(**{k: args[k] for k in params})
    finally:
        if mod_name == "test_mixtures":
            swaps["halva_tpu.data.mixtures"].DATASETS.clear()


def test_port_tario_builds_apart_from_the_source():
    """The port's reader builds native/tario.cpp into its own build
    directory, never beside the source."""
    from halva_tpu_torch.data import tario

    lib = tario._get_lib()
    assert lib is not None
    assert os.path.dirname(lib._name) == tario._BUILD
    assert os.path.dirname(tario._SRC) != tario._BUILD


def _delta_tree(rng, vocab=32):
    from test_delta import _tree

    return _tree(rng, vocab)


def _np(tree_):
    """A delta result as numpy (torch leaves through the tree bridge)."""
    from halva_tpu_torch import tree

    return tree.to_numpy(tree_)


@pytest.mark.parametrize("case", ["round_trip", "vocab_extension",
                                  "target_only", "fp32"])
def test_delta_equals_the_reference(case):
    """make_delta / apply_delta on test_delta.py's trees: the port's leaves
    (CPU tensors) equal the reference's numpy leaves, dtype for dtype, bit
    for bit."""
    from halva_tpu.utils import delta as jdelta
    from halva_tpu_torch.utils import delta as tdelta

    rng = np.random.RandomState(
        {"round_trip": 0, "vocab_extension": 1, "target_only": 2,
         "fp32": 5}[case])
    base = _delta_tree(rng)
    target = _delta_tree(rng, vocab=36 if case == "vocab_extension" else 32)
    if case == "target_only":
        target["new_head"] = {"kernel": rng.randn(4, 4).astype(np.float32)}
    if case == "fp32":
        base = {"p": {"k": rng.randn(6, 5).astype(np.float32) * 1e3}}
        target = {"p": {"k": rng.randn(6, 5).astype(np.float32) * 1e-3}}
    want_d = jdelta.make_delta(target, base)
    got_d = tdelta.make_delta(target, base)
    want_t = jdelta.apply_delta(want_d, base)
    got_t = tdelta.apply_delta(got_d, base)
    for got, want in ((got_d, want_d), (got_t, want_t)):
        g, w = dict(_flat(_np(got))), dict(_flat(want))
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            assert g[k].tobytes() == w[k].tobytes(), k
    for bad in ({"only_in_base": {"w": np.zeros(3, np.float32)}},):
        with pytest.raises(ValueError, match="absent from target"):
            tdelta.make_delta(target, dict(base, **bad))
    with pytest.raises(ValueError, match="does not extend"):
        tdelta.make_delta(_delta_tree(rng, 30), _delta_tree(rng, 32))


def _flat(t, prefix=()):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_delta_cli_round_trips_save_params_dirs(tmp_path):
    """The CLI's make / apply / consolidate on save_params dirs of the
    port: apply(make(target, base), base) is the target, as the
    reference's test_delta holds it, and consolidate rewrites a dir."""
    from halva_tpu_torch import tree
    from halva_tpu_torch.train.checkpoint import load_params, save_params
    from halva_tpu_torch.utils import delta as tdelta

    rng = np.random.RandomState(4)
    base, target = _delta_tree(rng), _delta_tree(rng)
    for name, t in (("base", base), ("target", target)):
        save_params(str(tmp_path / name), tree.to_torch(t, "cpu"))
    d = {n: str(tmp_path / n) for n in ("base", "target", "delta", "out",
                                        "copy")}
    tdelta.main(["make", "--base", d["base"], "--target", d["target"],
                 "--delta", d["delta"]])
    tdelta.main(["apply", "--base", d["base"], "--delta", d["delta"],
                 "--target", d["out"]])
    tdelta.consolidate(d["out"], d["copy"])
    from halva_tpu.utils import delta as jdelta

    want = jdelta.apply_delta(jdelta.make_delta(target, base), base)
    for name in ("out", "copy"):
        got = dict(_flat(_np(load_params(d[name], device="cpu"))))
        for k, w in _flat(want):
            assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes()
