"""The port keeps its own copies of the host-side modules it needs
(halva_tpu_torch/{config,constants,conversation,mm_utils}.py) and imports
nothing of halva_tpu. This holds each copy equal to its original: every
preset field for field, every constant, every conversation template's
rendered prompt, and `tokenizer_image_token` / the image processors on
seeded inputs, exactly."""

import dataclasses

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
