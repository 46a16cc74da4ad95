"""The port's vision towers against the JAX package and torch oracles, on
tiny fp32 towers with seeded numpy inputs:

- the SigLIP layout (no cls token, no pre-LN, gelu_tanh) against
  halva_tpu.models.vit.encode and transformers.SiglipVisionModel;
- InternViT (RMSNorm blocks, q/k RMSNorm over the whole embed width before
  the head split, LayerScale, bias-free qkv) at select layers -1 and -2
  against the JAX package and the torch oracle of tests/test_intern_radio.py;
- RADIO's encode_radio with and without pixel unshuffle (and against torch
  PixelUnshuffle), register tokens excluded, the odd grid raising, and a
  LLaVA forward on a RADIO tower;
- interpolate_pos_embed up and down, S2's encode_multiscale and its tile
  split / stitch, against the JAX package.

Tolerances: the port against the JAX package 1e-5 (rtol and atol; 1e-4 for
the LLaVA logits, as tests/test_torch_llava.py); against the HF or torch
oracles the reference tests' own (atol 2e-4 / 3e-4, rtol 2e-3); the resize
weights 1e-5 (they match jax.image.resize to ~1e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LlamaConfig, LlavaConfig, ViTConfig
from halva_tpu.models import llava as jllava
from halva_tpu.models import s2 as js2
from halva_tpu.models import vit as jvit
from halva_tpu.models.convert_hf import intern_vit_from_hf as j_intern_from_hf
from halva_tpu_torch import tree
from halva_tpu_torch.models import convert_hf, llava, s2, vit
from halva_tpu_torch.ops.resize import resize

from test_intern_radio import (
    INTERN_TINY,
    RADIO_TINY,
    _InternOracle,
    _oracle_state_dict,
)
from test_torch_tree import port_cfg

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)

SIGLIP_TINY = ViTConfig(
    image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
    num_layers=2, num_heads=2, layer_norm_eps=1e-6, use_cls_token=False,
    use_pre_layernorm=False, hidden_act="gelu_tanh")


def _trees(cfg, seed=0):
    """(jax tree, torch tree) of a random tower of `cfg`, same values."""
    np_tree = jax.tree.map(np.asarray,
                           jvit.init_params(jax.random.PRNGKey(seed), cfg))
    return (jax.tree.map(jnp.asarray, np_tree),
            tree.to_torch(np_tree, device="cpu"))


def _images(b, size, seed=0, unit=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, 3, size, size) if unit else rng.randn(b, 3, size, size)
    return x.astype(np.float32)


@pytest.mark.parametrize("select_layer", [-2, -1])
def test_siglip_layout_against_the_reference(select_layer):
    jp, tp = _trees(SIGLIP_TINY)
    imgs = _images(2, 28)
    want = jvit.encode(jp, SIGLIP_TINY, jnp.asarray(imgs),
                       select_layer=select_layer)
    got = vit.encode(tp, port_cfg(SIGLIP_TINY), torch.from_numpy(imgs),
                     select_layer=select_layer)
    assert got.shape == (2, SIGLIP_TINY.num_patches, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_siglip_layout_parity_with_hf():
    """tests/test_vit_parity.py::test_siglip_layout_parity on the port."""
    hf_cfg = transformers.SiglipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, image_size=28, patch_size=14,
        attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.SiglipVisionModel(hf_cfg).eval()
    params = convert_hf.clip_vit_from_hf(model.state_dict(),
                                         port_cfg(SIGLIP_TINY))
    imgs = torch.from_numpy(_images(1, 28, seed=2))
    with torch.no_grad():
        want = model(imgs, output_hidden_states=True).hidden_states[-2]
        got = vit.encode(params, port_cfg(SIGLIP_TINY), imgs,
                         select_layer=-2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=2e-3)


def test_siglip_on_a_side_that_is_no_multiple_of_the_patch_is_hf():
    """VILA_13B_384's tower takes 384 px through 14 px patches: HF's
    stride-14 convolution drops the last 6 pixels of each side. At 32 px
    (2 patches and 4 pixels a side) the port equals
    transformers.SiglipVisionModel, while the reference's patchify raises
    (ROADMAP queue 3, reference behaviours)."""
    cfg = dataclasses.replace(SIGLIP_TINY, image_size=32)
    hf_cfg = transformers.SiglipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=14,
        attn_implementation="eager")
    torch.manual_seed(1)
    model = transformers.SiglipVisionModel(hf_cfg).eval()
    params = convert_hf.clip_vit_from_hf(model.state_dict(), port_cfg(cfg))
    imgs = torch.from_numpy(_images(2, 32, seed=3))
    with torch.no_grad():
        want = model(imgs, output_hidden_states=True).hidden_states[-2]
        got = vit.encode(params, port_cfg(cfg), imgs, select_layer=-2)
    assert got.shape == (2, 4, 32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=2e-3)
    with pytest.raises(TypeError, match="cannot reshape"):
        jvit.patchify(jnp.asarray(imgs.numpy()), 14)
    # on whole patches the port is the reference's patchify
    even = _images(2, 28, seed=4)
    np.testing.assert_array_equal(
        vit.patchify(torch.from_numpy(even), 14).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(even), 14)))


@pytest.mark.parametrize("select_layer", [-2, -1])
def test_intern_vit_against_the_reference_and_the_torch_oracle(select_layer):
    torch.manual_seed(0)
    model = _InternOracle(INTERN_TINY).eval()
    sd = _oracle_state_dict(model)
    jp = j_intern_from_hf(sd, INTERN_TINY)
    tp = convert_hf.intern_vit_from_hf(sd, port_cfg(INTERN_TINY))
    imgs = _images(2, 28)
    with torch.no_grad():
        oracle = model(torch.from_numpy(imgs))[select_layer][:, 1:]
        got = vit.encode(tp, port_cfg(INTERN_TINY), torch.from_numpy(imgs),
                         select_layer=select_layer)
    want = jvit.encode(jax.tree.map(jnp.asarray, jp), INTERN_TINY,
                       jnp.asarray(imgs), select_layer=select_layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=3e-4,
                               rtol=2e-3)


def test_intern_vit_with_scaled_norms_against_the_reference():
    """InternViT with q/k norm scales and LayerScale vectors away from 1, so
    that each multiplies where the reference's does."""
    jp, tp = _trees(INTERN_TINY, seed=3)
    rng = np.random.RandomState(4)
    for name in ("q_norm", "k_norm", "ls1", "ls2"):
        holder = (tp["layers"]["attn"] if name.endswith("norm")
                  else tp["layers"])
        holder[name]["scale"] = torch.from_numpy(
            1 + 0.3 * rng.randn(*holder[name]["scale"].shape)
            .astype(np.float32))
    cfg = port_cfg(INTERN_TINY)
    imgs = torch.from_numpy(_images(1, 28, seed=5))
    got = vit.encode(tp, cfg, imgs, select_layer=-1)
    want = jvit.encode(jax.tree.map(jnp.asarray, tree.to_numpy(tp)),
                       INTERN_TINY, jnp.asarray(imgs.numpy()),
                       select_layer=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("unshuffle", [0, 2])
@pytest.mark.parametrize("skip_final_norm", [False, True])
def test_encode_radio_against_the_reference(unshuffle, skip_final_norm):
    jp, tp = _trees(RADIO_TINY, seed=1)
    imgs = _images(2, 32, seed=1, unit=True)
    want = jvit.encode_radio(jp, RADIO_TINY, jnp.asarray(imgs),
                             pixel_unshuffle=unshuffle,
                             skip_final_norm=skip_final_norm)
    got = vit.encode_radio(tp, port_cfg(RADIO_TINY), torch.from_numpy(imgs),
                           pixel_unshuffle=unshuffle,
                           skip_final_norm=skip_final_norm)
    f = max(unshuffle, 1)
    assert got.shape == (2, RADIO_TINY.num_patches // f**2,
                         RADIO_TINY.hidden_size * f**2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_radio_unshuffle_is_torch_pixel_unshuffle():
    _, tp = _trees(RADIO_TINY)
    cfg = port_cfg(RADIO_TINY)
    imgs = torch.from_numpy(_images(2, 32, seed=1, unit=True))
    plain = vit.encode_radio(tp, cfg, imgs)
    folded = vit.encode_radio(tp, cfg, imgs, pixel_unshuffle=2)
    b, n, c = plain.shape
    side = RADIO_TINY.image_size // RADIO_TINY.patch_size
    spatial = plain.reshape(b, side, side, c).permute(0, 3, 1, 2)
    want = torch.nn.PixelUnshuffle(2)(spatial)
    want = want.reshape(b, c * 4, (side // 2) ** 2).permute(0, 2, 1)
    np.testing.assert_allclose(folded.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)


def test_radio_register_tokens_excluded():
    """The output is the grid's patch tokens alone: the cls token and the
    register tokens are dropped after the final norm."""
    _, tp = _trees(RADIO_TINY, seed=2)
    cfg = port_cfg(RADIO_TINY)
    imgs = torch.from_numpy(_images(1, 32, seed=2, unit=True))
    feats = vit.encode_radio(tp, cfg, imgs)
    assert feats.shape == (1, RADIO_TINY.num_patches, RADIO_TINY.hidden_size)
    assert cfg.num_prefix_tokens == 1 + RADIO_TINY.num_register_tokens


def test_radio_odd_grid_raises_under_unshuffle():
    odd = dataclasses.replace(RADIO_TINY, image_size=24)  # 3 x 3 grid
    _, tp = _trees(odd)
    imgs = torch.from_numpy(_images(1, 24, unit=True))
    assert vit.encode_radio(tp, port_cfg(odd), imgs).shape[1] == 9
    with pytest.raises(ValueError, match="3 x 3"):
        vit.encode_radio(tp, port_cfg(odd), imgs, pixel_unshuffle=2)


@pytest.mark.parametrize("unshuffle", [0, 2])
def test_radio_llava_forward_against_the_reference(unshuffle):
    cfg = LlavaConfig(
        llm=LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                        num_layers=2, num_heads=2,
                        max_position_embeddings=256),
        vision=RADIO_TINY, mm_projector_type="mlp2x_gelu",
        vision_tower_type="radio", radio_pixel_unshuffle=unshuffle)
    np_tree = jax.tree.map(np.asarray,
                           jllava.init_params(jax.random.PRNGKey(0), cfg))
    ids = np.full((2, 6), 5, np.int32)
    ids[:, 1] = -200
    imgs = _images(2, 32, unit=True)
    want, _ = jllava.forward(jax.tree.map(jnp.asarray, np_tree), cfg,
                             jnp.asarray(ids), jnp.asarray(imgs),
                             attn_impl="xla")
    got, sp = llava.forward(tree.to_torch(np_tree, device="cpu"),
                            port_cfg(cfg), torch.from_numpy(ids),
                            torch.from_numpy(imgs))
    assert got.shape == (2, 6 + cfg.num_image_tokens - 1, 128)
    assert port_cfg(cfg).num_image_tokens == cfg.num_image_tokens
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


CLIP_TINY_42 = ViTConfig(image_size=42, patch_size=14, hidden_size=32,
                         intermediate_size=64, num_layers=2, num_heads=2)


@pytest.mark.parametrize("new_size", [56, 70, 14])
@pytest.mark.parametrize("cfg", [CLIP_TINY_42, dataclasses.replace(
    SIGLIP_TINY, image_size=42)], ids=["cls", "no_cls"])
def test_interpolate_pos_embed_against_the_reference(new_size, cfg):
    jp, tp = _trees(cfg, seed=4)
    wp, wcfg = jvit.interpolate_pos_embed(jp, cfg, new_size)
    gp, gcfg = vit.interpolate_pos_embed(tp, port_cfg(cfg), new_size)
    assert gcfg == port_cfg(wcfg)
    np.testing.assert_allclose(gp["pos_embed"]["embedding"].numpy(),
                               np.asarray(wp["pos_embed"]["embedding"]),
                               **F32)
    imgs = _images(1, new_size, seed=5)
    want = jvit.encode(wp, wcfg, jnp.asarray(imgs))
    got = vit.encode(gp, gcfg, torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("shape,new", [((2, 5, 7, 3), (2, 9, 4, 3)),
                                       ((1, 3, 27, 27), (1, 3, 16, 16)),
                                       ((1, 3, 12, 12), (1, 3, 36, 36))])
def test_resize_is_jax_image_resize(method, shape, new):
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), new, method=method)
    got = resize(torch.from_numpy(x), new, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("scales,size", [((28, 56), 28), ((28, 56), 40),
                                         ((28, 56, 84), 56)])
def test_encode_multiscale_against_the_reference(scales, size):
    jp, tp = _trees(SIGLIP_TINY, seed=6)
    imgs = _images(2, size, seed=6)
    want = js2.encode_multiscale(jp, SIGLIP_TINY, jnp.asarray(imgs),
                                 scales=scales)
    got = s2.encode_multiscale(tp, port_cfg(SIGLIP_TINY),
                               torch.from_numpy(imgs), scales=scales)
    assert got.shape == (2, SIGLIP_TINY.num_patches, 32 * len(scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    base = vit.encode(tp, port_cfg(SIGLIP_TINY),
                      s2._resize_images(torch.from_numpy(imgs), 28))
    np.testing.assert_allclose(got[..., :32].numpy(), base.numpy(), **F32)


def test_s2_tile_split_and_stitch_against_the_reference():
    rng = np.random.RandomState(8)
    imgs = rng.randn(2, 3, 84, 84).astype(np.float32)
    want = js2._split_tiles(jnp.asarray(imgs), 28)
    got = s2._split_tiles(torch.from_numpy(imgs), 28)
    assert got.shape == (18, 3, 28, 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    feats = rng.randn(18, 16, 5).astype(np.float32)
    want = js2._stitch_and_pool(jnp.asarray(feats), 2, 3, 4)
    got = s2._stitch_and_pool(torch.from_numpy(feats), 2, 3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # a round trip: tiles of a constant-per-tile image stitch back to it
    tiles = s2._split_tiles(torch.from_numpy(imgs), 28)
    g = tiles.reshape(2, 3, 3, 3, 28, 28).permute(0, 3, 1, 4, 2, 5)
    np.testing.assert_array_equal(g.reshape(2, 3, 84, 84).numpy(), imgs)
