"""Param-tree bridge between the JAX reference and the PyTorch port
(halva_tpu_torch/tree.py): numpy -> torch -> numpy is bit-exact, and the
port's JAX-free init gives the reference tree's structure, shapes and
dtypes. Tolerance: none, every comparison is exact.

The helpers here make the shared tiny trees for the other test_torch_*
files: JAX init -> numpy -> torch, so both packages run on the same
weights."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY, LLAVA_V15_7B, LlavaConfig
from halva_tpu.models import llava
from halva_tpu_torch import tree
from halva_tpu_torch.models.llava import LlavaModel

torch.set_num_threads(2)

LLAVA_TINY_GQA = dataclasses.replace(
    LLAVA_TINY,
    llm=dataclasses.replace(LLAVA_TINY.llm, num_kv_heads=2,
                            tie_word_embeddings=True),
    mm_projector_type="linear",
)


def jax_tree(cfg: LlavaConfig = LLAVA_TINY, dtype=jnp.float32, seed=0):
    """The reference's random tree as numpy arrays."""
    params = llava.init_params(jax.random.PRNGKey(seed), cfg, dtype)
    return jax.tree.map(np.asarray, params)


def shared_trees(cfg: LlavaConfig = LLAVA_TINY, dtype=jnp.float32, seed=0):
    """(jax tree, torch tree) holding the same values."""
    np_tree = jax_tree(cfg, dtype, seed)
    return jax.tree.map(jnp.asarray, np_tree), tree.to_torch(np_tree)


def _leaves(t):
    return dict(tree.flatten(t))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32, jnp.int8,
                                   jnp.int32])
def test_round_trip_bit_exact(dtype):
    rng = np.random.RandomState(0)
    a = np.asarray(jnp.asarray(rng.randn(3, 5, 7) * 50).astype(dtype))
    t = tree.to_torch({"x": a})["x"]
    back = tree.to_numpy({"x": t})["x"]
    assert back.dtype == a.dtype and back.shape == a.shape
    assert back.tobytes() == a.tobytes()
    if dtype == jnp.bfloat16:
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))


def test_llava_tree_round_trip():
    np_tree = jax_tree(LLAVA_TINY, jnp.bfloat16)
    back = tree.to_numpy(tree.to_torch(np_tree))
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for (p, a), (q, b) in zip(tree.flatten(np_tree), tree.flatten(back)):
        assert p == q and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes(), p


@pytest.mark.parametrize(
    "cfg,dtype,device",
    [
        (LLAVA_TINY, jnp.float32, "cpu"),
        (LLAVA_TINY, jnp.bfloat16, "cpu"),
        (LLAVA_TINY_GQA, jnp.float32, "cpu"),
        (LLAVA_V15_7B, jnp.bfloat16, "meta"),  # full width, no memory
    ],
    ids=["tiny-f32", "tiny-bf16", "tiny-gqa-tied-linear", "7b-bf16-meta"],
)
def test_init_params_matches_reference(cfg, dtype, device):
    want = jax.eval_shape(
        lambda k: llava.init_params(k, cfg, dtype), jax.random.PRNGKey(0)
    )
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = tree.init_params(cfg, torch.Generator().manual_seed(0), tdtype,
                           device)
    want_leaves = _leaves(want)
    got_leaves = _leaves(got)
    assert sorted(got_leaves, key=str) == sorted(want_leaves, key=str)
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.dtype == tdtype, path


def test_init_params_scales_match_reference():
    """Same init scales: per-leaf std within sampling noise of the
    reference's (kernels in^-0.5, embeddings 0.02, norms ones)."""
    want = _leaves(jax_tree(LLAVA_TINY))
    got = _leaves(tree.init_params(LLAVA_TINY, torch.Generator().manual_seed(0)))
    for path, w in want.items():
        g = got[path].numpy()
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w)
        else:
            assert 0.8 < g.std() / w.std() < 1.25, path


def test_llava_model_owns_tree():
    np_tree = jax_tree(LLAVA_TINY)
    params = tree.to_torch(np_tree)
    model = LlavaModel(LLAVA_TINY, params)
    out = model.params
    assert list(_leaves(out)) == list(_leaves(params))
    assert isinstance(out["projector"]["layers"], list)
    for (p, a), (_, b) in zip(tree.flatten(params), tree.flatten(out)):
        assert a is b, p
    moved = model.to(torch.float64).params
    assert moved["llm"]["embed"]["embedding"].dtype == torch.float64
