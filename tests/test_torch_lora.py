"""LoRA in the port (halva_tpu_torch/train/lora.py, the LoRA branch of
models/llama.py:dense, train/checkpoint.py) against the reference's
halva_tpu/train/lora.py on one tree: add_lora shapes and dtypes (stacked
kernels, packed int4 bases), merge_lora, trainable_mask, the state dict and
adapter files crossing between the two packages, and `dense` with LoRA.

Tolerances: shapes, dtypes, masks and state-dict keys exactly equal; fp32
values rtol = atol = 1e-5 (merged kernels: an fp32 einsum over rank 4 and
one add; dense: three fp32 matmuls); adapter files bit-exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.models import llama as jllama
from halva_tpu.ops.w4_matmul import quantize_params_int4_host
from halva_tpu.train import checkpoint as jcheckpoint
from halva_tpu.train import lora as jlora
from halva_tpu_torch import tree
from halva_tpu_torch.models import llama
from halva_tpu_torch.train import checkpoint, lora

from test_torch_tree import jax_tree, port_cfg

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)


def _jax_lora_tree(seed_b=2, dtype=jnp.float32):
    """The reference's tree with LoRA r=4 and a nonzero B, as numpy."""
    params = jax.tree.map(jnp.asarray, jax_tree(LLAVA_TINY, dtype))
    lp = jlora.add_lora(params, jax.random.PRNGKey(1), rank=4, alpha=8)
    rng = np.random.RandomState(seed_b)
    for _, p in jlora._iter_dense(lp):
        if "lora_b" in p:
            p["lora_b"] = jnp.asarray(
                rng.randn(*p["lora_b"].shape) * 0.05, dtype)
    return jax.tree.map(np.asarray, lp)


def _shapes(t):
    return {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in tree.flatten(t)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_lora_matches_reference_structure(dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jlora.add_lora(jax.tree.map(jnp.asarray,
                                       jax_tree(LLAVA_TINY, jdtype)),
                          jax.random.PRNGKey(1), rank=4, alpha=8)
    base = tree.init_params(port_cfg(LLAVA_TINY), torch.Generator().manual_seed(0),
                            dtype, device="cpu")
    got = lora.add_lora(base, torch.Generator().manual_seed(1), rank=4,
                        alpha=8)
    assert _shapes(got) == _shapes(tree.to_torch(
        jax.tree.map(np.asarray, want), device="cpu"))
    layers = got["llm"]["layers"]
    n = LLAVA_TINY.llm.num_layers
    for name, p in list(layers["attn"].items()) + list(
            layers["mlp"].items()):
        d_in, d_out = p["kernel"].shape[1:]
        assert p["lora_a"].shape == (n, d_in, 4), name
        assert p["lora_b"].shape == (n, 4, d_out), name
        assert p["lora_scale"].shape == (n,), name
        assert not p["lora_b"].any()  # the adapter starts as identity
        bound = np.sqrt(3.0 / d_in) * (1 + 2**-8)  # bf16 may round up
        assert float(p["lora_a"].abs().max()) <= bound
        assert torch.equal(p["lora_scale"],
                           torch.full((n,), 2.0, dtype=dtype))
    # the base tree is untouched and its tensors are shared, not copied
    assert "lora_a" not in base["llm"]["layers"]["attn"]["wq"]
    embed = base["llm"]["embed"]["embedding"]
    assert got["llm"]["embed"]["embedding"] is embed
    with pytest.raises(ValueError, match="no dense params matched"):
        lora.add_lora(base, torch.Generator(), targets=(r"^nothing$",))


def test_add_lora_on_packed_int4_base():
    """A kernel_q4p base: d_out doubles (two nibbles per byte) and the
    adapters train in bf16, as the reference's QLoRA-class bases do."""
    np_tree = jax_tree(LLAVA_TINY)
    q4 = quantize_params_int4_host(np_tree, group_size=32)
    want = jlora.add_lora(jax.tree.map(jnp.asarray, q4),
                          jax.random.PRNGKey(1), rank=4, alpha=8)
    got = lora.add_lora(tree.to_torch(q4, device="cpu"), torch.Generator().manual_seed(1),
                        rank=4, alpha=8)
    assert _shapes(got) == _shapes(tree.to_torch(
        jax.tree.map(np.asarray, want), device="cpu"))
    wq = got["llm"]["layers"]["attn"]["wq"]
    assert wq["lora_b"].shape[-1] == 2 * wq["kernel_q4p"].shape[-1]
    assert wq["lora_a"].dtype == torch.bfloat16


def test_merge_lora_matches_reference():
    np_lp = _jax_lora_tree()
    want = jax.tree.map(np.asarray, jlora.merge_lora(
        jax.tree.map(jnp.asarray, np_lp)))
    got = lora.merge_lora(tree.to_torch(np_lp, device="cpu"))
    assert _shapes(got) == _shapes(tree.to_torch(want, device="cpu"))
    for (path, g), (_, w) in zip(tree.flatten(got), tree.flatten(want)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=str(path), **F32)
    stripped = lora.strip_lora(tree.to_torch(np_lp, device="cpu"))
    assert _shapes(stripped) == _shapes(tree.to_torch(jax_tree(LLAVA_TINY), device="cpu"))


@pytest.mark.parametrize("extra", [(), (r"^projector/",)])
def test_trainable_mask_matches_reference(extra):
    np_lp = _jax_lora_tree()
    want = jlora.trainable_mask(jax.tree.map(jnp.asarray, np_lp),
                                extra_trainable=extra)
    got = lora.trainable_mask(tree.to_torch(np_lp, device="cpu"), extra_trainable=extra)
    assert dict(tree.flatten(got)) == dict(tree.flatten(want))
    assert any(v for _, v in tree.flatten(got))


def test_state_dict_keys_and_values_match_reference():
    np_lp = _jax_lora_tree()
    want = jlora.lora_state_dict(jax.tree.map(jnp.asarray, np_lp))
    got = lora.lora_state_dict(tree.to_torch(np_lp, device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_adapter_files_cross_load(tmp_path, writer):
    """An adapter npz written by either package loads in the other and puts
    the same factors back (fp32: both directions; the reference cannot read
    back its own bf16 npz, see the next test)."""
    np_lp = _jax_lora_tree(seed_b=4)
    path = str(tmp_path / "adapter.npz")
    if writer == "jax":
        jcheckpoint.save_adapter(
            path, jlora.lora_state_dict(jax.tree.map(jnp.asarray, np_lp)))
        sd = checkpoint.load_adapter(path)
        base = lora.add_lora(tree.to_torch(jax_tree(LLAVA_TINY), device="cpu"),
                             torch.Generator().manual_seed(9), rank=4)
        loaded = lora.load_lora_state_dict(base, sd)
        got = lora.lora_state_dict(loaded)
    else:
        checkpoint.save_adapter(path,
                                lora.lora_state_dict(tree.to_torch(np_lp, device="cpu")))
        sd = jcheckpoint.load_adapter(path)
        base = jlora.add_lora(jax.tree.map(jnp.asarray, jax_tree(LLAVA_TINY)),
                              jax.random.PRNGKey(9), rank=4)
        got = {k: np.asarray(v) for k, v in jlora.lora_state_dict(
            jlora.load_lora_state_dict(base, sd)).items()}
    want = jlora.lora_state_dict(jax.tree.map(jnp.asarray, np_lp))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


def test_bf16_adapter_from_reference_loads(tmp_path):
    """np.savez stores a bf16 array as 2-byte void; the port reads it back
    as bf16, bit-exact."""
    np_lp = _jax_lora_tree(dtype=jnp.bfloat16)
    path = str(tmp_path / "adapter.npz")
    want = jlora.lora_state_dict(jax.tree.map(jnp.asarray, np_lp))
    jcheckpoint.save_adapter(path, want)
    sd = checkpoint.load_adapter(path)
    loaded = lora.load_lora_state_dict(
        lora.strip_lora(tree.to_torch(np_lp, device="cpu")), sd)
    wq = loaded["llm"]["layers"]["attn"]["wq"]
    assert wq["lora_a"].dtype == torch.bfloat16
    for k, w in want.items():
        assert sd[k].tobytes() == np.asarray(w).tobytes(), k
    with pytest.raises(KeyError, match="unmatched"):
        lora.load_lora_state_dict(tree.to_torch(np_lp, device="cpu"),
                                  {"llm/nowhere/lora_a": sd[k]})


def test_dense_with_lora_matches_reference():
    np_lp = _jax_lora_tree()
    p = jax.tree.map(lambda a: np.asarray(a[1]),
                     np_lp["llm"]["layers"]["mlp"]["gate"])
    p["bias"] = np.random.RandomState(7).randn(
        p["kernel"].shape[-1]).astype(np.float32)
    x = np.random.RandomState(3).randn(2, 5, p["kernel"].shape[0]).astype(
        np.float32)
    want = np.asarray(jllama.dense(jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, p)))
    got = llama.dense(torch.from_numpy(x), tree.to_torch(p, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # the branch keys on lora_a: a lone lora_scale (the frozen reference
    # tree keeps it) adds nothing
    lone = {k: v for k, v in tree.to_torch(p, device="cpu").items()
            if k not in ("lora_a", "lora_b")}
    plain = {k: v for k, v in lone.items() if k != "lora_scale"}
    assert torch.equal(llama.dense(torch.from_numpy(x), lone),
                       llama.dense(torch.from_numpy(x), plain))


def test_llama_forward_with_lora_matches_reference():
    np_lp = _jax_lora_tree()
    cfg = LLAVA_TINY.llm
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 9))
    want = np.asarray(jllama.forward(jax.tree.map(jnp.asarray,
                                                  np_lp["llm"]), cfg,
                                     jnp.asarray(ids), attn_impl="xla"))
    got = llama.forward(tree.to_torch(np_lp, device="cpu")["llm"], port_cfg(cfg),
                        torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    base = np.asarray(jllama.forward(
        jax.tree.map(jnp.asarray, jax_tree(LLAVA_TINY)["llm"]), cfg,
        jnp.asarray(ids), attn_impl="xla"))
    assert np.abs(want - base).max() > 1e-3  # the adapter does something


def test_dense_on_kernel_q4_still_raises():
    """An NF4 dense needs both its leaves: indices without their scales
    still raise; with them `dense` is nf4_dense."""
    from halva_tpu_torch.ops import quant

    p = {"kernel_q4": torch.zeros(4, 2, dtype=torch.uint8)}
    with pytest.raises(KeyError, match="kernel_scale4"):
        llama.dense(torch.zeros(1, 4), p)
    p["kernel_scale4"] = torch.full((1, 2), 0.5, dtype=torch.bfloat16)
    x = torch.arange(4, dtype=torch.float32)[None]
    torch.testing.assert_close(
        llama.dense(x, p), quant.nf4_dense(x, p["kernel_q4"],
                                           p["kernel_scale4"]))
    assert float(llama.dense(x, p)[0, 0]) == -0.5 * 6  # code 0 is -1


@pytest.mark.parametrize("base", ["nf4", "int8", "int4"])
def test_add_lora_and_adapter_round_trip_on_quantized_base(base):
    """A quantized base (NF4 indices are uint8 in the port) gets bf16
    factors of the float kernel's d_out, as the reference gives them, and
    the adapter state dict round-trips and never holds a quantized leaf."""
    from halva_tpu.ops import quant as jquant
    from halva_tpu_torch.ops import quant

    np_tree = jax_tree(LLAVA_TINY)
    jt = jax.tree.map(jnp.asarray, np_tree)
    if base == "int4":
        jq = jax.tree.map(jnp.asarray,
                          quantize_params_int4_host(np_tree, group_size=32))
    else:
        jq = jquant.quantize_params(jt, bits=4 if base == "nf4" else 8)
    want = jlora.add_lora(jq, jax.random.PRNGKey(1), rank=4, alpha=8)
    tq = tree.to_torch(jax.tree.map(np.asarray, jq), device="cpu")
    got = lora.add_lora(tq, torch.Generator().manual_seed(1), rank=4, alpha=8)
    assert _shapes(got) == _shapes(tree.to_torch(
        jax.tree.map(np.asarray, want), device="cpu"))
    down = got["llm"]["layers"]["mlp"]["down"]
    d_out = np_tree["llm"]["layers"]["mlp"]["down"]["kernel"].shape[-1]
    assert down["lora_b"].shape[-1] == d_out
    assert down["lora_a"].dtype == down["lora_b"].dtype == torch.bfloat16
    if base == "nf4":
        assert down["kernel_q4"].dtype == torch.uint8
        same = quant.quantize_params(tree.to_torch(np_tree, device="cpu"),
                                     bits=4)
        assert torch.equal(same["llm"]["layers"]["mlp"]["down"]["kernel_q4"],
                           down["kernel_q4"])
    # strip_lora gives the base back, quantized leaves in place
    stripped = lora.strip_lora(got)
    assert _shapes(stripped) == _shapes(tq)
    sd = lora.lora_state_dict(got)
    assert sd and all(k.rsplit("/", 1)[1] in ("lora_a", "lora_b",
                                              "lora_scale") for k in sd)
    assert sorted(sd) == sorted(jlora.lora_state_dict(want))
    sd["llm/layers/mlp/down/lora_b"] = sd["llm/layers/mlp/down/lora_b"] + 1
    loaded = lora.load_lora_state_dict(tq, sd)
    back = lora.lora_state_dict(loaded)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert back[k].tobytes() == np.asarray(sd[k]).tobytes(), k
    # a quantized base has no float kernel to fold into, in either package
    with pytest.raises(KeyError):
        lora.merge_lora(got)
    with pytest.raises(KeyError):
        jlora.merge_lora(want)
