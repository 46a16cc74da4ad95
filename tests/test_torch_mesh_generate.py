"""Mesh decode of the port (ops/generate.py, ops/beam.py,
evals/runner.py with `mesh=`) on 4 gloo ranks on the CPU, held against the
single-device port and the reference's mesh call (tests/test_generate_mesh.py
on the conftest's CPU devices), token for token, on LLAVA_TINY.

One spawn of 4 ranks runs every case of torch_mesh_workers.GEN_CASES, while
this process computes the references; each case is then one parametrized
test:
- data parallelism {4, 1} (fp32, bf16) and manual TP {2, 2} / {1, 4}:
  fp32, int8 (weight dequant), int4 packed for tp 2, int4 with int8 KV;
  gather-at-use {2, 2}: NF4, int4 packed for tp 1, and
  HALVA_TP_IMPL=propagate (a bf16 tree under TP sums its shards' bf16
  partial outputs, which one device does not: not token-exact, as in the
  reference, whose mesh tests hold TP on fp32 trees);
- sampling: identical prompts on two data shards draw apart, model shards
  draw in lockstep (every rank returns the same tokens);
- beams on {data 4}; BatchedGenerator(mesh=) on {2, 2} and, with beams, on
  {4, 1}; graph=True under a gloo group is refused;
- the W8A8 k-split: within the reference's bound of the one-device dense;
- each refusal, in this process (a MeshShape: no group is reached).
Every rank returns the whole batch's tokens and imports neither JAX nor the
reference.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.constants import IMAGE_TOKEN_INDEX
from halva_tpu.models.llama import dense as jdense
from halva_tpu.ops import beam as jbeam
from halva_tpu.ops import generate as jgen
from halva_tpu.ops import quant as jquant
from halva_tpu.ops.w4_matmul import quantize_params_int4_host
from halva_tpu.parallel import mesh as jmesh
from halva_tpu_torch.config import config_to_dict
from halva_tpu_torch.evals import runner
from halva_tpu_torch.ops import beam, generate
from halva_tpu_torch.parallel import mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_workers as W  # noqa: E402
from test_torch_tree import jax_tree, port_cfg  # noqa: E402

CFG = LLAVA_TINY
TCFG = port_cfg(CFG)
CASES = {c[0]: c for c in W.GEN_CASES}
# the reference's mesh call beside each case that has one (attn_impl="xla")
REF_CASES = ("data_fp32", "tp_fp32", "tp_int4_kv8", "gather_int4",
             "beam_data")


def _inputs(b=8, s=24, dead_rows=(6,)):
    """tests/test_generate_mesh.py's inputs: ragged, row 6 dead."""
    rng = np.random.RandomState(0)
    ids = rng.randint(5, 200, (b, s)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    lens = np.full((b,), s, np.int32)
    lens[0], lens[3] = 17, 11
    for i in dead_rows:
        ids[i] = 0
        lens[i] = 0
    size = CFG.vision.image_size
    images = rng.randn(b, 3, size, size).astype(np.float32)
    return ids, images, lens


def _same_inputs(b=8):
    """One prompt and image on every row (the sampling cases)."""
    rng = np.random.RandomState(1)
    ids = np.tile(rng.randint(5, 200, (1, 24)).astype(np.int32), (b, 1))
    ids[:, 1] = IMAGE_TOKEN_INDEX
    size = CFG.vision.image_size
    images = np.tile(rng.randn(1, 3, size, size).astype(np.float32),
                     (b, 1, 1, 1))
    return ids, images, np.full((b,), 24, np.int32)


def _ksplit():
    rng = np.random.RandomState(0)
    w = (rng.randn(64, 128) * 0.05).astype(np.float32)
    return rng.randn(4, 64).astype(np.float32), w


def _ref_trees(np_tree):
    return {"fp32": np_tree, "int8": jquant.quantize_params_host(np_tree),
            "int4": quantize_params_int4_host(np_tree),
            "int4tp2": quantize_params_int4_host(np_tree, tp=2)}


def _ref_case(case, ref_trees, inputs):
    """The reference's mesh call of a case (its own test's settings)."""
    name, dm, tree_name, inp, what, kw, env = case
    kw = dict(kw)
    max_new = kw.pop("max_new_tokens", W.MAX_NEW)
    jm = jmesh.make_mesh(data=dm[0], model=dm[1],
                         devices=jax.devices()[:dm[0] * dm[1]])
    args = (ref_trees[tree_name], CFG,
            *(jnp.asarray(x) for x in inputs[inp]), max_new)
    old = jquant._W8A8
    jquant._W8A8 = False if tree_name == "int8" else old
    try:
        if what == "beam":
            out = jbeam.generate_beam(*args, W.EOS, attn_impl="xla", mesh=jm,
                                      **kw)
        else:
            out = jgen.generate(*args, eos_id=W.EOS, attn_impl="xla",
                                mesh=jm, **kw)
    finally:
        jquant._W8A8 = old
    return tuple(np.asarray(x) for x in out)


def _ref_ksplit(x, w):
    """The reference test's W8A8 k-split (test_generate_mesh.py):
    (one-device dense, the model-axis shard_map's)."""
    from jax.sharding import Mesh, PartitionSpec as P

    old = jquant._W8A8
    jquant.set_w8a8(True)
    try:
        p = jquant.quantize_params_host({"d": {"kernel": w}})["d"]
        xj = jnp.asarray(x)
        y_full = jdense(xj, p)
        jm = Mesh(np.asarray(jax.devices()[:2]).reshape(2), ("model",))

        def body(px, pq, ps):
            y = jdense(px, {"kernel_q": pq, "kernel_scale": ps})
            return jax.lax.psum(y, "model")

        y_tp = jax.shard_map(
            body, mesh=jm, in_specs=(P(None, "model"), P("model", None), P()),
            out_specs=P(), check_vma=False,
        )(xj, p["kernel_q"], p["kernel_scale"])
    finally:
        jquant._W8A8 = old
    return np.asarray(y_full), np.asarray(y_tp)


@pytest.fixture(scope="module")
def run():
    """The 4 ranks' results, and beside them (computed while the ranks run)
    the single-device port's and the reference's."""
    np_tree = jax_tree(CFG)
    inputs = {"std": _inputs(), "same": _same_inputs(), "text": None}
    world = W.World(W.generate_cases, 4, {
        "cfg": config_to_dict(TCFG), "tree": np_tree, "inputs": inputs,
        "ksplit": _ksplit()})
    trees = W.port_trees(np_tree)
    # one device has no tp packing: the tp-packed cases' single-device
    # tokens are those of the tp=1 tree (the same quantized values)
    trees["int4tp2"] = trees["int4"]
    single = {name: W.run_case(case, trees[case[2]], TCFG,
                               inputs[case[3]])
              for name, case in CASES.items()
              if not name.startswith(("sample", "graph"))}
    ref_trees = _ref_trees(np_tree)
    ref = {name: _ref_case(CASES[name], ref_trees, inputs)
           for name in REF_CASES}
    ref["w8a8_ksplit"] = _ref_ksplit(*_ksplit())
    return world.results(), single, ref


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith(("sample", "graph"))])
def test_mesh_decode_is_token_exact(run, name):
    ranks, single, ref = run
    want = single[name]
    for rank, (out, loaded) in enumerate(ranks):
        assert loaded == [], (rank, loaded)
        got = out[name]
        if isinstance(want, list):  # BatchedGenerator's texts
            assert got == want, rank
            continue
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"rank {rank}")
        if name in ref:
            for g, w in zip(got, ref[name]):
                np.testing.assert_array_equal(g, w, err_msg=f"rank {rank}")


def test_dead_rows_emit_nothing(run):
    ranks, _, _ = run
    for out, _ in ranks:
        for name in ("data_fp32", "tp_fp32", "gather_nf4"):
            toks, num = out[name]
            assert num[6] == 0 and (toks[6] == W.EOS).all(), name


def test_sampling_decorrelated_across_data_shards_lockstep_across_model(run):
    ranks, _, _ = run
    for name in ("sample_data", "sample_tp"):
        toks = ranks[0][0][name][0]
        for out, _ in ranks[1:]:  # every rank holds the same whole batch
            np.testing.assert_array_equal(out[name][0], toks)
        assert ((toks >= 0) & (toks < TCFG.llm.vocab_size)).all()
    # rows 0 and 2 sit on different data shards of {4, 1} (2 rows each),
    # rows 0 and 4 on different ones of {2, 2}
    assert not np.array_equal(ranks[0][0]["sample_data"][0][0],
                              ranks[0][0]["sample_data"][0][2])
    assert not np.array_equal(ranks[0][0]["sample_tp"][0][0],
                              ranks[0][0]["sample_tp"][0][4])
    # the two rows of one data shard draw apart too (the row index)
    assert not np.array_equal(ranks[0][0]["sample_data"][0][0],
                              ranks[0][0]["sample_data"][0][1])


def test_graph_true_under_gloo_is_refused(run):
    ranks, _, _ = run
    for out, _ in ranks:
        assert "gloo" in out["graph_true_gloo"]


def test_manual_tp_w8a8_ksplit_is_requantization(run):
    """W8A8's per-token scale over the local K shard: within the reference's
    bound of the one-device dense, and the reference's shard_map value."""
    ranks, _, ref = run
    y_full, y_tp = ref["w8a8_ksplit"]
    for out, _ in ranks:
        got = out["w8a8_ksplit"]
        err = float(np.abs(got - y_full).max())
        assert err < 0.05 * float(np.abs(y_full).max()), err
        np.testing.assert_allclose(got, y_tp, rtol=1e-5, atol=1e-6)


# ---- refusals: all raised before any collective ---------------------------


@pytest.fixture(scope="module")
def ports():
    return W.port_trees(jax_tree(CFG))


def _gen(params, m, inputs=None, **kw):
    ids, ims, lens = (torch.from_numpy(x) for x in (inputs or _inputs()))
    return generate.generate(params, TCFG, ids, ims, lens, 4, W.EOS, mesh=m,
                             **kw)


def test_batch_must_divide_data_axis(ports):
    m = mesh.mesh_shape({"data": 4, "model": 1})
    with pytest.raises(ValueError, match="mesh data axis"):
        _gen(ports["fp32"], m, _inputs(b=6, dead_rows=()))
    with pytest.raises(ValueError, match="mesh data axis"):
        ids, ims, lens = (torch.from_numpy(x)
                          for x in _inputs(b=6, dead_rows=()))
        beam.generate_beam(ports["fp32"], TCFG, ids, ims, lens, 4, W.EOS,
                           num_beams=2, mesh=m)


def test_tp_packed_tree_refused_on_global_routes(ports, monkeypatch):
    with pytest.raises(ValueError, match="w4_pack_tp"):
        _gen(ports["int4tp2"], None)
    monkeypatch.setenv("HALVA_TP_IMPL", "propagate")
    with pytest.raises(ValueError, match="w4_pack_tp"):
        _gen(ports["int4tp2"], mesh.mesh_shape({"data": 2, "model": 2}))
    with pytest.raises(ValueError, match="w4_pack_tp"):
        ids, ims, lens = (torch.from_numpy(x) for x in _inputs())
        beam.generate_beam(ports["int4tp2"], TCFG, ids, ims, lens, 4, W.EOS,
                           num_beams=2)


def test_beams_refuse_a_model_axis(ports):
    ids, ims, lens = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(ValueError, match="data: N"):
        beam.generate_beam(ports["fp32"], TCFG, ids, ims, lens, 4, W.EOS,
                           num_beams=2,
                           mesh=mesh.mesh_shape({"data": 2, "model": 2}))


@pytest.mark.parametrize("kw,match", [
    ({"continuous": True, "batch_size": 8}, "continuous"),
    ({"spec_k": 4}, "spec_k"),
    ({"num_beams": 2}, "data: N"),
    ({"batch_size": 3}, "mesh data axis"),
])
def test_batched_generator_refusals(ports, kw, match):
    m = mesh.mesh_shape({"data": 2, "model": 2})
    with pytest.raises(ValueError, match=match):
        runner.BatchedGenerator(ports["fp32"], TCFG, W.WordTok(), None,
                                mesh=m, **kw)


def test_placed_shards_need_their_mesh(ports):
    from halva_tpu_torch.parallel import partition

    placed = partition.place_serving(
        ports["fp32"], TCFG, mesh.mesh_shape({"data": 2, "model": 2}))
    assert placed.route == "manual_tp"
    with pytest.raises(ValueError, match="mesh"):
        _gen(placed, None)
