"""Context parallelism of the port (parallel/context.py) against the
reference's (halva_tpu/parallel/context.py on the conftest's CPU devices),
forward and the grads of sum(out * w) in q, k and v, in fp32.

One spawn of 8 gloo ranks runs the mesh cases while this process computes
the reference's:
- packed rows (two documents and a padded tail, the cotangent zeroed on
  padded rows) with GQA and a window: {seq 4}, each half of the 8 ranks
  running it (the mesh {data 2, seq 4} with no batch axis);
- batch and sequence sharded together on {data 2, seq 4}.
In this process: the shard bodies one after another
(`sequential_cp_attention`, the form one card runs) against the full call
and the reference, and the body refused without a group. Tolerance 2e-5
(the reference's own tests; its 8-device run reads 3.87e-07).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from halva_tpu.parallel.context import (
    context_parallel_attention as jcp_attention,
)
from halva_tpu_torch.ops.flash_attention import flash_attention
from halva_tpu_torch.parallel.context import (
    cp_flash_attention,
    sequential_cp_attention,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_workers as W  # noqa: E402

TOL = 2e-5
SEQ4 = (("data", 2), ("seq", 4))


def _case(seed, b, s, h, kvh, d, seg_fn=None, window=None):
    rng = np.random.RandomState(seed)
    seg = np.ones((b, s), np.int32)
    if seg_fn is not None:
        seg_fn(seg)
    return {"q": rng.randn(b, s, h, d).astype(np.float32),
            "k": rng.randn(b, s, kvh, d).astype(np.float32),
            "v": rng.randn(b, s, kvh, d).astype(np.float32),
            "w": (rng.randn(b, s, h, d)
                  * (seg != 0)[:, :, None, None]).astype(np.float32),
            "seg": seg, "window": window}


def _packed(seg):
    """Two documents, then a padded tail."""
    seg[:, 100:200] = 2
    seg[:, 240:] = 0


CASES = [
    ("packed_gqa_window", SEQ4, None,
     _case(7, 2, 256, 4, 2, 32, _packed, window=96)),
    ("batch_and_seq", SEQ4, "data", _case(17, 2, 128, 2, 2, 32)),
]


def _reference(case, batch_axis):
    """The reference's context_parallel_attention on ("seq",) over 4
    devices, or ("data", "seq") over 8: out and grads."""
    devs = jax.devices()
    mesh = (Mesh(np.array(devs[:8]).reshape(2, 4), ("data", "seq"))
            if batch_axis else Mesh(np.array(devs[:4]), ("seq",)))
    seg = jnp.asarray(case["seg"])

    def f(q, k, v):
        o = jcp_attention(mesh, q, k, v, seg, seg, batch_axis=batch_axis,
                          sliding_window=case["window"])
        return jnp.sum(o * case["w"]), o

    (_, o), grads = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        *(jnp.asarray(case[n]) for n in ("q", "k", "v")))
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def run():
    world = W.World(W.cp_cases, 8, CASES)
    ref = {name: _reference(case, batch_axis)
           for name, _, batch_axis, case in CASES}
    return world.results(), ref


def _live(case):
    """The output rows a comparison reads: valid queries (the reference's
    padded rows are uniform attention over nothing; callers mask)."""
    return (case["seg"] != 0)[:, :, None, None]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_cp_matches_the_reference(run, name):
    ranks, ref = run
    case = next(c[3] for c in CASES if c[0] == name)
    live = _live(case)
    for rank, (out, loaded) in enumerate(ranks):
        assert loaded == [], loaded
        o, *grads = out[name]
        np.testing.assert_allclose(np.where(live, o, 0),
                                   np.where(live, ref[name][0], 0),
                                   atol=TOL, rtol=TOL, err_msg=f"rank {rank}")
        for g, w in zip(grads, ref[name][1:]):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sequential_shards_match_the_full_call(run, name):
    """The 4 shard bodies one after another over the whole K and V, with
    their q_offsets, against the full call and the reference."""
    _, ref = run
    case = next(c[3] for c in CASES if c[0] == name)
    outs = {}
    for form in ("shards", "full"):
        q, k, v = (torch.from_numpy(case[n]).requires_grad_()
                   for n in ("q", "k", "v"))
        seg = torch.from_numpy(case["seg"])
        if form == "shards":
            o = sequential_cp_attention(q, k, v, seg, seg, 4,
                                        sliding_window=case["window"])
        else:
            o = flash_attention(q, k, v, seg, seg,
                                sliding_window=case["window"])
        (o * torch.from_numpy(case["w"])).sum().backward()
        outs[form] = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
    live = _live(case)
    for want in (outs["full"], ref[name]):
        got = outs["shards"]
        np.testing.assert_allclose(np.where(live, got[0], 0),
                                   np.where(live, want[0], 0), atol=TOL,
                                   rtol=TOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="divide"):
        sequential_cp_attention(q, k, v, seg, seg, 3)


def test_cp_body_requires_a_group():
    """The per-shard body refuses to run without its seq group, as the
    reference's fails outside shard_map."""
    x = torch.zeros(1, 64, 2, 32)
    s = torch.ones(1, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="per-shard body"):
        cp_flash_attention(x, x, x, s, s)
