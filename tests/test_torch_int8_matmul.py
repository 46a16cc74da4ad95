"""K8 in the port (halva_tpu_torch/ops/int8_matmul.py: int8_matmul, which
takes int8_matmul_plain on CPU tensors) against the reference.

The reference's entry reaches its Pallas kernel only on a TPU (elsewhere it
returns the XLA dequant math), so the plain version is held against the
Pallas body, `halva_tpu.ops.int8_matmul._kernel`, through a `pl.pallas_call`
written out here with `interpret=True` and the entry's grid (M tiles x N
tiles, K whole, M and N padded to the tile), against the entry's XLA branch,
and against the port's `w8_dense`. 2-D and 3-D x, N not a multiple of the
block, (1, N) and (N,) scales.

Tolerances: fp32 x: rtol = atol = 1e-5 (the kernel scales the fp32 sum, the
XLA branch and w8_dense the weights: equal up to rounding order). bf16 x:
int8 values are exact in bf16 and both sum in fp32; the kernel and the plain
version round the output once, the XLA branch and w8_dense also round q *
scale to bf16 (2^-9 relative per weight): one bf16 step of the output's
scale, |got - want| <= 2^-7 (|want| + max|want| / 4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from halva_tpu.ops import int8_matmul as jint8
from halva_tpu.ops import quant as jquant
from halva_tpu_torch import tree
from halva_tpu_torch.ops import int8_matmul, quant

torch.set_num_threads(2)


def _pallas_int8_matmul(x2, q, scale2, bm, bn):
    """`_kernel` on the entry's grid, in interpret mode."""
    m, k = x2.shape
    n = q.shape[1]
    xp = jint8._pad_dim(x2, 0, bm)
    qp = jint8._pad_dim(q, 1, bn)
    sp = jint8._pad_dim(scale2, 1, bn)
    mp, np_ = xp.shape[0], qp.shape[1]
    out = pl.pallas_call(
        jint8._kernel,
        grid=(mp // bm, np_ // bn),
        in_specs=[
            pl.BlockSpec((bm, k), lambda i, j: (i, 0)),
            pl.BlockSpec((k, bn), lambda i, j: (0, j)),
            pl.BlockSpec((1, bn), lambda i, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((mp, np_), x2.dtype),
        interpret=True,
    )(xp, qp, sp)
    return out[:m, :n]


def _inputs(lead, k, n, dtype, seed):
    rng = np.random.RandomState(seed)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x = np.asarray(jnp.asarray(rng.randn(*lead, k), jdt))
    q = rng.randint(-127, 128, (k, n)).astype(np.int8)
    scale = np.asarray(jnp.asarray(rng.uniform(0.001, 0.01, (1, n)),
                                   jnp.bfloat16))
    return x, q, scale


def _assert_close(got, want, dtype):
    got = got.float().numpy().reshape(want.shape)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        bound = 2**-7 * (np.abs(want) + np.abs(want).max() / 4)
        assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
@pytest.mark.parametrize("n", [64, 40])  # 40: 1.25 blocks of 32
def test_int8_matmul_plain_matches_pallas_body(n, lead, dtype):
    k = 96
    x, q, scale = _inputs(lead, k, n, dtype, seed=n)
    tx, tq, ts = tree.to_torch([x, q, scale], device="cpu")
    got = int8_matmul.int8_matmul(tx, tq, ts)  # CPU: the plain version
    assert got.dtype == tx.dtype and got.shape == (*lead, n)
    torch.testing.assert_close(
        got, int8_matmul.int8_matmul_plain(tx, tq, ts), rtol=0, atol=0)
    torch.testing.assert_close(
        got, int8_matmul.int8_matmul(tx, tq, ts.reshape(-1)), rtol=0, atol=0)
    body = _pallas_int8_matmul(jnp.asarray(x).reshape(-1, k), jnp.asarray(q),
                               jnp.asarray(scale), bm=8, bn=32)
    _assert_close(got, np.asarray(body, np.float32), dtype)
    entry = jint8.int8_matmul(jnp.asarray(x), jnp.asarray(q),
                              jnp.asarray(scale))
    assert entry.shape == (*lead, n)
    _assert_close(got, np.asarray(entry, np.float32).reshape(-1, n), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_matmul_plain_matches_w8_dense(dtype):
    x, q, scale = _inputs((2, 7), 64, 48, dtype, seed=3)
    tx, tq, ts = tree.to_torch([x, q, scale], device="cpu")
    got = int8_matmul.int8_matmul_plain(tx, tq, ts)
    _assert_close(got, quant.w8_dense(tx, tq, ts).float().numpy(), dtype)
    want = jquant.w8_dense(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale))
    _assert_close(got, np.asarray(want, np.float32), dtype)
