"""K7 in the port (halva_tpu_torch/ops/w4_matmul.py: w4_gemm, which takes
w4_gemm_plain on CPU tensors) against the reference.

The reference's `w4_gemm` reaches its Pallas kernel only on a TPU: elsewhere
`_w4_gemm_impl` returns the XLA dequant math. So the plain version is held
against the Pallas body itself, `_w4_kernel`, through a `pl.pallas_call`
written out here with `interpret=True` and the grid of `_w4_gemm_impl` (M
tiles x N/2 tiles, K whole per block, x padded to the M tile), and against
the entry's XLA branch with concrete weights. Per-channel (G=1) and grouped
(G=2) scales, M not a multiple of 8, a 3-D x, random packed bytes (so -8
nibbles occur). The Function's dx is held against jax.grad of the
reference's custom VJP.

Tolerances: fp32 x: rtol = atol = 1e-5 (scaling the dot's output or the
weights is exact in fp32 up to summation order). bf16 x: the G>1 Pallas body
rounds nibble * scale to bf16 before the dot, the plain version does not,
and both round the output to bf16: atol=0.1, rtol=0.05, what the
reference's own tests/test_w4.py uses at these sizes. dx in fp32:
rtol = atol = 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from halva_tpu.ops import w4_matmul as jw4
from halva_tpu_torch import tree
from halva_tpu_torch.ops import w4_matmul

torch.set_num_threads(2)


def _weights(k, np_, groups, seed):
    rng = np.random.RandomState(seed)
    q4p = rng.randint(-128, 128, (k, np_)).astype(np.int8)
    s = np.asarray(jnp.asarray(rng.uniform(0.01, 0.1, (2, groups, np_)),
                               jnp.bfloat16))
    return q4p, s


def _pallas_w4_gemm(x2, q4p, s, bm, bnp):
    """`_w4_kernel` on the grid of `_w4_gemm_impl`, in interpret mode."""
    m, k = x2.shape
    np_, ng = q4p.shape[1], s.shape[1]
    pad = (-m) % bm
    xp = jnp.pad(x2, ((0, pad), (0, 0)))
    mp = xp.shape[0]
    out = pl.pallas_call(
        jw4._w4_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(mp // bm, pl.cdiv(np_, bnp)),
            in_specs=[
                pl.BlockSpec((bm, k), lambda mi, ni, li: (mi, 0)),
                pl.BlockSpec((1, k, bnp), lambda mi, ni, li: (0, 0, ni)),
                pl.BlockSpec((1, 2, ng, bnp),
                             lambda mi, ni, li: (0, 0, 0, ni)),
            ],
            out_specs=pl.BlockSpec((2, bm, bnp),
                                   lambda mi, ni, li: (0, mi, ni)),
        ),
        out_shape=jax.ShapeDtypeStruct((2, mp, np_), x2.dtype),
        interpret=True,
    )(jnp.zeros((1,), jnp.int32), xp, q4p[None], s[None])
    return jnp.concatenate([out[0], out[1]], axis=-1)[:m]


def _tol(dtype):
    if dtype == "f32":
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=0.05, atol=0.1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("lead", [(13,), (2, 5)])
def test_w4_gemm_plain_matches_pallas_body(lead, groups, dtype):
    k, np_ = 128, 64
    q4p, s = _weights(k, np_, groups, seed=groups)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x = np.asarray(jnp.asarray(
        np.random.RandomState(7).randn(*lead, k), jdt))
    lo, _ = w4_matmul.unpack_int4(torch.from_numpy(q4p))
    assert int(lo.min()) == -8
    tx, tq, ts = tree.to_torch([x, q4p, s], device="cpu")
    got = w4_matmul.w4_gemm(tx, tq, ts)  # CPU tensors: the plain version
    assert got.dtype == tx.dtype and got.shape == (*lead, 2 * np_)
    torch.testing.assert_close(got, w4_matmul.w4_gemm_plain(tx, tq, ts),
                               rtol=0, atol=0)
    got = got.float().numpy().reshape(-1, 2 * np_)
    body = _pallas_w4_gemm(jnp.asarray(x).reshape(-1, k), jnp.asarray(q4p),
                           jnp.asarray(s), bm=8, bnp=32)
    np.testing.assert_allclose(got, np.asarray(body, np.float32),
                               **_tol(dtype))
    # the entry off the TPU: the XLA dequant math, concrete weights
    entry = jw4.w4_gemm(jnp.asarray(x), jnp.asarray(q4p), jnp.asarray(s))
    assert entry.shape == (*lead, 2 * np_)
    np.testing.assert_allclose(
        got, np.asarray(entry, np.float32).reshape(-1, 2 * np_),
        **_tol(dtype))


def test_w4_gemm_is_k6s_function():
    """One arithmetic for both kernels' plain versions: the routing rule
    between K6 and K7 changes no value on CPU tensors."""
    q4p, s = _weights(64, 40, 4, seed=3)
    x = torch.from_numpy(np.random.RandomState(4).randn(11, 64)
                         .astype(np.float32)).bfloat16()
    tq, ts = tree.to_torch([q4p, s], device="cpu")
    p = {"kernel_q4p": tq, "kernel_scale4p": ts}
    want = w4_matmul.w4_dense_stacked_plain(x, p)
    torch.testing.assert_close(w4_matmul.w4_gemm_plain(x, tq, ts), want,
                               rtol=0, atol=0)
    assert w4_matmul.W4_GEMV_MAX_ROWS in (8, 16)
    for rows in (1, 8, 11):
        torch.testing.assert_close(w4_matmul.w4_decode_matmul(x[:rows], p),
                                   want[:rows], rtol=0, atol=0)


@pytest.mark.parametrize("groups", [1, 2])
def test_w4_gemm_dx_matches_reference_vjp(groups):
    """tests/test_w4.py's own check of the reference, carried across: the
    gradient wrt x is g @ dequant(W).T, and the packed weights get none."""
    k, np_, m = 128, 64, 6
    q4p, s = _weights(k, np_, groups, seed=10 + groups)
    rng = np.random.RandomState(5)
    x = rng.randn(2, m, k).astype(np.float32)
    g = rng.randn(2, m, 2 * np_).astype(np.float32)

    def loss(xx):
        y = jw4.w4_gemm(xx, jnp.asarray(q4p), jnp.asarray(s))
        return jnp.sum(y * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tq, ts = tree.to_torch([q4p, s], device="cpu")
    tx = torch.from_numpy(x).requires_grad_()
    ts.requires_grad_()  # a float leaf that asks: it must get nothing
    y = w4_matmul.w4_gemm(tx, tq, ts)
    dx, ds = torch.autograd.grad(y, (tx, ts), torch.from_numpy(g),
                                 allow_unused=True)
    np.testing.assert_allclose(dx.numpy(), want, rtol=1e-5, atol=1e-5)
    assert ds is None
    # and an integer leaf cannot ask at all
    with pytest.raises(RuntimeError):
        tq.requires_grad_()


def test_w4_gemm_dx_in_bf16_dequantizes_in_g_dtype():
    q4p, s = _weights(64, 32, 2, seed=21)
    tq, ts = tree.to_torch([q4p, s], device="cpu")
    tx = torch.randn(5, 64, generator=torch.Generator().manual_seed(0)
                     ).bfloat16().requires_grad_()
    g = torch.randn(5, 64, generator=torch.Generator().manual_seed(1)
                    ).bfloat16()
    (dx,) = torch.autograd.grad(w4_matmul.w4_gemm(tx, tq, ts), tx, g)
    want = g @ w4_matmul.dequantize_int4(tq, ts, torch.bfloat16).t()
    torch.testing.assert_close(dx, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "m,k,n,want",
    [
        (16, 4096, 4096, (32, 16, 4)),    # 16 tiles of 256 channels
        (16, 4096, 11008, (32, 6, 11)),   # gate/up: 43 tiles
        (32, 11008, 4096, (32, 16, 11)),  # down: 172 K tiles
        (80, 4096, 4096, (128, 8, 8)),    # above 32 rows: the 128-row tile
        (2492, 4096, 11008, (128, 1, 64)),  # prefill M fills the card
        (4, 1024, 4096, (32, 4, 4)),      # no split under 4 K tiles
        (9, 128, 64, (32, 1, 2)),
    ],
)
def test_gemm_launch_plan(m, k, n, want):
    from halva_tpu_torch.ops.int8_matmul import TILE_K, gemm_plan

    bm, splits, tps = gemm_plan(m, k, n)
    assert (bm, splits, tps) == want
    kt = k // TILE_K
    assert (splits - 1) * tps < kt <= splits * tps
