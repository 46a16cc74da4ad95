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
    "m,k,n,row_bytes,want",
    [
        # up to 32 rows: the decode-row loop, row tiles of 8 / 16 / 32 and
        # 64 weight bytes a row, one wave of at most two blocks per SM
        (16, 4096, 4096, 2048, ("mma", 16, 4, 16)),   # 32 tiles
        (16, 4096, 11008, 5504, ("mma", 16, 3, 22)),  # gate/up: 86 tiles
        (32, 11008, 4096, 2048, ("mma", 32, 8, 22)),  # down: 172 K tiles
        # above 32 rows: the TMA + wgmma path, 128 x 256 tiles, one block
        # per SM, K split while tiles underfill the 132 SMs
        (80, 4096, 4096, 4096, ("wgmma", 128, 8, 8)),
        (2492, 4096, 11008, 11008, ("wgmma", 128, 1, 64)),  # 860 tiles
        (4, 1024, 4096, 4096, ("mma", 8, 2, 8)),      # 64 tiles
        (9, 128, 64, 32, ("mma", 16, 1, 2)),
    ],
)
def test_gemm_launch_plan(m, k, n, row_bytes, want):
    from halva_tpu_torch.ops.int8_matmul import TILE_K, gemm_plan

    plan = gemm_plan(m, k, n, row_bytes)
    assert tuple(plan) == want
    kt = k // TILE_K
    assert (plan.splits - 1) * plan.tps < kt <= plan.splits * plan.tps


@pytest.mark.parametrize(
    "m,k,n,row_bytes,want",
    [
        (33, 4096, 4096, 2048, ("wgmma", 128, 8, 8)),  # the first row above
        (64, 4096, 4096, 4096, ("wgmma", 128, 8, 8)),
        (127, 4096, 11008, 5504, ("wgmma", 128, 3, 22)),
        (129, 4096, 11008, 5504, ("wgmma", 128, 3, 22)),  # 2 x 43 tiles
        # K7 at batch 80 (int4g, rows of 2048 / 5504 / 2048 packed bytes):
        # wq 16 tiles, gate/up 43 tiles, down 16 tiles of 172 K tiles
        (80, 4096, 4096, 2048, ("wgmma", 128, 8, 8)),
        (80, 4096, 11008, 5504, ("wgmma", 128, 3, 22)),
        (80, 11008, 4096, 2048, ("wgmma", 128, 8, 22)),
        # CLIP ViT-L's fc2 at 4 images of tower rows: 76 tiles on 132 SMs,
        # and no split: three would take 2 waves of 22 K tiles, but their
        # partials (3 x 2308 x 1024 fp32, written and read back) cost more
        # than the 20 K tiles they save
        (2308, 4096, 1024, 1024, ("wgmma", 128, 1, 64)),
        (2308, 1024, 4096, 4096, ("wgmma", 128, 1, 16)),  # 304 tiles
        (4348, 4096, 11008, 5504, ("wgmma", 128, 1, 64)),
    ],
)
def test_gemm_plan_above_32_rows(m, k, n, row_bytes, want):
    from halva_tpu_torch.ops.int8_matmul import TILE_K, gemm_plan

    plan = gemm_plan(m, k, n, row_bytes)
    assert tuple(plan) == want
    kt = k // TILE_K
    assert (plan.splits - 1) * plan.tps < kt <= plan.splits * plan.tps


@pytest.mark.parametrize("m", [33, 80, 300, 577, 2492])
@pytest.mark.parametrize("k,n,row_bytes", [
    (128, 72, 72),    # K8 with N = 72: a 72-byte weight row
    (256, 144, 72),   # K7 with N/2 = 72
    (4096, 11016, 5508),  # a 5,508-byte row: 4 past a multiple of 16
])
def test_gemm_plan_tma_stride_rule(m, k, n, row_bytes):
    """TMA takes global strides that are multiples of 16 bytes: weight rows
    of another length go to the 32-row tiles at every row count."""
    from halva_tpu_torch.ops.int8_matmul import (SMALL_M, TMA_STRIDE,
                                                 TILE_K, gemm_plan)

    assert row_bytes % TMA_STRIDE
    plan = gemm_plan(m, k, n, row_bytes)
    assert (plan.path, plan.bm) == ("mma", SMALL_M)
    kt = k // TILE_K
    assert (plan.splits - 1) * plan.tps < kt <= plan.splits * plan.tps
    assert gemm_plan(m, k, n, row_bytes + TMA_STRIDE - row_bytes
                     % TMA_STRIDE).path == "wgmma"


@pytest.mark.parametrize("m", [1, 8, 16, 32, 33, 80, 128, 129, 2308, 4348])
@pytest.mark.parametrize("k", [64, 128, 256, 1024, 4096, 11008, 14336])
def test_gemm_plan_splits_cover_k(m, k):
    """Every plan: splits * tps covers K's tiles with no empty split, at
    most MAX_SPLITS and at least MIN_TILES_PER_SPLIT a split when split,
    and a split plan's tiles within the ticket buffer."""
    from halva_tpu_torch import _kernels
    from halva_tpu_torch.ops.int8_matmul import (MAX_SPLITS,
                                                 MIN_TILES_PER_SPLIT,
                                                 TILE_K, TILE_N, gemm_plan)

    for n, row_bytes in ((n, b) for n in (64, 1024, 4096, 11008, 14336,
                                          32000) for b in (n, n // 2)):
        plan = gemm_plan(m, k, n, row_bytes)
        kt = k // TILE_K
        assert (plan.splits - 1) * plan.tps < kt <= plan.splits * plan.tps
        assert 1 <= plan.splits <= MAX_SPLITS
        if plan.splits > 1:
            assert plan.tps >= MIN_TILES_PER_SPLIT
            tiles = -(-m // plan.bm) * -(-n // TILE_N)
            assert tiles <= _kernels.MAX_TICKETS
        assert plan.path == ("wgmma" if m > 32 and row_bytes % 16 == 0
                             else "mma")
