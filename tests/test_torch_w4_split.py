"""The decode-row loop's arithmetic (halva_tpu_torch/csrc/dq_rows.cuh: K6,
and K7 / K8 up to 32 rows) in torch ops, against the reference's Pallas
bodies, and the launch plans of that loop.

`w4_dense_stacked_split_plain` (K6), `w4_gemm_split_plain` (K7) and
`int8_matmul_split_plain` (K8) follow the kernel's K splits, each split's
per-warp K ranges and its merge order (warps in order, then splits in
order), with the bf16 rounding of nibble * scale for grouped scales. They
are held against `halva_tpu.ops.w4_matmul._w4_kernel` and
`halva_tpu.ops.int8_matmul._kernel` through a `pl.pallas_call` written out
here with `interpret=True` (off the TPU the reference's entries return XLA
math), under the plans' own and forced split counts: per-channel scales,
groups of 32 rows and of K/128, groups no multiple of the 32-row K tile
(the W4_ODD variant), N/2 = 8 x odd, B from 1 to 80.

Tolerances: fp32 x: rtol = 1e-5, atol = 5e-5 (the weights are exact in
fp32 on both sides; only the order of the sums differs, over up to 1,024
products whose partial sums reach ~20). bf16 x: both round nibble
* scale (or the int8 value) to bf16 the same way and sum in fp32; the
outputs round to bf16, so |got - want| <= 2^-7 |want| + 2^-10 max|want|
(one bf16 step either way, and the summation order's rounding near 0)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from halva_tpu.ops import int8_matmul as jint8
from halva_tpu.ops import w4_matmul as jw4
from halva_tpu_torch import _kernels, tree
from halva_tpu_torch.ops import int8_matmul, w4_matmul

torch.set_num_threads(2)


def _pallas_w4(x2, q4p, s, bnp=32):
    """`_w4_kernel` on the grid of `w4_dense_stacked` (column blocks, x and
    K whole), in interpret mode."""
    b, k = x2.shape
    np_, ng = q4p.shape[1], s.shape[1]
    out = pl.pallas_call(
        jw4._w4_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(pl.cdiv(np_, bnp),),
            in_specs=[
                pl.BlockSpec((b, k), lambda ni, li: (0, 0)),
                pl.BlockSpec((1, k, bnp), lambda ni, li: (0, 0, ni)),
                pl.BlockSpec((1, 2, ng, bnp), lambda ni, li: (0, 0, 0, ni)),
            ],
            out_specs=pl.BlockSpec((2, b, bnp), lambda ni, li: (0, 0, ni)),
        ),
        out_shape=jax.ShapeDtypeStruct((2, b, np_), x2.dtype),
        interpret=True,
    )(jnp.zeros((1,), jnp.int32), x2, q4p[None], s[None])
    return np.asarray(jnp.concatenate([out[0], out[1]], axis=-1), np.float32)


def _pallas_int8(x2, q, scale2, bn=32):
    """`_kernel` on the entry's grid, in interpret mode."""
    m, k = x2.shape
    n = q.shape[1]
    qp = jint8._pad_dim(q, 1, bn)
    sp = jint8._pad_dim(scale2, 1, bn)
    out = pl.pallas_call(
        jint8._kernel,
        grid=(1, qp.shape[1] // bn),
        in_specs=[
            pl.BlockSpec((m, k), lambda i, j: (0, 0)),
            pl.BlockSpec((k, bn), lambda i, j: (0, j)),
            pl.BlockSpec((1, bn), lambda i, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((m, bn), lambda i, j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((m, qp.shape[1]), x2.dtype),
        interpret=True,
    )(x2, qp, sp)
    return np.asarray(out[:, :n], np.float32)


def _close(got, want, dtype):
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5)
    else:
        bound = 2**-7 * np.abs(want) + 2**-10 * np.abs(want).max()
        assert (np.abs(got - want) <= bound).all(), float(
            (np.abs(got - want) - bound).max())


def _x(b, k, dtype, seed):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return np.asarray(jnp.asarray(
        np.random.RandomState(seed).randn(b, k), jdt))


def _w4(k, np_, groups, seed):
    rng = np.random.RandomState(seed)
    q4p = rng.randint(-128, 128, (k, np_)).astype(np.int8)
    s = np.asarray(jnp.asarray(rng.uniform(0.01, 0.1, (2, groups, np_)),
                               jnp.bfloat16))
    return q4p, s


def _forced(plan, k, splits_list):
    """The plan with each of `splits_list` splits (rows per split a multiple
    of the 32-row tile, no split empty), beside its own."""
    rc, _, _ = plan
    kt = -(-k // w4_matmul.K_TILE)
    out = {plan}
    for want in splits_list:
        tps = -(-kt // min(want, kt))
        out.add((rc, -(-kt // tps), tps * w4_matmul.K_TILE))
    return sorted(out)


# (K, N/2, G): per channel, groups of 32 rows, groups of K/128, groups of 16
# rows (no multiple of the 32-row tile: W4_ODD), groups of 24 rows and a K
# that is no multiple of the tile
K6_CASES = [(1024, 72, 1), (1024, 40, 32), (1024, 72, 8), (256, 40, 16),
            (480, 24, 20)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 3, 4, 8, 80])
@pytest.mark.parametrize("k,np_,groups", K6_CASES)
def test_k6_split_plain_matches_pallas(k, np_, groups, b, dtype):
    q4p, s = _w4(k, np_, groups, seed=k + groups)
    x = _x(b, k, dtype, seed=b)
    want = _pallas_w4(jnp.asarray(x), jnp.asarray(q4p), jnp.asarray(s))
    tx, tq, ts = tree.to_torch([x, q4p, s], device="cpu")
    p = {"kernel_q4p": tq, "kernel_scale4p": ts}
    plan = w4_matmul.plan(b, k, np_, groups)
    if w4_matmul.odd_groups(k, groups):
        assert plan[0] == 8
    for forced in _forced(plan, k, (1, 2, 3, 5)):
        got = w4_matmul.w4_dense_stacked_split_plain(tx, p, forced)
        assert got.dtype == tx.dtype and got.shape == (b, 2 * np_)
        _close(got, want, dtype)


@pytest.mark.parametrize("m", [9, 16, 17, 32, 577])
@pytest.mark.parametrize("groups", [1, 4])
def test_k7_split_plain_matches_pallas(groups, m):
    """K7 on the decode-row loop: 9-32 rows, and 577 rows with weight rows
    that are no multiple of 16 bytes (TMA's stride rule): gemm_plan's "mma"
    path, and forced split counts."""
    k, np_ = 512, 40 if m == 577 else 64
    q4p, s = _w4(k, np_, groups, seed=m + groups)
    x = _x(m, k, "bf16", seed=m)
    want = _pallas_w4(jnp.asarray(x), jnp.asarray(q4p), jnp.asarray(s))
    tx, tq, ts = tree.to_torch([x, q4p, s], device="cpu")
    plan = int8_matmul.gemm_plan(m, k, 2 * np_, np_)
    assert plan.path == "mma"
    for splits in sorted({plan.splits, 1, 2, 4}):
        forced = plan._replace(**dict(zip(
            ("splits", "tps"), int8_matmul.split_k(k // 64, splits))))
        got = w4_matmul.w4_gemm_split_plain(tx, tq, ts, forced)
        _close(got, want, "bf16")


@pytest.mark.parametrize("m", [1, 4, 9, 32, 577])
@pytest.mark.parametrize("n", [64, 72])
def test_k8_split_plain_matches_pallas(n, m):
    k = 512
    if m > int8_matmul.SMALL_M and n % int8_matmul.TMA_STRIDE == 0:
        n = 40  # above 32 rows only TMA's stride rule takes this path
    rng = np.random.RandomState(m + n)
    q = rng.randint(-127, 128, (k, n)).astype(np.int8)
    scale = np.asarray(jnp.asarray(rng.uniform(0.001, 0.01, (1, n)),
                                   jnp.bfloat16))
    x = _x(m, k, "bf16", seed=n)
    want = _pallas_int8(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale))
    tx, tq, tscale = tree.to_torch([x, q, scale], device="cpu")
    plan = int8_matmul.gemm_plan(m, k, n, n)
    assert plan.path == "mma"
    for splits in sorted({plan.splits, 1, 2, 4}):
        forced = plan._replace(**dict(zip(
            ("splits", "tps"), int8_matmul.split_k(k // 64, splits))))
        got = int8_matmul.int8_matmul_split_plain(tx, tq, tscale, forced)
        assert got.shape == (m, n)
        _close(got, want, "bf16")
    torch.testing.assert_close(
        int8_matmul.int8_matmul_split_plain(tx, tq, tscale),
        int8_matmul.int8_matmul_plain(tx, tq, tscale), rtol=2**-7, atol=1e-3)


def test_split_plain_refuses_a_wgmma_plan():
    x = torch.zeros(80, 128, dtype=torch.bfloat16)
    q = torch.zeros(128, 64, dtype=torch.int8)
    plan = int8_matmul.gemm_plan(80, 128, 64, 64)
    assert plan.path == "wgmma"
    with pytest.raises(ValueError, match="'mma' plan"):
        int8_matmul.int8_matmul_split_plain(x, q, torch.ones(64), plan)
    with pytest.raises(ValueError, match="'mma' plan"):
        w4_matmul.w4_gemm_split_plain(x, q[:, :32], torch.ones(2, 1, 32),
                                      plan)


SM = int8_matmul.SM_COUNT
W4_7B = [(4096, 2048), (4096, 5504), (11008, 2048)]  # (K, N/2): wq, gate/up, down


def _k6_shapes():
    for b in (1, 2, 3, 4, 8, 9, 16, 17, 32, 33, 80):
        for k, np_ in W4_7B + [(64, 96), (480, 24), (14336, 2048),
                               (4096, 7168), (4096, 512)]:
            for groups in (1, k // 32, max(1, k // 128), k // 16):
                if k % groups == 0:
                    yield b, k, np_, groups


def test_k6_plan_covers_k_once_with_no_empty_split():
    for b, k, np_, groups in _k6_shapes():
        rc, splits, ksplit = w4_matmul.plan(b, k, np_, groups)
        assert rc in int8_matmul.ROW_CHUNKS
        assert ksplit % w4_matmul.K_TILE == 0
        assert (splits - 1) * ksplit < k <= splits * ksplit
        ranges = int8_matmul.row_ranges(k, splits, ksplit // w4_matmul.K_TILE)
        rows = [r for split in ranges for b_, e in split
                for r in range(b_, e)]
        assert rows == list(range(k))  # every K row once, in order
        for split in ranges:
            assert split[0][0] < split[-1][1]  # no split is empty
        tiles = -(-np_ // w4_matmul.TILE_NP) * -(-b // rc)
        assert tiles <= _kernels.MAX_TICKETS
        if w4_matmul.odd_groups(k, groups):
            assert rc == 8
        else:
            assert rc >= min(b, 32)


@pytest.mark.parametrize("k,np_", W4_7B)
@pytest.mark.parametrize("b", [1, 4, 8, 16])
def test_k6_plan_is_one_wave_at_the_7b_shapes(k, np_, b):
    """Column tiles x row chunks x splits within the blocks the plan aims
    at on every SM, and a block on at least 90 % of the SMs: one wave, no
    ragged one."""
    rc, splits, _ = w4_matmul.plan(b, k, np_, k // 128)
    blocks = -(-np_ // w4_matmul.TILE_NP) * -(-b // rc) * splits
    assert 0.9 * SM <= blocks <= int8_matmul.ROWS_BLOCKS_PER_SM * SM


def test_k6_plan_follows_the_sm_count():
    """A pure function of the shapes and the SM count: the same every call,
    and the SM count moves only the split count."""
    for b, k, np_, groups in _k6_shapes():
        full = w4_matmul.plan(b, k, np_, groups)
        assert w4_matmul.plan(b, k, np_, groups) == full
        half = w4_matmul.plan(b, k, np_, groups, sms=SM // 2)
        assert half[0] == full[0]
        assert (half[1] - 1) * half[2] < k <= half[1] * half[2]


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 17, 31, 32])
def test_gemm_plan_row_tile_up_to_32_rows(m):
    for k, n, row_bytes in ((4096, 4096, 2048), (4096, 11008, 5504),
                            (11008, 4096, 2048), (4096, 11008, 11008),
                            (1024, 1040, 1040), (128, 72, 72)):
        plan = int8_matmul.gemm_plan(m, k, n, row_bytes)
        assert plan.path == "mma" and plan.bm == int8_matmul.row_chunk(m)
        assert plan.bm >= m and plan.bm // 2 < max(m, 8)
        kt = k // int8_matmul.TILE_K
        assert (plan.splits - 1) * plan.tps < kt <= plan.splits * plan.tps
        tiles = int8_matmul.plan_tiles(plan, m, n, row_bytes)
        assert tiles * plan.splits <= 2 * int8_matmul.ROWS_BLOCKS_PER_SM * SM


@pytest.mark.parametrize("k,splits,tps", [(1024, 1, 32), (1024, 3, 11),
                                          (480, 2, 8), (100, 1, 4),
                                          (4096, 16, 8)])
def test_row_ranges_cover_k_in_order(k, splits, tps):
    ranges = int8_matmul.row_ranges(k, splits, tps)
    assert len(ranges) == splits
    assert all(len(split) == int8_matmul.ROWS_WARPS for split in ranges)
    flat = [r for split in ranges for r in split]
    assert flat[0][0] == 0 and flat[-1][1] == k
    for (b0, e0), (b1, e1) in zip(flat, flat[1:]):
        assert b0 <= e0 == b1 <= e1
