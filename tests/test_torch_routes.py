"""The two route rules that decide, from shapes and dtypes alone and before
any launch, which kernel a quantized matmul takes on the card:

- `w4_matmul.w4_route`: a decode-family packed-int4 matmul goes to K7
  (`w4_gemm`) above W4_GEMV_MAX_ROWS rows only where K7 takes the weights
  (K % 64 == 0, N/2 % 8 == 0, scale groups of a multiple of 64 rows); the
  rest go to K6 (`w4_dense_stacked`), which takes any K % G == 0. A tree
  packed with group_size=32 used to raise above 8 rows on the card.
- `int8_matmul.int8_matmul_takes`: `w8_dense` launches K8 only for bf16 x
  and scales with K % 64 == 0 and N % 8 == 0; anything else (an fp32 tree's
  CLIP tower) computes the reference's own expression x @ (q * scale) in x's
  dtype, as the reference does for every shape. It used to raise.

On CPU tensors both routes take the same plain arithmetic, held here against
the reference (the XLA math of `halva_tpu.ops.w4_matmul.w4_gemm` off the TPU,
and `halva_tpu.ops.quant.w8_dense`): fp32, rtol = atol = 1e-5. The same
calls on the card are in tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halva_tpu.ops import quant as jquant
from halva_tpu.ops import w4_matmul as jw4
from halva_tpu_torch import _kernels, tree
from halva_tpu_torch.ops import quant, w4_matmul
from halva_tpu_torch.ops.int8_matmul import int8_matmul_takes

torch.set_num_threads(2)

GEMV, GEMM = w4_matmul.KERNEL, w4_matmul.GEMM_KERNEL

# (rows, K, N/2, scale groups, the kernel)
W4_ROUTES = [
    (1, 4096, 2048, 1, GEMV),
    (8, 4096, 2048, 1, GEMV),  # W4_GEMV_MAX_ROWS itself
    (9, 4096, 2048, 1, GEMM),
    (16, 4096, 2048, 32, GEMM),  # group_size 128: groups of 128 rows
    (16, 4096, 2048, 128, GEMV),  # group_size 32: K7 refuses the groups
    (80, 4096, 2048, 128, GEMV),
    (80, 11008, 2048, 344, GEMV),  # group_size 32 on the down projection
    (80, 11008, 2048, 86, GEMM),  # group_size 128 there
    (32, 4096, 2048, 64, GEMM),  # group_size 64: one K tile a group
    (16, 4160, 512, 1, GEMM),
    (16, 4100, 512, 1, GEMV),  # K no multiple of 64
    (16, 4096, 2052, 1, GEMV),  # N/2 no multiple of 8: K6 raises alike
    (16, 4096, 2048, 3, GEMV),  # K % G != 0: K6 raises alike
]


@pytest.mark.parametrize("rows,k,n_half,groups,want", W4_ROUTES)
def test_w4_route(rows, k, n_half, groups, want):
    assert w4_matmul.w4_route(rows, k, n_half, groups) == want
    assert w4_matmul.w4_gemm_takes(k, n_half, groups) == (
        k % 64 == 0 and n_half % 8 == 0 and k % groups == 0
        and (groups == 1 or (k // groups) % 64 == 0))


def test_w4_route_follows_the_row_rule(monkeypatch):
    """The rule reads W4_GEMV_MAX_ROWS when it is called (the tests that
    drive K7's route on the CPU patch it to 1)."""
    monkeypatch.setattr(w4_matmul, "W4_GEMV_MAX_ROWS", 1)
    assert w4_matmul.w4_route(2, 4096, 2048, 1) == GEMM
    assert w4_matmul.w4_route(2, 4096, 2048, 128) == GEMV
    assert w4_matmul.w4_route(1, 4096, 2048, 1) == GEMV


def _int4_tree(k, n, group_size, seed):
    """One layer of the reference's packed int4 quantizer."""
    rng = np.random.RandomState(seed)
    w = rng.randn(1, k, n).astype(np.float32) * 0.05
    p = jw4.quantize_kernel_int4_stacked(jnp.asarray(w),
                                         group_size=group_size)
    return (np.asarray(p["kernel_q4p"][0]),
            np.asarray(p["kernel_scale4p"][0].astype(jnp.float32)))


@pytest.mark.parametrize("rows", [4, 16, 80])
@pytest.mark.parametrize("group_size", [32, 128])
def test_w4_decode_matmul_takes_the_route_and_the_references_value(
        rows, group_size, monkeypatch):
    """On CPU tensors `w4_decode_matmul` calls the kernel wrapper the rule
    names (recorded) and gives the reference's value on a tree packed with
    group_size 32 or 128."""
    k, n = 256, 128
    q4p, s = _int4_tree(k, n, group_size, seed=rows)
    x = np.random.RandomState(rows + 1).randn(rows, k).astype(np.float32)
    tq, ts = tree.to_torch([q4p, s], device="cpu")
    p = {"kernel_q4p": tq, "kernel_scale4p": ts.bfloat16()}
    called = []
    for name in ("w4_gemm", "w4_dense_stacked"):
        fn = getattr(w4_matmul, name)
        monkeypatch.setattr(w4_matmul, name,
                            lambda *a, _fn=fn, _n=name: called.append(_n)
                            or _fn(*a))
    got = w4_matmul.w4_decode_matmul(torch.from_numpy(x), p)
    want_kernel = w4_matmul.w4_route(rows, k, n // 2, k // group_size)
    assert called == ["w4_gemm" if want_kernel == GEMM
                      else "w4_dense_stacked"]
    if group_size == 32 and rows > w4_matmul.W4_GEMV_MAX_ROWS:
        assert want_kernel == GEMV
    ref = jw4.w4_gemm(jnp.asarray(x), jnp.asarray(q4p),
                      jnp.asarray(np.asarray(p["kernel_scale4p"].float())))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _meta(shape, dtype):
    return torch.empty(*shape, dtype=dtype, device="meta")


# (x, q, scale) shapes and dtypes; K8 takes the first only
INT8_CASES = {
    "bf16": ((20, 128), torch.bfloat16, (128, 64), torch.int8,
             (1, 64), torch.bfloat16, True),
    "bf16_3d": ((2, 10, 128), torch.bfloat16, (128, 64), torch.int8,
                (64,), torch.bfloat16, True),
    "fp32_x": ((20, 128), torch.float32, (128, 64), torch.int8,
               (1, 64), torch.bfloat16, False),
    "fp32_scale": ((20, 128), torch.bfloat16, (128, 64), torch.int8,
                   (1, 64), torch.float32, False),
    "k_100": ((20, 100), torch.bfloat16, (100, 64), torch.int8,
              (1, 64), torch.bfloat16, False),
    "siglip_fc2_k": ((20, 4304), torch.bfloat16, (4304, 1152), torch.int8,
                     (1, 1152), torch.bfloat16, False),
    "n_60": ((20, 128), torch.bfloat16, (128, 60), torch.int8,
             (1, 60), torch.bfloat16, False),
    "k_mismatch": ((20, 64), torch.bfloat16, (128, 64), torch.int8,
                   (1, 64), torch.bfloat16, False),
    "no_rows": ((0, 128), torch.bfloat16, (128, 64), torch.int8,
                (1, 64), torch.bfloat16, False),
    "q_3d": ((20, 128), torch.bfloat16, (2, 128, 64), torch.int8,
             (1, 64), torch.bfloat16, False),
}


@pytest.mark.parametrize("name", list(INT8_CASES))
def test_int8_matmul_takes(name):
    xs, xd, qs, qd, ss, sd, want = INT8_CASES[name]
    assert int8_matmul_takes(_meta(xs, xd), _meta(qs, qd),
                             _meta(ss, sd)) is want


def test_w8_dense_on_meta_tensors_routes_by_the_rule():
    """Off the CPU, what K8 takes goes to its wrapper (which raises for a
    tensor that is not on a CUDA device); what it does not take computes
    the reference's expression, with no launch."""
    q, s = _meta((128, 64), torch.int8), _meta((1, 64), torch.bfloat16)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        quant.w8_dense(_meta((20, 128), torch.bfloat16), q, s)
    y = quant.w8_dense(_meta((20, 128), torch.float32), q, s)
    assert y.shape == (20, 64) and y.dtype == torch.float32
    assert sum(_kernels.launches.values()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8_dense_is_the_references_expression(dtype):
    """x @ (q * scale) in x's dtype, as halva_tpu.ops.quant.w8_dense."""
    rng = np.random.RandomState(3)
    w = rng.randn(96, 40).astype(np.float32) * 0.1
    p = jquant.quantize_kernel(jnp.asarray(w))
    x = rng.randn(5, 96).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jquant.w8_dense(jnp.asarray(x, jdt), p["kernel_q"],
                                      p["kernel_scale"]).astype(jnp.float32))
    tq, ts = tree.to_torch([np.asarray(p["kernel_q"]),
                            np.asarray(p["kernel_scale"].astype(jnp.float32))],
                           device="cpu")
    got = quant.w8_dense(torch.from_numpy(x).to(dtype), tq,
                         ts.to(torch.bfloat16))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
