"""K6 in the port (halva_tpu_torch/ops/w4_matmul.py: w4_dense_stacked, which
takes its plain version on CPU tensors) against the reference's Pallas
w4_dense_stacked, called directly in interpret mode as tests/test_w4.py
calls it (block_np=64): per-channel (G=1) and grouped (G=2) scales, N/2 not
a multiple of the block, random packed bytes (so -8 nibbles occur), fp32
and bf16 activations. Also the K6 launch plan at the 7B shapes.

Tolerances: fp32 x: rtol = atol = 1e-5 (the Pallas kernel scales the dot
output when G=1 and the weights when G>1; in fp32 both are exact up to
summation order). bf16 x: the Pallas kernel rounds nibble*scale to bf16
when G>1 and both round the output to bf16, so |got - want| <=
2^-6 |want| + 2^-7 max|want|."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halva_tpu.ops import w4_matmul as jw4
from halva_tpu_torch import tree
from halva_tpu_torch.ops import w4_matmul

torch.set_num_threads(2)


def _random_stack(layers, k, np_, groups, seed):
    """Random packed bytes over the whole int8 range and positive bf16
    scales: the shapes of a stacked kernel_q4p / kernel_scale4p."""
    rng = np.random.RandomState(seed)
    q4p = rng.randint(-128, 128, (layers, k, np_)).astype(np.int8)
    s = np.asarray(jnp.asarray(rng.uniform(0.01, 0.1,
                                           (layers, 2, groups, np_)),
                               jnp.bfloat16))
    return {"kernel_q4p": q4p, "kernel_scale4p": s}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2])
def test_w4_dense_stacked_matches_pallas(groups, dtype):
    layers, k, np_, b = 2, 128, 96, 3  # N/2 = 96: 1.5 blocks of 64
    stack = _random_stack(layers, k, np_, groups, seed=groups)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x = np.asarray(jnp.asarray(np.random.RandomState(7).randn(b, k), jdt))
    lo, _ = w4_matmul.unpack_int4(torch.from_numpy(stack["kernel_q4p"]))
    assert int(lo.min()) == -8  # the quantizers never make -8; bytes do
    jstack = {key: jnp.asarray(v) for key, v in stack.items()}
    tstack = tree.to_torch(stack, device="cpu")
    tx = tree.to_torch([x], device="cpu")[0]
    for li in range(layers):
        want = np.asarray(jw4.w4_dense_stacked(
            jnp.asarray(x), jstack, jnp.int32(li), block_np=64), np.float32)
        got = w4_matmul.w4_dense_stacked(
            tx, {key: v[li] for key, v in tstack.items()})
        assert got.dtype == tx.dtype and got.shape == (b, 2 * np_)
        got = got.float().numpy()
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            bound = 2**-6 * np.abs(want) + 2**-7 * np.abs(want).max()
            assert (np.abs(got - want) <= bound).all()


def test_plain_is_the_dequant_matmul():
    """The plain version is nibble * scale in fp32, one matmul: the same as
    the reference's dense dequant branch in fp32."""
    stack = _random_stack(1, 64, 40, 4, seed=3)
    x = np.random.RandomState(4).randn(5, 64).astype(np.float32)
    p = {key: v[0] for key, v in tree.to_torch(stack, device="cpu").items()}
    got = w4_matmul.w4_dense_stacked_plain(torch.from_numpy(x), p)
    w = w4_matmul.dequantize_int4(p["kernel_q4p"], p["kernel_scale4p"],
                                  torch.float32)
    torch.testing.assert_close(got, torch.from_numpy(x) @ w, rtol=0, atol=0)
    lo, hi = jw4.unpack_int4(jnp.asarray(stack["kernel_q4p"][0]))
    s = np.repeat(stack["kernel_scale4p"][0].astype(np.float32), 16, axis=1)
    want_w = np.concatenate([np.asarray(lo) * s[0], np.asarray(hi) * s[1]], -1)
    np.testing.assert_array_equal(w.numpy(), want_w)


@pytest.mark.parametrize(
    "b,k,np_,want",
    [
        (4, 4096, 2048, (8, 4, 1024)),   # wq/wk/wv/wo: 32 tiles x 4 splits
        (4, 4096, 5504, (8, 3, 1376)),   # gate/up: 86 tiles x 3 splits
        (4, 11008, 2048, (8, 8, 1376)),  # down
        (1, 4096, 2048, (8, 4, 1024)),
        (80, 4096, 2048, (32, 2, 2048)),  # 3 row chunks of 32
        (3, 64, 96, (8, 1, 64)),         # small K is never split
    ],
)
def test_launch_plan(b, k, np_, want):
    rc, splits, ksplit = w4_matmul.plan(b, k, np_)
    assert (rc, splits, ksplit) == want
    assert ksplit % w4_matmul.K_TILE == 0
    assert (splits - 1) * ksplit < k <= splits * ksplit
