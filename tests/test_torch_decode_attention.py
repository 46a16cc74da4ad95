"""K4 in the port (halva_tpu_torch/ops/decode_attention.py) against the
reference's Pallas decode kernel (interpret mode on the CPU, as
tests/test_decode_attention.py runs it) and its XLA oracle
llama._decode_attend, with bf16 prompt and gen caches at the shapes the
reference's own tests use: MHA, GQA, a prompt shorter than one block, a
single valid gen slot. On CPU tensors the port's wrapper takes its plain
version.

Tolerances: with an fp32 query every operand is exact in fp32 on both
sides, so rtol = atol = 1e-5. With a bf16 query the outputs are rounded to
bf16 and may differ by one bf16 step: rtol = 2^-7 (one step just above a
power of two), atol = 8e-3 near zero. Every row here is live (gen slot 0
is always visible, as in decode): on a row with no visible key the Pallas
kernel gives 0 and the oracle a uniform average."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.models.llama import _decode_attend as jax_decode_attend
from halva_tpu.ops.decode_attention import decode_attend_layer as jax_layer
from halva_tpu_torch import tree
from halva_tpu_torch.ops.decode_attention import (
    decode_attend_layer,
    decode_attend_plain,
)

torch.set_num_threads(2)

# name: (b, h, kvh, sp, d, sg, gen steps per row, dead prompt row)
CASES = {
    "mha": (2, 8, 8, 300, 64, 16, (3, 7), False),
    "gqa": (2, 8, 2, 300, 64, 16, (3, 7), False),
    "short_prompt": (2, 8, 8, 130, 64, 16, (5, 1), True),
    "single_gen_slot": (2, 8, 8, 300, 64, 16, (0, 0), False),
}


def _inputs(b, h, kvh, sp, d, sg, steps, dead_row, q_dtype, seed=0):
    rng = np.random.RandomState(seed)
    layers = 2

    def bf16(*shape):
        return np.asarray(jnp.asarray(rng.randn(*shape), jnp.bfloat16))

    q = np.asarray(jnp.asarray(rng.randn(b, 1, h, d), q_dtype))
    kp, vp = bf16(layers, b, kvh, sp, d), bf16(layers, b, kvh, sp, d)
    kg, vg = bf16(layers, b, kvh, sg, d), bf16(layers, b, kvh, sg, d)
    seg = np.ones((b, sp), np.int32)
    seg[0, sp - 50:] = 0
    seg[1, sp // 3:] = 0
    if dead_row:
        seg[1] = 0  # only its gen slots stay visible
    gv = np.arange(sg)[None, :] <= np.asarray(steps)[:, None]
    return q, kp, vp, kg, vg, seg, gv


@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_reference(name, q_dtype):
    b, h, kvh, sp, d, sg, steps, dead_row = CASES[name]
    jdt = jnp.float32 if q_dtype == "f32" else jnp.bfloat16
    arrays = _inputs(b, h, kvh, sp, d, sg, steps, dead_row, jdt)
    q, kp, vp, kg, vg, seg, gv = arrays
    tq, tkp, tvp, tkg, tvg, tseg, tgv = tree.to_torch(list(arrays))
    tol = dict(rtol=1e-5, atol=1e-5) if q_dtype == "f32" else dict(
        rtol=2**-7, atol=8e-3)
    for li in range(kp.shape[0]):
        got = decode_attend_layer(
            tq, {"k": tkp[li], "v": tvp[li]}, tseg,
            {"k": tkg[li], "v": tvg[li]}, tgv,
        )
        assert got.dtype == tq.dtype and got.shape == (b, 1, h, d)
        got = got.float().numpy()
        pallas = np.asarray(jax_layer(
            jnp.asarray(q), {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
            jnp.asarray(seg), {"k": jnp.asarray(kg), "v": jnp.asarray(vg)},
            jnp.asarray(gv), jnp.int32(li),
        ), np.float32)
        oracle = np.asarray(jax.jit(jax_decode_attend)(
            jnp.asarray(q), jnp.asarray(kp[li]), jnp.asarray(vp[li]),
            jnp.asarray(kg[li]), jnp.asarray(vg[li]), jnp.asarray(seg),
            jnp.asarray(gv),
        ), np.float32)
        np.testing.assert_allclose(got, oracle, **tol)
        np.testing.assert_allclose(got, pallas, **tol)


def test_cpu_wrapper_is_the_plain_version():
    arrays = _inputs(2, 8, 2, 40, 16, 8, (2, 5), False, jnp.float32)
    q, kp, vp, kg, vg, seg, gv = tree.to_torch(list(arrays))
    pc, gc = {"k": kp[0], "v": vp[0]}, {"k": kg[0], "v": vg[0]}
    torch.testing.assert_close(
        decode_attend_layer(q, pc, seg, gc, gv),
        decode_attend_plain(q, pc, seg, gc, gv), rtol=0, atol=0,
    )
