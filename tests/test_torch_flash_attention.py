"""K1 in the port (halva_tpu_torch/ops/flash_attention.py) against the
reference's Pallas flash attention, which runs in interpret mode on the CPU
as tests/test_flash_attention.py runs it. On CPU tensors the port's wrapper
takes its plain version, so this holds the plain version's semantics:
segment ids (padding, packing), causal and not, GQA, lengths that are not a
block multiple.

Tolerance: fp32, rtol = atol = 1e-5, on live query rows only. Fully masked
rows (segment id 0) are never read; there the reference gives the mean of V
and the CUDA kernel gives 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halva_tpu.ops.flash_attention import flash_attention as jax_flash
from halva_tpu_torch import _kernels
from halva_tpu_torch.ops.attention import attention
from halva_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(2)

# name: (b, s, h, kvh, d, causal, segment layout)
CASES = {
    "causal": (2, 256, 4, 4, 32, True, "full"),
    "noncausal": (2, 256, 4, 4, 32, False, "full"),
    "padding": (2, 192, 2, 2, 32, True, "pad"),
    "packed": (1, 256, 2, 2, 32, True, "packed"),
    "gqa": (1, 128, 8, 2, 32, True, "pad"),
    "nonmultiple": (2, 200, 4, 2, 64, True, "pad"),
}


def _inputs(b, s, h, kvh, d, layout, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, kvh, d).astype(np.float32)
    v = rng.randn(b, s, kvh, d).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    if layout == "pad":
        seg[0, s - 37:] = 0
        if b > 1:
            seg[1, s // 3:] = 0
    elif layout == "packed":
        seg[:, s // 2 + 3:] = 2
        seg[:, s - 20:] = 0
    return q, k, v, seg


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret(name):
    b, s, h, kvh, d, causal, layout = CASES[name]
    q, k, v, seg = _inputs(b, s, h, kvh, d, layout)
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(seg), jnp.asarray(seg), causal=causal,
    ))
    t = [torch.from_numpy(x) for x in (q, k, v, seg)]
    got = flash_attention(t[0], t[1], t[2], t[3], t[3], causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
    live = seg != 0
    np.testing.assert_allclose(got.numpy()[live], want[live],
                               rtol=1e-5, atol=1e-5)


def test_cpu_dispatch_takes_plain_and_counts_no_launch():
    q, k, v, seg = (torch.from_numpy(x) for x in
                    _inputs(2, 64, 4, 2, 16, "pad"))
    _kernels.reset_launches()
    outs = [attention(q, k, v, seg, seg, impl=impl)
            for impl in ("auto", "kernel", "plain")]
    assert _kernels.launches["flash_fwd"] == 0
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        attention(q, k, v, seg, seg, impl="xla")


@pytest.mark.parametrize("kw", [{"alibi": True}, {"sliding_window": 16},
                                {"q_offset": 3}])
def test_unported_modes_raise(kw):
    q, k, v, seg = (torch.from_numpy(x) for x in
                    _inputs(1, 16, 2, 2, 16, "full"))
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, seg, seg, **kw)
