"""K1 in the port (halva_tpu_torch/ops/flash_attention.py) against the
reference's Pallas flash attention, which runs in interpret mode on the CPU
as tests/test_flash_attention.py runs it. On CPU tensors the port's wrapper
takes its plain version, so this holds the plain version's semantics:
segment ids (padding, packing), causal and not, GQA, lengths that are not a
block multiple, and the three modes: ALiBi (8 heads, and under GQA), a
sliding window smaller than the sequence (so it bites, and the reference,
run with 128-wide blocks, skips key blocks), window with GQA and packed
segments, ALiBi with a window, and `q_offset` (a shard of the queries
against all keys, held against the reference's shard and against the same
rows of the full call).

Tolerance: fp32, rtol = atol = 1e-5, on live query rows only. Fully masked
rows (segment id 0) are never read; there the reference gives the mean of V
and the CUDA kernel gives 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halva_tpu.ops.flash_attention import flash_attention as jax_flash
from halva_tpu_torch import _kernels
from halva_tpu_torch.ops.attention import (
    alibi_bias,
    attention,
    make_attention_mask,
)
from halva_tpu_torch.ops.flash_attention import flash_attention
from halva_tpu.ops.attention import alibi_bias as jax_alibi_bias
from halva_tpu.ops.attention import attention as jax_attention
from halva_tpu.ops.attention import make_attention_mask as jax_mask

torch.set_num_threads(2)

# name: (b, s, h, kvh, d, causal, segment layout)
CASES = {
    "causal": (2, 256, 4, 4, 32, True, "full"),
    "noncausal": (2, 256, 4, 4, 32, False, "full"),
    "padding": (2, 192, 2, 2, 32, True, "pad"),
    "packed": (1, 256, 2, 2, 32, True, "packed"),
    "gqa": (1, 128, 8, 2, 32, True, "pad"),
    "nonmultiple": (2, 200, 4, 2, 64, True, "pad"),
    "alibi": (2, 256, 8, 8, 32, True, "pad"),
    "alibi_gqa": (1, 200, 8, 2, 32, True, "pad"),
    "window": (2, 384, 2, 2, 32, True, "full"),
    "window_gqa_packed": (1, 384, 4, 2, 32, True, "packed"),
    "window_small": (1, 200, 2, 2, 32, True, "pad"),
    "alibi_window": (1, 384, 4, 4, 32, True, "pad"),
}
# the modes of a case (none: the base mode)
MODES = {
    "alibi": {"alibi": True},
    "alibi_gqa": {"alibi": True},
    "window": {"sliding_window": 100},
    "window_gqa_packed": {"sliding_window": 150},
    "window_small": {"sliding_window": 7},  # narrower than any tile
    "alibi_window": {"alibi": True, "sliding_window": 130},
}
# the reference's blocks: 128 wide where a window should skip some
BLOCKS = {name: {"block_q": 128, "block_k": 128} for name in MODES
          if "sliding_window" in MODES[name]}


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
        **MODES.get(name, {}), **BLOCKS.get(name, {}),
    ))
    t = [torch.from_numpy(x) for x in (q, k, v, seg)]
    got = flash_attention(t[0], t[1], t[2], t[3], t[3], causal=causal,
                          **MODES.get(name, {}))
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


@pytest.mark.parametrize("kw", [
    {"alibi": True},  # 6 heads: the kernels' slope formula needs a power of 2
    {"q_offset": torch.tensor(3)},  # a host int, not a tensor
    {"sliding_window": -4},
    {"alibi": True, "causal": False},  # see test_alibi_needs_causal
])
def test_unported_modes_raise(kw):
    q, k, v, seg = (torch.from_numpy(x) for x in
                    _inputs(1, 16, 6, 2, 16, "full"))
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v, seg, seg, **kw)


def test_alibi_needs_causal():
    """The kernels add the signed distance, the plain version -|row - col|:
    they agree only under the causal mask, so both devices refuse ALiBi
    without it (8 heads: the head count is not the reason)."""
    q, k, v, seg = (torch.from_numpy(x) for x in
                    _inputs(1, 16, 8, 2, 16, "full"))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, seg, seg, alibi=True, causal=False)
    flash_attention(q, k, v, seg, seg, alibi=True)


# name: (mode kwargs, the shard's first query row, its length)
Q_OFFSET_CASES = {
    "upper_half": ({}, 128, 128),
    "first_shard": ({}, 0, 64),
    "odd_offset": ({}, 67, 100),
    "window": ({"sliding_window": 90}, 128, 128),
    "alibi": ({"alibi": True}, 192, 64),
}


@pytest.mark.parametrize("name", list(Q_OFFSET_CASES))
def test_q_offset_equals_full_slice(name):
    """A query shard with q_offset against all keys (Sq != Skv) equals the
    same rows of the full call, and the reference's shard."""
    modes, off, n = Q_OFFSET_CASES[name]
    b, s, h, kvh, d = 2, 256, 4, 2, 32
    q, k, v, seg = _inputs(b, s, h, kvh, d, "pad")
    tq, tk, tv, tseg = (torch.from_numpy(x) for x in (q, k, v, seg))
    full = flash_attention(tq, tk, tv, tseg, tseg, **modes)
    got = flash_attention(tq[:, off:off + n], tk, tv, tseg[:, off:off + n],
                          tseg, q_offset=off, **modes)
    assert got.shape == (b, n, h, d)
    live = seg[:, off:off + n] != 0
    np.testing.assert_allclose(got.numpy()[live],
                               full[:, off:off + n].numpy()[live],
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_flash(
        jnp.asarray(q[:, off:off + n]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(seg[:, off:off + n]), jnp.asarray(seg),
        q_offset=jnp.int32(off), block_q=128, block_k=128, **modes))
    np.testing.assert_allclose(got.numpy()[live], want[live],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h", [8, 12])
def test_alibi_bias_and_mask_match_reference(h):
    """`alibi_bias` (12 heads: the non-power-of-two slope ladder) and the
    widened `make_attention_mask` against the reference's, value for
    value."""
    rng = np.random.RandomState(h)
    qpos = rng.randint(0, 300, (2, 9)).astype(np.int32)
    kpos = rng.randint(0, 300, (2, 14)).astype(np.int32)
    np.testing.assert_allclose(
        alibi_bias(h, torch.from_numpy(qpos), torch.from_numpy(kpos)).numpy(),
        np.asarray(jax_alibi_bias(h, jnp.asarray(qpos), jnp.asarray(kpos))),
        rtol=1e-6, atol=0)
    qseg = rng.randint(0, 3, (2, 9)).astype(np.int32)
    kseg = rng.randint(0, 3, (2, 14)).astype(np.int32)
    off = np.array([5, 0], np.int32)
    for causal in (True, False):
        for kw in ({}, {"sliding_window": 4}, {"q_offset": off},
                   {"q_offset": off, "sliding_window": 3}):
            tkw = {key: torch.from_numpy(val) if key == "q_offset" else val
                   for key, val in kw.items()}
            jkw = {key: jnp.asarray(val) if key == "q_offset" else val
                   for key, val in kw.items()}
            got = make_attention_mask(torch.from_numpy(qseg),
                                      torch.from_numpy(kseg), causal, **tkw)
            want = jax_mask(jnp.asarray(qseg), jnp.asarray(kseg), causal,
                            **jkw)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a host int offset is the same for every row
    got = make_attention_mask(torch.from_numpy(qseg), torch.from_numpy(kseg),
                              True, q_offset=5, sliding_window=4)
    want = jax_mask(jnp.asarray(qseg), jnp.asarray(kseg), True,
                    q_offset=jnp.full((2,), 5, jnp.int32), sliding_window=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h", [8, 12])
@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_attention_dispatch_alibi_window(h, impl):
    """`attention(alibi=, sliding_window=)` against the reference's XLA
    path. 12 heads: ALiBi takes the plain path with `alibi_bias` on either
    device (the flash wrapper itself refuses that head count)."""
    q, k, v, seg = _inputs(2, 96, h, 4, 16, "pad", seed=3)
    want = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(seg), impl="xla", alibi=True, sliding_window=40))
    t = [torch.from_numpy(x) for x in (q, k, v, seg)]
    got = attention(t[0], t[1], t[2], t[3], t[3], impl=impl, alibi=True,
                    sliding_window=40)
    live = seg != 0
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=1e-5,
                               atol=1e-5)
    if h == 12:
        with pytest.raises(ValueError, match="power-of-two"):
            flash_attention(t[0], t[1], t[2], t[3], t[3], alibi=True)
