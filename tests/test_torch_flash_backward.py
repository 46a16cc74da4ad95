"""The flash-attention backward in the port (halva_tpu_torch/ops/
flash_attention.py) against the reference's Pallas backward, run in
interpret mode on the CPU through `jax.vjp` of its flash_attention, as
tests/test_flash_attention.py runs it: `flash_attention_bwd_plain` (the
plain version K2 and K3 are held against on the card) and autograd through
the port's `flash_attention` (its plain path on CPU tensors).

Inputs: fp32, the `CASES` of test_torch_flash_attention.py (causal,
non-causal, padding, packed, GQA, a length that is no block multiple, and
the ALiBi and sliding-window modes, the reference run with 128-wide blocks
where a window should skip some), and `q_offset` (a shard of the queries
against all keys: the grads of the shard equal those of the same rows of
the full call). The
cotangent is zero on dead rows (segment id 0): in the model their outputs
never reach a loss, and the two forwards give them different values (the
mean of V against 0). Tolerance: rtol = atol = 1e-4 on live rows (dq) and
live keys (dk, dv): fp32 sums of up to 256 terms taken in other orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.ops.flash_attention import flash_attention as jax_flash
from halva_tpu_torch import _kernels
from halva_tpu_torch.ops.flash_attention import (
    _mask_and_bias,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

from test_torch_flash_attention import (
    BLOCKS,
    CASES,
    MODES,
    Q_OFFSET_CASES,
    _inputs,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _cotangent(b, s, h, d, seg, seed=1):
    do = np.random.RandomState(seed).randn(b, s, h, d).astype(np.float32)
    do[seg == 0] = 0
    return do


def _jax_grads(q, k, v, seg, do, causal, **kw):
    def f(q, k, v):
        return jax_flash(q, k, v, jnp.asarray(seg), jnp.asarray(seg),
                         causal=causal, **kw)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _lse(q, k, seg, causal, alibi=False, sliding_window=None, q_offset=None,
         q_seg=None):
    """The natural-log LSE of the masked (and biased) logits, (B, H, Sq)."""
    h, kvh, d = q.shape[2], k.shape[2], q.shape[3]
    kr = k.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kr) * d**-0.5
    mask, bias = _mask_and_bias(q, k, seg if q_seg is None else q_seg, seg,
                                causal, alibi, sliding_window, q_offset)
    if bias is not None:
        logits = logits + bias
    return logits.masked_fill(~mask, -1e30).logsumexp(-1)


def _assert_grads(got, want, seg):
    live = seg != 0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g[live], w[live], err_msg=name, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_plain_matches_pallas_interpret(name):
    b, s, h, kvh, d, causal, layout = CASES[name]
    q, k, v, seg = _inputs(b, s, h, kvh, d, layout)
    do = _cotangent(b, s, h, d, seg)
    modes = MODES.get(name, {})
    want = _jax_grads(q, k, v, seg, do, causal, **modes,
                      **BLOCKS.get(name, {}))
    tq, tk, tv, tseg, tdo = (torch.from_numpy(x) for x in (q, k, v, seg, do))
    o = flash_attention_plain(tq, tk, tv, tseg, tseg, causal=causal, **modes)
    lse = _lse(tq, tk, tseg, causal, **modes)
    got = flash_attention_bwd_plain(tq, tk, tv, tseg, tseg, o, lse, tdo,
                                    causal=causal, **modes)
    for g, t in zip(got, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == torch.float32
    _assert_grads([g.numpy() for g in got], want, seg)


@pytest.mark.parametrize("name", list(CASES))
def test_autograd_matches_pallas_interpret(name):
    b, s, h, kvh, d, causal, layout = CASES[name]
    q, k, v, seg = _inputs(b, s, h, kvh, d, layout)
    do = _cotangent(b, s, h, d, seg, seed=2)
    modes = MODES.get(name, {})
    want = _jax_grads(q, k, v, seg, do, causal, **modes,
                      **BLOCKS.get(name, {}))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tseg = torch.from_numpy(seg)
    _kernels.reset_launches()
    out = flash_attention(*leaves, tseg, tseg, causal=causal, **modes)
    out.backward(torch.from_numpy(do))
    assert sum(_kernels.launches.values()) == 0  # CPU: the plain path
    _assert_grads([t.grad.numpy() for t in leaves], want, seg)


@pytest.mark.parametrize("name", list(Q_OFFSET_CASES))
def test_q_offset_grads(name):
    """The grads of a query shard with q_offset (Sq != Skv): plain backward
    and CPU autograd against the reference's Pallas backward of the same
    shard, and against the grads of the same rows of the full call."""
    modes, off, n = Q_OFFSET_CASES[name]
    b, s, h, kvh, d = 2, 256, 4, 2, 32
    q, k, v, seg = _inputs(b, s, h, kvh, d, "pad")
    qs, segs = q[:, off:off + n], seg[:, off:off + n]
    do = _cotangent(b, n, h, d, segs, seed=4)

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, jnp.asarray(segs), jnp.asarray(seg),
                         q_offset=jnp.int32(off), block_q=128, block_k=128,
                         **modes)

    _, vjp = jax.vjp(f, jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv, tseg, tsegs, tdo = (torch.from_numpy(np.ascontiguousarray(x))
                                    for x in (qs, k, v, seg, segs, do))
    o = flash_attention_plain(tq, tk, tv, tsegs, tseg, q_offset=off, **modes)
    lse = _lse(tq, tk, tseg, True, q_offset=off, q_seg=tsegs, **modes)
    plain = flash_attention_bwd_plain(tq, tk, tv, tsegs, tseg, o, lse, tdo,
                                      q_offset=off, **modes)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    flash_attention(*leaves, tsegs, tseg, q_offset=off, **modes).backward(tdo)
    # the full call, its cotangent zero outside the shard's rows
    full = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    do_full = torch.zeros(b, s, h, d)
    do_full[:, off:off + n] = tdo
    flash_attention(*full, tseg, tseg, **modes).backward(do_full)
    want_full = [full[0].grad[:, off:off + n], full[1].grad, full[2].grad]
    for got in ([g.numpy() for g in plain], [t.grad.numpy() for t in leaves]):
        for name_, g, w, wf, live in zip(
                ("dq", "dk", "dv"), got, want, want_full,
                (segs != 0, seg != 0, seg != 0)):
            np.testing.assert_allclose(g[live], w[live], err_msg=name_, **TOL)
            np.testing.assert_allclose(g[live], wf.numpy()[live],
                                       err_msg=name_, **TOL)


def test_bwd_plain_selects_masked_rows():
    """A dead row's LSE as K1 writes it (-1e29 ln 2) overflows exp(S - LSE);
    the plain backward selects P = 0 there instead of multiplying inf by 0,
    so its grads stay finite and its dead row contributes nothing."""
    b, s, h, kvh, d = 1, 64, 2, 2, 16
    q, k, v, seg = (torch.from_numpy(x) for x in
                    _inputs(b, s, h, kvh, d, "full"))
    seg[:, 40:] = 0
    o = flash_attention_plain(q, k, v, seg, seg)
    o[seg == 0] = 0  # K1's dead rows
    lse = _lse(q, k, seg, True)
    lse[(seg == 0)[:, None, :].expand_as(lse)] = -1e29 * np.log(2)
    do = torch.randn(b, s, h, d, generator=torch.Generator().manual_seed(3))
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, seg, seg, o, lse, do)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert not dq[seg == 0].any()
    assert not dk[seg == 0].any() and not dv[seg == 0].any()


def test_bwd_plain_rounds_ds_and_p_to_the_input_dtype():
    """bf16 inputs: dS and P are rounded to bf16 before their products, as
    the Pallas kernels round them; the grads come back in the inputs'
    dtypes and stay within bf16 rounding of the fp32 backward."""
    b, s, h, kvh, d, causal, layout = CASES["gqa"]
    q, k, v, seg = (torch.from_numpy(x) for x in
                    _inputs(b, s, h, kvh, d, layout))
    do = torch.from_numpy(_cotangent(b, s, h, d, seg.numpy()))
    lse = _lse(q, k, seg, causal)
    o = flash_attention_plain(q, k, v, seg, seg, causal=causal)
    ref = flash_attention_bwd_plain(q, k, v, seg, seg, o, lse, do)
    bf = [t.bfloat16() for t in (q, k, v)]
    lse_bf = _lse(*(t.float() for t in bf[:2]), seg, causal)
    got = flash_attention_bwd_plain(*bf, seg, seg, o.bfloat16(), lse_bf,
                                    do.bfloat16())
    live = seg != 0
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        err = (g[live].float() - r[live]).norm() / r[live].norm()
        assert float(err) < 2e-2


def test_bwd_wrapper_refuses_cpu_tensors():
    """flash_attention_bwd launches K2 and K3 or raises: CPU tensors take
    the plain backward only through flash_attention's autograd."""
    q, k, v, seg = (torch.from_numpy(x) for x in
                    _inputs(1, 16, 2, 2, 128, "full"))
    lse = torch.zeros(1, 2, 16)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), seg,
                            seg, q.bfloat16(), lse, q.bfloat16())
    assert sum(_kernels.launches.values()) == 0
