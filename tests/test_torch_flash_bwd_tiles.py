"""K2's and K3's tile loops on the CPU: `flash_attention_bwd_tiled_plain`
(the model of csrc/flash_bwd.cu: K2's warpgroups of 64 query rows walk the
key tiles of their block, K3's blocks of 128 or 64 keys walk the query
tiles that can see them for each query head of the group, both skipping
the tiles `flash_tile_kind` calls "skip" and masking pairs only on
"masked" ones, P in the exp2 domain, P and dS rounded where the kernels
round them) against the reference's Pallas backward, run in interpret mode
through `jax.vjp` of its flash_attention as
tests/test_torch_flash_backward.py runs it: in every mode of
tests/test_torch_flash_attention.py, with a q_offset, at ragged lengths,
with packed segments and fully masked rows, under each of K3's layouts
that `flash_bwd_plan` can choose; and the plan itself.

The forward's o and LSE come from `flash_attention_tiled_plain` (K1's
model: a dead row has o = 0 and LSE = M_INIT * ln 2, whose exp overflows
and must be selected away). The cotangent is zero on dead rows, as in
test_torch_flash_backward.py. Tolerance: fp32, rtol = atol = 1e-4 on live
query rows (dq) and live keys (dk, dv), as test_torch_flash_backward.py
states it: fp32 sums of up to 256 terms taken in other orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.ops.flash_attention import flash_attention as jax_flash
from halva_tpu_torch.ops.flash_attention import (
    BWD_DKV_KEYS,
    BWD_DKV_MIN_BLOCKS_PER_SM,
    BWD_DQ_ROWS,
    BWD_STAGES,
    BWD_TILE,
    flash_attention_bwd_plain,
    flash_attention_bwd_tiled_plain,
    flash_attention_tiled_plain,
    flash_bwd_plan,
)
from test_torch_flash_attention import CASES, MODES, Q_OFFSET_CASES, _inputs
from test_torch_flash_tiles import RAGGED, _ragged

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _cotangent(qseg, h, d, seed):
    b, sq = qseg.shape
    do = np.random.RandomState(seed).randn(b, sq, h, d).astype(np.float32)
    do[qseg == 0] = 0
    return do


_PALLAS = {}  # the reference's grads by case, shared by K3's layouts


def _pallas_grads(q, k, v, qseg, kvseg, do, causal, q_offset=None, **modes):
    """jax.vjp of the reference's Pallas flash attention in interpret mode,
    128-wide blocks (a window then skips some)."""
    key = (q.tobytes(), k.shape, qseg.tobytes(), kvseg.tobytes(),
           do.tobytes(), causal, q_offset, tuple(sorted(modes.items())))
    if key not in _PALLAS:
        _PALLAS[key] = _pallas_vjp(q, k, v, qseg, kvseg, do, causal,
                                   q_offset, **modes)
    return _PALLAS[key]


def _pallas_vjp(q, k, v, qseg, kvseg, do, causal, q_offset, **modes):
    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, jnp.asarray(qseg), jnp.asarray(kvseg),
                         causal=causal, block_q=128, block_k=128,
                         q_offset=None if q_offset is None
                         else jnp.int32(q_offset), **modes)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _tiled_grads(q, k, v, qseg, kvseg, do, keys, causal, **modes):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in
         (q, k, v, qseg, kvseg, do)]
    o, lse = flash_attention_tiled_plain(*t[:5], causal=causal, **modes)
    got = flash_attention_bwd_tiled_plain(*t[:5], o, lse, t[5],
                                          causal=causal, dkv_keys=keys,
                                          **modes)
    return [g.numpy() for g in got]


def _check(q, k, v, qseg, kvseg, keys, causal=True, seed=1, **modes):
    h, d = q.shape[2], q.shape[3]
    do = _cotangent(qseg, h, d, seed)
    want = _pallas_grads(q, k, v, qseg, kvseg, do, causal, **modes)
    got = _tiled_grads(q, k, v, qseg, kvseg, do, keys, causal, **modes)
    for name, g, w, t, live in zip(("dq", "dk", "dv"), got, want, (q, k, v),
                                   (qseg != 0, kvseg != 0, kvseg != 0)):
        assert g.shape == t.shape and g.dtype == np.float32
        np.testing.assert_allclose(g[live], w[live], err_msg=name, **TOL)
    return got


@pytest.mark.parametrize("keys", BWD_DKV_KEYS)
@pytest.mark.parametrize("name", list(CASES))
def test_bwd_tiled_plain_matches_pallas_in_every_mode(name, keys):
    b, s, h, kvh, d, causal, layout = CASES[name]
    q, k, v, seg = _inputs(b, s, h, kvh, d, layout)
    _check(q, k, v, seg, seg, keys, causal, **MODES.get(name, {}))


@pytest.mark.parametrize("keys", BWD_DKV_KEYS)
@pytest.mark.parametrize("name", list(Q_OFFSET_CASES))
def test_bwd_tiled_plain_q_offset_matches_pallas(name, keys):
    """A shard of the queries against all keys (Sq != Skv): K3's walk starts
    at the first query tile that can see its keys, shifted by q_offset."""
    modes, off, n = Q_OFFSET_CASES[name]
    q, k, v, seg = _inputs(2, 256, 4, 2, 32, "pad")
    _check(q[:, off:off + n], k, v, seg[:, off:off + n], seg, keys,
           q_offset=off, seed=4, **modes)


@pytest.mark.parametrize("keys", BWD_DKV_KEYS)
@pytest.mark.parametrize("name", list(RAGGED))
def test_bwd_tiled_plain_ragged_lengths(name, keys):
    """Sq and Skv no multiple of any tile; Sq = 1 (a query at the last key
    position), with padding in the second batch row."""
    b, sq, skv, h, kvh, causal, modes = RAGGED[name]
    q, k, v = _ragged(b, sq, skv, h, kvh, 32, seed=len(name))
    kvseg = np.ones((b, skv), np.int32)
    kvseg[-1, skv - 9:] = 0
    off = skv - sq
    qseg = kvseg[:, off:].copy()
    _check(q, k, v, qseg, kvseg, keys, causal,
           q_offset=off if off else None, **modes)


@pytest.mark.parametrize("keys", BWD_DKV_KEYS)
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_tiled_plain_packed_segments_and_masked_rows(keys, causal):
    """Three documents packed into a row, padding between and after them,
    and a batch row that is padding throughout: its rows' LSE is M_INIT *
    ln 2, and its grads (and every dead key's) come out 0 and finite."""
    b, s, h, kvh, d = 3, 260, 4, 2, 32
    q, k, v = _ragged(b, s, s, h, kvh, d, seed=7)
    seg = np.zeros((b, s), np.int32)
    seg[0, :70] = 1
    seg[0, 75:200] = 2
    seg[0, 200:251] = 3
    seg[1, :131] = 5
    dq, dk, dv = _check(q, k, v, seg, seg, keys, causal, seed=5)
    dead = seg == 0
    for g in (dq, dk, dv):
        assert np.isfinite(g).all() and not g[dead].any()


@pytest.mark.parametrize("keys", BWD_DKV_KEYS)
def test_bwd_tiled_plain_matches_plain_at_the_train_shape_cut_down(keys):
    """bf16 inputs as the card's: the tile walks against the whole-row plain
    backward on a 4-head cut of the llava train shape (padded rows of 1087
    and 786 tokens, D = 128, G = 2), within the bounds the card's kernels
    are held to (chip_smoke.py's BWD_RTOL and BWD_REL)."""
    b, s, h, kvh, d = 2, 1087, 4, 2, 128
    q, k, v = (torch.from_numpy(x).bfloat16() for x in
               _ragged(b, s, s, h, kvh, d, seed=3))
    seg = torch.zeros(b, s, dtype=torch.int32)
    seg[0], seg[1, :786] = 1, 1
    do = torch.from_numpy(_cotangent(seg.numpy(), h, d, seed=6)).bfloat16()
    o, lse = flash_attention_tiled_plain(q, k, v, seg, seg)
    got = flash_attention_bwd_tiled_plain(q, k, v, seg, seg, o, lse, do,
                                          dkv_keys=keys)
    want = flash_attention_bwd_plain(q, k, v, seg, seg, o, lse, do)
    live = seg != 0
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g[live].float(), w[live].float()
        assert ((g - w).abs() <= 2e-2 * (w.abs().max() + w.abs())).all()
        assert float((g - w).norm() / w.norm()) <= 2e-3


def test_flash_bwd_plan_at_the_train_shapes():
    """K2: a block per 128 query rows of each (batch row, head), key tiles
    of 64 through 4 stages, last query tile first. K3: 128 keys a block at
    the llava train shapes and on the 4,608-token Mistral row (G = 4); 64
    where 128 would leave fewer than BWD_DKV_MIN_BLOCKS_PER_SM blocks an SM
    (Mistral's B=2 train rows, G = 4)."""
    assert (BWD_DQ_ROWS, BWD_TILE, BWD_STAGES) == (128, 64, 4)
    plan = flash_bwd_plan(4, 1087, 1087, 32, 32)
    assert plan.dq == (128, 64, 4, 4 * 32 * 9, "last query tile first")
    assert plan.dkv == (128, 64, 4, 4 * 32 * 9, "first key tile first")
    assert flash_bwd_plan(2, 1087, 1087, 32, 32).dkv.rows == 128
    long_row = flash_bwd_plan(1, 4608, 4608, 32, 8)
    assert long_row.dq.blocks == 32 * 36
    assert long_row.dkv == (128, 64, 4, 8 * 36, "first key tile first")
    assert flash_bwd_plan(4, 1087, 1087, 32, 8).dkv.rows == 128
    mistral = flash_bwd_plan(2, 1087, 1087, 32, 8)
    assert mistral.dkv == (64, 64, 4, 2 * 8 * 17, "first key tile first")
    assert 2 * 8 * 9 < BWD_DKV_MIN_BLOCKS_PER_SM * 132 <= 8 * 36


@pytest.mark.parametrize("b,skv,kvh,sms", [
    (4, 1087, 32, 132), (2, 1087, 8, 132), (1, 4608, 8, 132),
    (1, 4608, 8, 16), (8, 64, 1, 132), (1, 1, 1, 132)])
def test_flash_bwd_plan_rule(b, skv, kvh, sms):
    """The plan takes 128 keys a block exactly when that gives at least
    BWD_DKV_MIN_BLOCKS_PER_SM blocks an SM; its block counts cover every
    key and every query row; a forced layout is kept, another refused."""
    plan = flash_bwd_plan(b, skv, skv, kvh * 4, kvh, sms=sms)
    wide = b * kvh * -(-skv // 128)
    assert plan.dkv.rows == (128 if wide >= BWD_DKV_MIN_BLOCKS_PER_SM * sms
                             else 64)
    assert plan.dkv.blocks * plan.dkv.rows >= b * kvh * skv
    assert plan.dq.blocks * plan.dq.rows >= b * kvh * 4 * skv
    for keys in BWD_DKV_KEYS:
        assert flash_bwd_plan(b, skv, skv, kvh, kvh, dkv_keys=keys,
                              sms=sms).dkv.rows == keys
    with pytest.raises(ValueError, match="keys a block"):
        flash_bwd_plan(b, skv, skv, kvh, kvh, dkv_keys=96)
