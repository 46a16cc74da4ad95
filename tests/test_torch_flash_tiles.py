"""K1's tile loop on the CPU: `flash_attention_tiled_plain` (the model of
csrc/flash_fwd.cu's consumer warpgroups: 64 query rows walk their key tiles
in order, skip the tiles `flash_tile_kind` calls "skip", mask pairs only on
"masked" tiles, online softmax in the exp2 domain) against the reference's
Pallas forward `_flash_fwd_impl` in interpret mode, o and the LSE, in every
mode of tests/test_torch_flash_attention.py, with a q_offset, at ragged
lengths, Sq = 1, packed segments and fully masked rows, at key tiles of 64
and 128; and the tile rule itself against `make_attention_mask`.

Tolerance: fp32, rtol = atol = 1e-5 on live query rows (o and LSE): the two
sum the same products in other tile orders. A row with no live key is held
to K1's contract, o = 0 and LSE = M_INIT * ln 2 (the reference gives the
mean of V there; no caller reads such a row)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halva_tpu.ops.flash_attention import _flash_fwd_impl
from halva_tpu_torch.ops.attention import make_attention_mask
from halva_tpu_torch.ops.flash_attention import (
    FWD_BQ,
    FWD_LONG_KEYS,
    FWD_STAGES,
    FWD_STAGES_BY_D,
    M_INIT,
    flash_attention_plain,
    flash_attention_tiled_plain,
    flash_fwd_plan,
    flash_tile_kind,
)
from test_torch_flash_attention import CASES, MODES, Q_OFFSET_CASES, _inputs

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _reference(q, k, v, qseg, kvseg, causal=True, alibi=False,
               sliding_window=None, q_offset=None):
    """The Pallas forward in interpret mode: (o (B, Sq, H, D), lse (B, H,
    Sq)), 128-wide blocks."""
    h, d = q.shape[2], q.shape[3]
    off = jnp.reshape(jnp.int32(q_offset or 0), (1, 1))
    o, res = _flash_fwd_impl(
        jnp.asarray(q).transpose(0, 2, 1, 3),
        jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), jnp.asarray(qseg),
        jnp.asarray(kvseg), off, causal, float(d**-0.5), 128, 128,
        h if alibi else 0, int(sliding_window or 0))
    return np.asarray(o).transpose(0, 2, 1, 3), np.asarray(res[7])


def _tiled(q, k, v, qseg, kvseg, bk, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in
         (q, k, v, qseg, kvseg)]
    o, lse = flash_attention_tiled_plain(*t, bk=bk, **kw)
    return o.numpy(), lse.numpy()


def _live_rows(qseg, kvseg, causal, q_offset=None, sliding_window=None):
    mask = make_attention_mask(torch.from_numpy(qseg),
                               torch.from_numpy(kvseg), causal,
                               q_offset=q_offset,
                               sliding_window=sliding_window)
    return mask[:, 0].any(-1).numpy()  # (B, Sq): a row with a live key


def _check(q, k, v, qseg, kvseg, bk, causal=True, **modes):
    want_o, want_lse = _reference(q, k, v, qseg, kvseg, causal, **modes)
    got_o, got_lse = _tiled(q, k, v, qseg, kvseg, bk, causal=causal, **modes)
    assert got_o.shape == want_o.shape and got_o.dtype == np.float32
    live = _live_rows(qseg, kvseg, causal, modes.get("q_offset"),
                      modes.get("sliding_window"))
    np.testing.assert_allclose(got_o[live], want_o[live], **TOL)
    np.testing.assert_allclose(got_lse.transpose(0, 2, 1)[live],
                               want_lse.transpose(0, 2, 1)[live], **TOL)
    dead = ~live
    assert (got_o[dead] == 0).all()
    np.testing.assert_allclose(got_lse.transpose(0, 2, 1)[dead],
                               M_INIT * math.log(2), rtol=1e-6)
    return live


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("name", list(CASES))
def test_tiled_plain_matches_pallas_in_every_mode(name, bk):
    b, s, h, kvh, d, causal, layout = CASES[name]
    q, k, v, seg = _inputs(b, s, h, kvh, d, layout)
    _check(q, k, v, seg, seg, bk, causal, **MODES.get(name, {}))


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("name", list(Q_OFFSET_CASES))
def test_tiled_plain_q_offset_matches_pallas(name, bk):
    """A shard of the queries against all keys (Sq != Skv)."""
    modes, off, n = Q_OFFSET_CASES[name]
    q, k, v, seg = _inputs(2, 256, 4, 2, 32, "pad")
    _check(q[:, off:off + n], k, v, seg[:, off:off + n], seg, bk,
           q_offset=off, **modes)


def _ragged(b, sq, skv, h, kvh, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, skv, kvh, d).astype(np.float32)
    v = rng.randn(b, skv, kvh, d).astype(np.float32)
    return q, k, v


# name: (b, sq, skv, h, kvh, causal, modes); the queries are the last sq
# positions of skv (q_offset = skv - sq) unless sq == skv
RAGGED = {
    "ragged_both": (2, 150, 150, 4, 2, True, {}),
    "ragged_noncausal": (1, 77, 201, 2, 2, False, {}),
    "ragged_shard": (2, 70, 333, 4, 4, True, {}),
    "ragged_window": (1, 190, 190, 2, 1, True, {"sliding_window": 45}),
    "ragged_alibi": (1, 131, 131, 4, 4, True, {"alibi": True}),
    "sq1": (2, 1, 200, 4, 2, True, {}),
    "sq1_noncausal": (1, 1, 129, 2, 2, False, {}),
    "sq1_window": (1, 1, 300, 2, 2, True, {"sliding_window": 70}),
}


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("name", list(RAGGED))
def test_tiled_plain_ragged_lengths(name, bk):
    """Sq and Skv no multiple of any tile; Sq = 1 (a query at the last key
    position), with padding in the second batch row."""
    b, sq, skv, h, kvh, causal, modes = RAGGED[name]
    q, k, v = _ragged(b, sq, skv, h, kvh, 32, seed=len(name))
    kvseg = np.ones((b, skv), np.int32)
    kvseg[-1, skv - 9:] = 0
    off = skv - sq
    qseg = kvseg[:, off:].copy()
    _check(q, k, v, qseg, kvseg, bk, causal,
           q_offset=off if off else None, **modes)


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_tiled_plain_packed_segments_and_masked_rows(bk, causal):
    """Three documents packed into a row, padding between and after them,
    and a batch row that is padding throughout: its o is 0 and its LSE
    M_INIT * ln 2."""
    b, s, h, kvh, d = 3, 260, 4, 2, 32
    q, k, v = _ragged(b, s, s, h, kvh, d, seed=7)
    seg = np.zeros((b, s), np.int32)
    seg[0, :70] = 1
    seg[0, 70:75] = 0
    seg[0, 75:200] = 2
    seg[0, 200:251] = 3
    seg[1, :131] = 5
    # row 2 is padding throughout
    live = _check(q, k, v, seg, seg, bk, causal)
    assert not live[2].any() and live[0, :70].all() and not live[0, 70:75].any()


def _kinds(qseg, kvseg, bq, bk, causal, q_offset, window):
    """(b, r0, c0, kind, mask block) for every query tile and key tile."""
    mask = make_attention_mask(torch.from_numpy(qseg), torch.from_numpy(kvseg),
                               causal, q_offset=q_offset,
                               sliding_window=window or None)[:, 0].numpy()
    b, sq = qseg.shape
    skv = kvseg.shape[1]
    off = q_offset or 0
    for bi in range(b):
        for r0 in range(0, sq, bq):
            r1 = min(r0 + bq, sq)
            qs = qseg[bi, r0:r1]
            for c0 in range(0, skv, bk):
                ks = kvseg[bi, c0:min(c0 + bk, skv)]
                kind = flash_tile_kind(c0, bk, skv, int(ks.min()),
                                       int(ks.max()), int(qs.min()),
                                       int(qs.max()), off + r0, off + r1 - 1,
                                       causal, window)
                yield bi, r0, c0, kind, mask[bi, r0:r1, c0:c0 + bk]


# name: (sq, skv, causal, q_offset, window, segment layout)
RULE_CASES = {
    "causal_pad": (300, 300, True, None, 0, "pad"),
    "noncausal_packed": (300, 300, False, None, 0, "packed"),
    "window": (400, 400, True, None, 100, "pad"),
    "window_narrow": (260, 260, True, None, 7, "packed"),
    "shard": (90, 333, True, 200, 0, "packed"),
    "shard_window": (128, 512, True, 384, 150, "pad"),
    "sq1": (1, 257, True, 256, 0, "pad"),
    "ids_not_monotone": (200, 200, False, None, 0, "interleaved"),
}


def _rule_segs(sq, skv, layout, q_offset):
    rng = np.random.RandomState(sq + skv)
    seg = np.ones((2, skv), np.int32)
    if layout == "pad":
        seg[1, skv - 61:] = 0
    elif layout == "packed":
        seg[0, skv // 3:] = 2
        seg[0, 2 * skv // 3:] = 3
        seg[1, skv // 2:] = 0
    else:  # ids that go up and down: only the ranges, not the order, count
        seg = rng.randint(0, 4, size=(2, skv)).astype(np.int32)
    off = q_offset or 0
    return seg[:, off:off + sq].copy(), seg


@pytest.mark.parametrize("bq,bk", [(64, 64), (64, 128), (128, 64),
                                   (128, 128)])
@pytest.mark.parametrize("name", list(RULE_CASES))
def test_tile_rule_against_the_mask(name, bq, bk):
    """No live pair lies in a tile the rule skips, and every tile it calls
    full is live throughout (it then runs no per-pair mask)."""
    sq, skv, causal, off, window, layout = RULE_CASES[name]
    qseg, kvseg = _rule_segs(sq, skv, layout, off)
    seen = set()
    for bi, r0, c0, kind, block in _kinds(qseg, kvseg, bq, bk, causal, off,
                                          window):
        seen.add(kind)
        if kind == "skip":
            assert not block.any(), (bi, r0, c0)
        elif kind == "full":
            assert block.all() and block.shape[1] == bk, (bi, r0, c0)
    assert "masked" in seen


def test_tile_rule_reaches_every_kind():
    """On the llava prefill's padded causal rows the rule skips tiles above
    the diagonal and past the padding, and runs most tiles below the
    diagonal unmasked."""
    lens = (623, 615, 608, 623)
    seg = np.zeros((4, 623), np.int32)
    for i, n in enumerate(lens):
        seg[i, :n] = 1
    kinds = [kind for *_, kind, _ in _kinds(seg, seg, 64, 128, True, None, 0)]
    assert set(kinds) == {"skip", "masked", "full"}
    assert kinds.count("full") > kinds.count("masked") // 2


@pytest.mark.parametrize("bk", sorted(FWD_STAGES))
def test_tiled_plain_matches_plain_at_the_prefill_shape_cut_down(bk):
    """bf16 inputs as the card's: the tiled loop against the whole-row plain
    version on a 4-head cut of the llava prefill (padded rows of 623, 615
    tokens, D = 128), within the bf16 bound the card's kernels are held
    to."""
    b, s, h, d = 2, 623, 4, 128
    q, k, v = (torch.from_numpy(x).bfloat16() for x in
               _ragged(b, s, s, h, h, d, seed=3))
    seg = torch.zeros(b, s, dtype=torch.int32)
    seg[0], seg[1, :615] = 1, 1
    got, lse = flash_attention_tiled_plain(q, k, v, seg, seg, bk=bk)
    want = flash_attention_plain(q, k, v, seg, seg)
    live = seg != 0
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=1e-2, atol=1e-2)
    assert lse.shape == (b, h, s) and torch.isfinite(lse).all()


def test_flash_fwd_plan():
    """A block per 128 query rows of each (batch row, head); key tiles of 64
    (a ring of 4 stages) up to FWD_LONG_KEYS keys, of 128 (2 stages) above;
    a forced tile of another size raises."""
    assert FWD_BQ == 128
    assert flash_fwd_plan(4, 623, 623, 32) == (128, 64, 4, 4 * 32 * 5)
    assert flash_fwd_plan(4, 1087, 1087, 32).bk == 64
    assert flash_fwd_plan(1, 4608, 4608, 32) == (128, 128, 2, 32 * 36)
    assert flash_fwd_plan(1, 4608, 4608, 32, bk=64).stages == 4
    assert flash_fwd_plan(2, 1, 4608, 8) == (128, 128, 2, 16)
    assert flash_fwd_plan(1, 100, FWD_LONG_KEYS, 8).bk == 64
    assert flash_fwd_plan(1, 100, FWD_LONG_KEYS + 1, 8).bk == 128
    with pytest.raises(ValueError, match="key tile"):
        flash_fwd_plan(1, 128, 128, 8, bk=96)


def test_flash_fwd_plan_at_head_dim_256():
    """At head dim 256 (Gemma) K1 has one instance: 64-key tiles in a ring
    of 2 stages (a 64 KB Q tile and two 64 KB stages), long rows included;
    a 128-key tile and a head dim without an instance raise."""
    assert FWD_STAGES_BY_D[128] is FWD_STAGES
    assert flash_fwd_plan(4, 623, 623, 8, d=256) == (128, 64, 2, 4 * 8 * 5)
    assert flash_fwd_plan(1, 4608, 4608, 8, d=256).bk == 64
    with pytest.raises(ValueError, match="key tile"):
        flash_fwd_plan(1, 128, 128, 8, bk=128, d=256)
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd_plan(1, 128, 128, 8, d=64)
