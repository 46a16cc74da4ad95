"""The DPA loss in the port (halva_tpu_torch/train/dpa.py) against the
reference's halva_tpu/train/dpa.py on the same numpy inputs: every loss
function on full logits, the chunked variants from hidden states (with a
chunk that does not divide the sequence), and the grads of the loss with
respect to logits and hidden states against `jax.grad`.

Tolerances (fp32): values rtol = 1e-5, atol = 1e-6; grads rtol = 1e-4,
atol = 1e-6 (log_softmax over 32 classes and sums of up to 40 terms, in
other orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.constants import IGNORE_INDEX
from halva_tpu.train import dpa as jdpa
from halva_tpu_torch.train import dpa

torch.set_num_threads(2)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
B, S, V, D = 2, 21, 32, 8


def _labels_signs(rng, k_phrases=3):
    lab = rng.randint(0, V, (B, S)).astype(np.int32)
    lab[:, : S // 2] = IGNORE_INDEX
    sg = np.zeros((B, S), np.int32)
    for k in range(1, k_phrases + 1):
        st = S // 2 + (k - 1) * 3
        sg[:, st: st + 2] = k
    sg[1][sg[1] == 3] = 0  # a row lacking a present phrase adds log(2)
    return lab, sg


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    logits = {k: rng.randn(B, S, V).astype(np.float32)
              for k in ("pos", "neg", "pref", "fref")}
    hidden = {k: rng.randn(B, S, D).astype(np.float32)
              for k in ("pos", "neg", "pref", "fref")}
    pl, ps = _labels_signs(rng)
    nl, ns = _labels_signs(rng)
    rl, _ = _labels_signs(rng)
    w = (rng.randn(D, V) * 0.5).astype(np.float32)
    return logits, hidden, (pl, nl, ps, ns), rl, w


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_per_token_logps_and_phrases():
    logits, _, (pl, _, ps, _), _, _ = _batch()
    want = jdpa.per_token_logps(_j(logits["pos"]), _j(pl))
    got = dpa.per_token_logps(_t(logits["pos"]), _t(pl))
    assert got.shape == (B, S - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    want_acc = jdpa.accumulate_phrase_logps(want, _j(ps[:, 1:]))
    got_acc = dpa.accumulate_phrase_logps(got, _t(ps[:, 1:]))
    assert got_acc.shape == (B, dpa.MAX_PHRASES)
    np.testing.assert_allclose(got_acc.numpy(), np.asarray(want_acc), **VAL)


def test_alignment_and_kl_match_reference():
    logits, _, (pl, nl, ps, ns), rl, _ = _batch(1)
    jl = {k: _j(v) for k, v in logits.items()}
    tl = {k: _t(v) for k, v in logits.items()}
    pos_lp = jdpa.per_token_logps(jl["pos"], _j(pl))
    neg_lp = jdpa.per_token_logps(jl["neg"], _j(nl))
    want = jdpa.alignment_loss(pos_lp, neg_lp, _j(pl[:, 1:]), _j(nl[:, 1:]),
                               _j(ps[:, 1:]), _j(ns[:, 1:]))
    got = dpa.alignment_loss(
        dpa.per_token_logps(tl["pos"], _t(pl)),
        dpa.per_token_logps(tl["neg"], _t(nl)), _t(pl[:, 1:]),
        _t(nl[:, 1:]), _t(ps[:, 1:]), _t(ns[:, 1:]))
    np.testing.assert_allclose(float(got), float(want), **VAL)
    want_kl = jdpa.kl_divergence(jl["pref"], jl["fref"], _j(rl))
    got_kl = dpa.kl_divergence(tl["pref"], tl["fref"], _t(rl))
    np.testing.assert_allclose(float(got_kl), float(want_kl), **VAL)


@pytest.mark.parametrize("alpha", [0.0, 0.4])
def test_dpa_loss_and_logit_grads_match_reference(alpha):
    logits, _, labs, rl, _ = _batch(2)

    def jloss(lg):
        return jdpa.dpa_loss(lg["pos"], lg["neg"], *map(_j, labs),
                             lg["pref"], lg["fref"], _j(rl), alpha=alpha)

    jl = {k: _j(v) for k, v in logits.items()}
    want = jloss(jl)
    want_g = jax.grad(lambda lg: jloss(lg).total)(jl)
    tl = {k: _t(v).requires_grad_(True) for k, v in logits.items()}
    got = dpa.dpa_loss(tl["pos"], tl["neg"], *map(_t, labs), tl["pref"],
                       tl["fref"], _t(rl), alpha=alpha)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), **VAL)
    got.total.backward()
    for k in ("pos", "neg", "pref"):
        np.testing.assert_allclose(tl[k].grad.numpy(), np.asarray(want_g[k]),
                                   err_msg=k, **GRAD)
    # no gradient reaches the frozen model's logits
    assert tl["fref"].grad is None or not tl["fref"].grad.any()


@pytest.mark.parametrize("chunk", [4, 8, 64])
def test_chunked_loss_and_hidden_grads_match_reference(chunk):
    """dpa_loss_from_hidden with a chunk that does not divide S - 1 = 20
    (4 does), against the reference's scan; the loss and its grads w.r.t.
    the hidden states."""
    _, hidden, labs, rl, w = _batch(3)

    def jloss(hs):
        def logits_fn(h):
            return jnp.dot(h, _j(w)).astype(jnp.float32)

        return jdpa.dpa_loss_from_hidden(
            logits_fn, hs["pos"], hs["neg"], *map(_j, labs), hs["pref"],
            hs["fref"], _j(rl), alpha=0.4, chunk=chunk)

    jh = {k: _j(v) for k, v in hidden.items()}
    want = jloss(jh)
    want_g = jax.grad(lambda hs: jloss(hs).total)(jh)

    wt = _t(w)
    th = {k: _t(v).requires_grad_(True) for k, v in hidden.items()}
    got = dpa.dpa_loss_from_hidden(
        lambda h: (h @ wt).float(), th["pos"], th["neg"], *map(_t, labs),
        th["pref"], th["fref"], _t(rl), alpha=0.4, chunk=chunk)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w_), **VAL)
    got.total.backward()
    for k in ("pos", "neg", "pref"):
        np.testing.assert_allclose(th[k].grad.numpy(), np.asarray(want_g[k]),
                                   err_msg=k, **GRAD)
    assert th["fref"].grad is None or not th["fref"].grad.any()


@pytest.mark.parametrize("chunk", [3, 7])
def test_chunked_pieces_equal_full_pieces(chunk):
    """per_token_logps_chunked and kl_divergence_chunked equal their
    full-logit forms, under no_grad too (no checkpoint regions there)."""
    _, hidden, (pl, _, _, _), rl, w = _batch(4)
    wt = _t(w)

    def logits_fn(h):
        return (h @ wt).float()

    hp, hr = _t(hidden["pos"]), _t(hidden["fref"])
    full_lp = dpa.per_token_logps(logits_fn(hp), _t(pl))
    full_kl = dpa.kl_divergence(logits_fn(hp), logits_fn(hr), _t(rl))
    with torch.no_grad():
        lp = dpa.per_token_logps_chunked(logits_fn, hp, _t(pl), chunk)
        kl = dpa.kl_divergence_chunked(logits_fn, hp, hr, _t(rl), chunk)
    np.testing.assert_allclose(lp.numpy(), full_lp.numpy(), **VAL)
    np.testing.assert_allclose(float(kl), float(full_kl), **VAL)
