"""Packed DPA in the port (models/llava.py:forward_packed, the packed losses
of train/dpa.py, train/trainer.py:packed_dpa_step_fns) against the
reference's packed path (halva_tpu/tests/test_packed_dpa.py's items and
batcher) and against the port's own unpacked path, on LLAVA_TINY in fp32
with LoRA r=4 and a perturbed lora_b (at B = 0 the KL and the lora_a grads
are exactly 0).

- forward_packed's hidden states equal the reference's forward_packed
  (attn_impl "xla") within rtol 1e-5 (atol 1e-5), and each document's
  logits equal the port's unpacked llava.forward of that document alone
  within 1e-5.
- The packed loss parts (eval_loss) equal the reference's packed loss and
  the port's unpacked loss on the same samples within rtol 1e-5 each, with
  and without a ref image (the reference holds its own packed-vs-unpacked
  pair at 2e-4; fp32 on the CPU gives far less here).
- The packed micro-step's LoRA grads (train_step.loss_and_grads) equal the
  reference's and the port's unpacked micro-step's within 1e-5 of each
  leaf's largest |grad|; after two updates (the first applies lr(0) = 0)
  the packed and unpacked LoRA params agree within lr / 10 (Adam's
  1/sqrt(v) magnifies tiny grad differences near 0).
- dead sample slots (n_samples below max_samples) add nothing; the
  scatter's padding entries leave the embeddings as they were."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY as CFG
from halva_tpu.models import llava as jllava
from halva_tpu.train import trainer as jtrainer
from halva_tpu_torch import tree
from halva_tpu_torch.models import llava
from halva_tpu_torch.train import dpa, trainer
from halva_tpu_torch.train.data import collate
from halva_tpu_torch.train.pack import PackedDPABatcher

from test_packed_dpa import IMG, T, _make_items
from test_torch_trainer import _assert_grads_close, _np_policy
from test_torch_tree import port_cfg

torch.set_num_threads(2)

KW = dict(learning_rate=1e-3, grad_accum_steps=1, num_train_steps=4,
          loss_chunk=8)


def _batch(items, max_samples=4, seq_len=64, pn_rows=3, ref_rows=2):
    b = PackedDPABatcher(seq_len=seq_len, pn_rows=pn_rows, ref_rows=ref_rows,
                         max_samples=max_samples, num_image_tokens=T,
                         pad_token_id=0, image_shape=(3, IMG, IMG))
    batches = list(b.batches(iter(items)))
    assert len(batches) == 1, "the items must fit one packed batch"
    return batches[0]


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _forward_args(batch, side):
    return (f"{side}_input_ids", "images", f"{side}_img_src",
            f"{side}_img_row", f"{side}_img_col", f"{side}_segment_ids",
            f"{side}_positions")


@pytest.mark.parametrize("side", ["pn", "ref"])
def test_forward_packed_matches_reference(side):
    np_lp = _np_policy()
    batch = _batch(_make_items(4, seed=11))
    args = _forward_args(batch, side)
    want = jllava.forward_packed(jax.tree.map(jnp.asarray, np_lp), CFG,
                                 *(jnp.asarray(batch[a]) for a in args),
                                 attn_impl="xla", return_hidden=True)
    got = llava.forward_packed(tree.to_torch(np_lp, device="cpu"),
                               port_cfg(CFG),
                               *(torch.from_numpy(batch[a]) for a in args),
                               return_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_forward_packed_equals_the_unpacked_forward_per_document():
    np_lp = _np_policy()
    params = tree.to_torch(np_lp, device="cpu")
    cfg = port_cfg(CFG)
    items = _make_items(4, seed=11)
    batch = _batch(items)
    logits = llava.forward_packed(
        params, cfg, *(torch.from_numpy(batch[a])
                       for a in _forward_args(batch, "pn")))
    sid, neg = batch["pn_sample_ids"], batch["pn_neg_flags"]
    for i, item in enumerate(items):
        for flag, key in ((0, "input_ids"), (1, "neg_input_ids")):
            where = np.nonzero((sid == i + 1) & (neg == flag))
            row, cols = int(where[0][0]), where[1]
            ids = torch.from_numpy(item[key][None])
            image = torch.from_numpy(item["image"][None])
            want, _ = llava.forward(params, cfg, ids, image)
            assert want.shape[1] == len(cols)
            torch.testing.assert_close(logits[row, cols], want[0],
                                       rtol=1e-5, atol=1e-5)


def test_padding_scatter_entries_change_nothing():
    """Padding entries point at row R: the scatter drops them, and the
    forward equals one over only the live entries."""
    params = tree.to_torch(_np_policy(), device="cpu")
    cfg = port_cfg(CFG)
    batch = _t(_batch(_make_items(3, seed=5)))
    live = batch["pn_img_row"] < batch["pn_input_ids"].shape[0]
    assert 0 < int(live.sum()) < live.numel()
    full = llava.forward_packed(
        params, cfg, *(batch[a] for a in _forward_args(batch, "pn")))
    cut = dict(batch)
    for k in ("pn_img_src", "pn_img_row", "pn_img_col"):
        cut[k] = batch[k][live]
    want = llava.forward_packed(
        params, cfg, *(cut[a] for a in _forward_args(cut, "pn")))
    assert torch.equal(full, want)


def _jax_packed(np_lp, max_samples):
    tcfg = jtrainer.TrainConfig(attn_impl="xla", **KW)
    tr, fz, opt, st = jtrainer.init_train_state(
        jax.tree.map(jnp.asarray, np_lp), tcfg)
    step, ev = jtrainer.packed_dpa_step_fns(CFG, tcfg, opt,
                                            max_samples=max_samples)
    return tr, fz, st, step, ev


def _torch_state(np_lp, **kw):
    tcfg = trainer.TrainConfig(**KW, **kw)
    tr, fz, opt, st = trainer.init_train_state(
        tree.to_torch(jax.tree.map(np.array, np_lp), device="cpu"), tcfg)
    return tr, fz, st, tcfg


def _torch_packed(np_lp, max_samples):
    tr, fz, st, tcfg = _torch_state(np_lp)
    step, ev = trainer.packed_dpa_step_fns(port_cfg(CFG), tcfg, st,
                                           max_samples=max_samples)
    return tr, fz, st, step, ev


def _torch_unpacked(np_lp):
    tr, fz, st, tcfg = _torch_state(np_lp)
    step, ev = trainer.dpa_step_fns(port_cfg(CFG), tcfg, st)
    return tr, fz, st, step, ev


@pytest.mark.parametrize("with_ref_image", [True, False])
def test_packed_loss_matches_reference_and_unpacked(with_ref_image):
    np_lp = _np_policy()
    items = _make_items(4, seed=11, with_ref_image=with_ref_image)
    batch = _batch(items)
    jt, jf, _, _, jev = _jax_packed(np_lp, 4)
    want = jax.jit(jev)(jt, jf, None, _j(batch))
    tt, tf, _, _, tev = _torch_packed(np_lp, 4)
    got = tev(tt, tf, None, _t(batch))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    assert float(got.divergence) > 0
    ut, uf, _, _, uev = _torch_unpacked(np_lp)
    un = uev(ut, uf, None, _t(collate(items, pad_token_id=0,
                                      pad_multiple=8)))
    for g, w in zip(got[:3], un[:3]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_dead_sample_slots_add_nothing():
    """The same 3 samples under max_samples 3 and 6: the loss divides by
    n_samples, and the 3 dead slots add nothing."""
    np_lp = _np_policy()
    items = _make_items(3, seed=21)
    tt, tf, _, _, ev3 = _torch_packed(np_lp, 3)
    _, _, _, _, ev6 = _torch_packed(np_lp, 6)
    a = ev3(tt, tf, None, _t(_batch(items, max_samples=3)))
    b = ev6(tt, tf, None, _t(_batch(items, max_samples=6)))
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(float(x), float(y), rtol=1e-6)


def test_packed_grads_match_reference_and_unpacked():
    np_lp = _np_policy()
    items = _make_items(3, seed=21)
    batch = _batch(items, max_samples=3)
    jt, jf, _, _, jev = _jax_packed(np_lp, 3)
    # the reference's packed step has no loss_and_grads hook; its eval loss
    # holds the frozen reference under stop_gradient, as its step does
    jbatch = _j(batch)
    jg = jax.jit(jax.grad(lambda t: jev(t, jf, None, jbatch).loss))(jt)
    tt, tf, tst, tstep, _ = _torch_packed(np_lp, 3)
    _, parts, tg = tstep.loss_and_grads(tt, tf, None, _t(batch))
    _assert_grads_close(tg, jg, rel=1e-5)
    ut, uf, ust, ustep, _ = _torch_unpacked(np_lp)
    ubatch = _t(collate(items, pad_token_id=0, pad_multiple=8))
    _, uparts, ug = ustep.loss_and_grads(ut, uf, None, ubatch)
    np.testing.assert_allclose(float(parts.total), float(uparts.total),
                               rtol=1e-5)
    _assert_grads_close(tg, tree.map_tree(
        lambda g: None if g is None else g.numpy(), ug), rel=1e-5)
    # one update each (lr(0) = 0 moves nothing), then one that moves
    for _ in range(2):
        tt, tst, _ = tstep(tt, tf, None, tst, _t(batch))
        ut, ust, _ = ustep(ut, uf, None, ust, ubatch)
    for (path, a), (_, b) in zip(tree.flatten(tt), tree.flatten(ut)):
        if a is not None:
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                       rtol=0, atol=KW["learning_rate"] / 10,
                                       err_msg=str(path))


def test_packed_phrase_logps_equals_the_row_per_sample_sum():
    """One sample a row: the packed phrase sums are the row-per-sample
    accumulate_phrase_logps."""
    rng = np.random.RandomState(0)
    r, s, k = 3, 20, 5
    lp = torch.from_numpy(rng.randn(r, s).astype(np.float32))
    labels = torch.from_numpy(rng.randint(-1, 5, (r, s)).astype(np.int32))
    labels[labels < 0] = -100
    signs = torch.from_numpy(rng.randint(0, k + 1, (r, s)).astype(np.int32))
    sid = torch.arange(1, r + 1, dtype=torch.int32)[:, None].expand(r, s)
    got = dpa.packed_phrase_logps(lp, labels, signs, sid,
                                  torch.ones(r, s, dtype=torch.bool), r, k)
    want = dpa.accumulate_phrase_logps(lp * (labels != -100).float(), signs,
                                       k)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
