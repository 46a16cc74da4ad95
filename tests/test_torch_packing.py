"""The port's sequence packing (halva_tpu_torch/ops/packing.py) and packed
DPA batcher (halva_tpu_torch/train/pack.py) against the reference's
halva_tpu/ops/packing.py and halva_tpu/train/pack.py, on the CPU.

- plan_packing, pack, unpack_logps and pack_batch_np give exactly the
  reference's arrays for the same seeded lengths and values.
- PackedDPABatcher gives, batch for batch, arrays np.array_equal to the
  reference's (and its dropped count) over several seeds and shapes,
  including the oversize drop and the neg-without-image sentinel cases of
  tests/test_packed_dpa.py; expand_image_doc likewise.
- A packed Llama forward (segment ids, restarting positions) equals the
  port's unpacked forward document by document.
Tolerance: none for the host arrays (every comparison is exact); the
forward's logits within 1e-5 (fp32, LLAVA_TINY's LLM)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.constants import IMAGE_TOKEN_INDEX
from halva_tpu.ops import packing as jpacking
from halva_tpu.train import pack as jpack
from halva_tpu_torch import tree
from halva_tpu_torch.models import llama
from halva_tpu_torch.ops import packing
from halva_tpu_torch.train import pack

from test_packed_dpa import IMG, T, _make_items
from test_torch_tree import jax_tree, port_cfg

torch.set_num_threads(2)


def _lengths(seed, n=12, hi=40):
    return np.random.RandomState(seed).randint(1, hi, n).tolist()


def _same_plan(got, want):
    for name in ("src_row", "src_idx", "segment_ids", "positions"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.doc_map == want.doc_map


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("max_len", [40, 64])
def test_plan_packing_equals_the_references(seed, max_len):
    lens = _lengths(seed)
    _same_plan(packing.plan_packing(lens, max_len),
               jpacking.plan_packing(lens, max_len))


@pytest.mark.parametrize("seed", [0, 5])
def test_pack_and_unpack_equal_the_references(seed):
    rng = np.random.RandomState(seed)
    lens = _lengths(seed, n=6, hi=16)
    plan = jpacking.plan_packing(lens, 24)
    b, s = len(lens), max(lens)
    arrays = {"ids": rng.randint(0, 99, (b, s)).astype(np.int32),
              "emb": rng.randn(b, s, 3).astype(np.float32)}
    fill = {"ids": -7}
    want = jpacking.pack(plan, {k: jnp.asarray(v) for k, v in
                                arrays.items()}, fill)
    got = packing.pack(plan, {k: torch.from_numpy(v) for k, v in
                              arrays.items()}, fill)
    for k in arrays:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert got[k].dtype == torch.from_numpy(arrays[k]).dtype
    vals = rng.randn(*plan.segment_ids.shape).astype(np.float32)
    got = packing.unpack_logps(torch.from_numpy(vals), plan, b, s)
    want = jpacking.unpack_logps(jnp.asarray(vals), plan, b, s)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 3])
def test_pack_batch_np_equals_the_references(seed):
    rng = np.random.RandomState(seed)
    samples = [{"ids": rng.randint(5, 200, (n,)).astype(np.int32),
                "lab": rng.randint(-100, 9, (n,)).astype(np.int64)}
               for n in _lengths(seed, n=7, hi=20)]
    fill = {"ids": 0, "lab": -100}
    got, gplan = packing.pack_batch_np(samples, ["ids", "lab"], 24, fill)
    want, wplan = jpacking.pack_batch_np(samples, ["ids", "lab"], 24, fill)
    _same_plan(gplan, wplan)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def _both(**kw):
    args = dict(seq_len=64, pn_rows=3, ref_rows=2, max_samples=4,
                num_image_tokens=T, pad_token_id=0, image_shape=(3, IMG, IMG))
    args.update(kw)
    return pack.PackedDPABatcher(**args), jpack.PackedDPABatcher(**args)


@pytest.mark.parametrize("seed", [0, 3, 11, 21])
@pytest.mark.parametrize("shape", [{}, {"seq_len": 48, "pn_rows": 2,
                                        "ref_rows": 1, "max_samples": 3}])
def test_batcher_equals_the_references(seed, shape):
    items = _make_items(9, seed=seed, with_ref_image=seed % 2 == 0)
    mine, ref = _both(**shape)
    got = list(mine.batches(iter(items)))
    _same_batches(got, list(ref.batches(iter(items))))
    assert len(got) >= 2 and mine.dropped == ref.dropped


@pytest.mark.parametrize("seq_len", [24, 30])
def test_batcher_oversize_drop_equals_the_references(seq_len):
    """pos + neg together exceed the one row of an empty batch: dropped
    and counted, as tests/test_packed_dpa.py:244 (at 30 tokens some pairs
    still fit)."""
    items = _make_items(6, seed=7)
    mine, ref = _both(seq_len=seq_len, pn_rows=1, ref_rows=1)
    got = list(mine.batches(iter(items)))
    _same_batches(got, list(ref.batches(iter(items))))
    placed = sum(int(b["n_samples"]) for b in got)
    assert mine.dropped == ref.dropped >= 1
    assert placed + mine.dropped == len(items)


def test_batcher_neg_without_image_sentinel_equals_the_references():
    """pos has the sentinel and neg does not, and vice versa: one placement
    each (tests/test_packed_dpa.py:257)."""
    items = _make_items(2, seed=9)
    for key, i in (("neg_input_ids", 0), ("input_ids", 1)):
        items[i][key] = np.where(items[i][key] == IMAGE_TOKEN_INDEX,
                                 np.int32(7), items[i][key]).astype(np.int32)
    mine, ref = _both()
    got = list(mine.batches(iter(items)))
    _same_batches(got, list(ref.batches(iter(items))))
    live = got[0]["pn_img_row"] < got[0]["pn_input_ids"].shape[0]
    assert int(live.sum()) == 2


def test_expand_image_doc_equals_the_references():
    items = _make_items(3, seed=4)
    for it in items:
        for signs in (it["pos_signs"], None):
            got = pack.expand_image_doc(it["input_ids"], it["labels"], signs,
                                        T, 0)
            want = jpack.expand_image_doc(it["input_ids"], it["labels"],
                                          signs, T, 0)
            assert got[3] == want[3]
            for a, b in zip(got[:3], want[:3]):
                assert np.array_equal(a, b)


def test_packed_forward_equals_the_unpacked_forward_per_document():
    cfg = port_cfg(LLAVA_TINY).llm
    params = tree.to_torch(jax_tree(LLAVA_TINY), device="cpu")["llm"]
    rng = np.random.RandomState(0)
    samples = [{"ids": rng.randint(5, 200, (n,)).astype(np.int32)}
               for n in (7, 11, 4, 9)]
    packed, plan = packing.pack_batch_np(samples, ["ids"], max_len=16,
                                         fill={"ids": 0})
    assert plan.src_row.shape[0] < len(samples)  # documents share rows
    logits = llama.forward(params, cfg, torch.from_numpy(packed["ids"]),
                           segment_ids=torch.from_numpy(plan.segment_ids),
                           positions=torch.from_numpy(plan.positions))
    seen = 0
    for r, docs in enumerate(plan.doc_map):
        start = 0
        for sample in docs:
            ids = torch.from_numpy(samples[sample]["ids"][None])
            want = llama.forward(params, cfg, ids)[0]
            n = want.shape[0]
            torch.testing.assert_close(logits[r, start:start + n], want,
                                       rtol=1e-5, atol=1e-5)
            start += n
            seen += 1
    assert seen == len(samples)
