"""The train CLI's data path in the port (halva_tpu_torch/train/data.py,
train/sampler.py) against the reference's, output for output: HallDataset's
samples on test_train_e2e's files (SPTok and a tests/tokutil.py tokenizer),
collate's padded batch, and the index stream the loop walks. The port's
copies are the reference's text (test_torch_host_copies.py); this holds
what they compute over the port's own constants, conversation templates
and image processor. Tolerance: none, every comparison is exact."""

import numpy as np
import pytest

from halva_tpu.mm_utils import ImageProcessor as JImageProcessor
from halva_tpu.train import data as jdata
from halva_tpu.train import sampler as jsampler
from halva_tpu_torch.mm_utils import ImageProcessor
from halva_tpu_torch.train import data as tdata
from halva_tpu_torch.train import sampler as tsampler

from test_data_pipeline import SPTok
from test_train_e2e import _make_data


def _same(got, want):
    if want is None:
        assert got is None
        return
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _tok(kind, tmp_path):
    if kind == "sptok":
        return SPTok()
    from tokutil import build_tiny_tokenizer

    return build_tiny_tokenizer(str(tmp_path / "tok"))


@pytest.mark.parametrize("tok_kind,max_length,ref", [
    ("sptok", 128, True), ("sptok", 40, True), ("sptok", 128, False),
    ("tokutil", 256, True)])
def test_hall_dataset_samples_equal(tmp_path, tok_kind, max_length, ref):
    dp, rp, img = _make_data(tmp_path)  # tags closed/open/qa: balancing
    tok = _tok(tok_kind, tmp_path)
    kw = dict(image_folder=img, max_length=max_length, seed=3)
    want = jdata.HallDataset(dp, rp if ref else None, tok,
                             JImageProcessor(size=28, crop_size=28), **kw)
    got = tdata.HallDataset(dp, rp if ref else None, tok,
                            ImageProcessor(size=28, crop_size=28), **kw)
    assert len(got) == len(want) > 0
    assert got.modality_lengths == want.modality_lengths
    kept = 0
    for i in range(len(want)):
        w = want[i]
        _same(got[i], w)
        kept += w is not None
    if max_length >= 128:
        assert kept == len(want)
    batch = [s for s in (want[i] for i in range(len(want))) if s is not None]
    if batch:
        _same(tdata.collate(batch[:3], pad_token_id=0),
              jdata.collate(batch[:3], pad_token_id=0))
        _same(tdata.collate(batch[:2], pad_token_id=7, pad_to=192),
              jdata.collate(batch[:2], pad_token_id=7, pad_to=192))


@pytest.mark.parametrize("template", ["v1", "mpt", "llama_2", "plain"])
def test_encoders_equal(template):
    from halva_tpu.conversation import get_template as jget
    from halva_tpu_torch.conversation import get_template as tget

    tok = SPTok()
    turns = [("<image>\nWhat?", "A cat."), ("And now?", "A dog.")]
    w = jdata.encode_plain_conversation(turns, tok, jget(template))
    g = tdata.encode_plain_conversation(turns, tok, tget(template))
    assert (g is None) == (w is None)
    if w is not None:
        for f in ("input_ids", "labels", "signs"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    q = "<image>\nWhat do you see?"
    masked = "I see <MASK>a red car</MASK> and <MASK>two dogs </MASK>."
    plain = "I see a red car and two dogs."
    w = jdata.encode_masked_conversation(q, masked, plain, tok, jget(template))
    g = tdata.encode_masked_conversation(q, masked, plain, tok,
                                         tget(template))
    assert (g is None) == (w is None)
    if w is not None:
        for f in ("input_ids", "labels", "signs"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("epochs,batch,world,seed", [
    (1.0, 2, 1, 42), (2.0, 4, 2, 0), (1.5, 3, 1, 7)])
def test_index_stream_equal(epochs, batch, world, seed):
    """The loop's index stream, mixed modalities (negative lengths are
    text-only samples), and the host shards it cuts."""
    rng = np.random.RandomState(seed)
    lengths = [int(n) * (1 if i % 5 else -1)
               for i, n in enumerate(rng.randint(1, 50, 37))]
    want = jsampler.epoch_indices(lengths, batch, world, epochs, seed=seed)
    got = tsampler.epoch_indices(lengths, batch, world, epochs, seed=seed)
    assert got == want
    gb = batch * world
    for host in range(world):
        assert list(tsampler.host_shard_batches(got, gb, host, world)) == (
            list(jsampler.host_shard_batches(want, gb, host, world)))
