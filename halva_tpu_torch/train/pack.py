"""Packed DPA batches: many variable-length samples per fixed device shape.

Counterpart of halva_tpu/train/pack.py (numpy host code, the same shapes and
invariants). The unpacked path pads every (pos, neg, ref) row to the longest
in the batch; here documents are packed end to end into a FIXED number of
fixed-length rows (first fit), attention keeps them apart by segment ids,
RoPE restarts per document through explicit positions, and the image-token
splice becomes a host-planned scatter of vision features into the packed
embedding rows (models/llava.py:forward_packed). The work then scales with
real tokens, not with max_length.

Shapes are constant across steps:
  pn rows:  (pn_rows, seq_len)  pos+neg documents
  ref rows: (ref_rows, seq_len) KL-regularizer documents
  images:   (max_images, 3, H, W) unique images (pos and neg SHARE one
            vision forward; the unpacked path encodes each image twice)
  scatter:  (2*max_samples,) / (max_samples,) image placements; padding
            entries point at row == n_rows and are dropped by the device
            scatter.

The number of whole samples per batch varies step to step (token-budget
batching); the loss divides by the real `n_samples` scalar.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np

from halva_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX

Batch = Dict[str, np.ndarray]


def expand_image_doc(
    ids: np.ndarray,
    labels: np.ndarray,
    signs: Optional[np.ndarray],
    num_image_tokens: int,
    pad_token_id: int,
):
    """Expand the single IMAGE_TOKEN_INDEX sentinel into a
    num_image_tokens-long placeholder block (host twin of
    llava.splice_image_tokens): returns (ids, labels, signs, img_offset)
    with img_offset None when the doc has no image. Placeholder ids are
    pad tokens — their embeddings are overwritten by the feature
    scatter before the decoder runs."""
    sent = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
    if signs is None:
        signs = np.zeros_like(ids)
    if len(sent) == 0:
        return ids, labels, signs, None
    p = int(sent[0])  # HALVA data is single-image (train_halva.py:341)
    t = num_image_tokens
    out_ids = np.concatenate(
        [ids[:p], np.full(t, pad_token_id, ids.dtype), ids[p + 1 :]]
    )
    out_labels = np.concatenate(
        [labels[:p], np.full(t, IGNORE_INDEX, labels.dtype), labels[p + 1 :]]
    )
    out_signs = np.concatenate(
        [signs[:p], np.zeros(t, signs.dtype), signs[p + 1 :]]
    )
    return out_ids, out_labels, out_signs, p


class _RowSet:
    """Fixed row count x fixed length, greedy first-fit placement."""

    def __init__(self, rows: int, seq_len: int, pad_token_id: int):
        self.rows = rows
        self.seq_len = seq_len
        self.fill = [0] * rows
        self.input_ids = np.full((rows, seq_len), pad_token_id, np.int32)
        self.labels = np.full((rows, seq_len), IGNORE_INDEX, np.int32)
        self.signs = np.zeros((rows, seq_len), np.int32)
        self.sample_ids = np.zeros((rows, seq_len), np.int32)
        self.neg_flags = np.zeros((rows, seq_len), np.int32)
        self.segment_ids = np.zeros((rows, seq_len), np.int32)
        self.positions = np.zeros((rows, seq_len), np.int32)
        self.docs_in_row = [0] * rows

    def place(
        self,
        row: int,
        ids: np.ndarray,
        labels: np.ndarray,
        signs: np.ndarray,
        sid: int,
        neg: bool,
    ) -> int:
        """Write one document; returns its start column."""
        start = self.fill[row]
        n = len(ids)
        assert start + n <= self.seq_len
        # doc-boundary safety: the shifted logp gather crosses document
        # boundaries, but the crossing target is each document's FIRST
        # label — it must be IGNORE (true for every conversation
        # template: position 0 is BOS inside the unsupervised prompt).
        # See dpa.dpa_loss_from_hidden_packed.
        assert labels[0] == IGNORE_INDEX, (
            "packed document starts with a supervised token"
        )
        sl = slice(start, start + n)
        self.input_ids[row, sl] = ids
        self.labels[row, sl] = labels
        self.signs[row, sl] = signs
        self.sample_ids[row, sl] = sid
        self.neg_flags[row, sl] = 1 if neg else 0
        self.docs_in_row[row] += 1
        self.segment_ids[row, sl] = self.docs_in_row[row]
        self.positions[row, sl] = np.arange(n, dtype=np.int32)
        self.fill[row] = start + n
        return start


class PackedDPABatcher:
    """Accumulate HallDataset items into fixed-shape packed batches.

    Emits a batch when the next sample no longer fits (any of: pn rows,
    ref rows, image slots, max_samples). Samples whose expanded pos,
    neg, or ref document exceeds seq_len are dropped (the unpacked path
    would have truncated mid-answer; reference parity keeps truncation
    pre-splice in HallDataset.max_length — choose
    seq_len >= max_length + num_image_tokens - 1 to never drop)."""

    def __init__(
        self,
        seq_len: int,
        pn_rows: int,
        ref_rows: int,
        max_samples: int,
        num_image_tokens: int,
        pad_token_id: int,
        image_shape,
        max_images: Optional[int] = None,
    ):
        self.seq_len = seq_len
        self.pn_rows = pn_rows
        self.ref_rows = ref_rows
        self.max_samples = max_samples
        self.t = num_image_tokens
        self.pad_id = pad_token_id
        self.image_shape = tuple(image_shape)
        self.max_images = max_images or 2 * max_samples
        self.dropped = 0
        self._reset()

    def _reset(self):
        self.pn = _RowSet(self.pn_rows, self.seq_len, self.pad_id)
        self.ref = _RowSet(self.ref_rows, self.seq_len, self.pad_id)
        self.images: List[np.ndarray] = []
        self.pn_scatter: List[tuple] = []  # (img, row, col)
        self.ref_scatter: List[tuple] = []
        self.n = 0

    def _docs(self, item: Dict[str, Any]):
        pos = expand_image_doc(
            np.asarray(item["input_ids"], np.int32),
            np.asarray(item["labels"], np.int32),
            np.asarray(item["pos_signs"], np.int32),
            self.t,
            self.pad_id,
        )
        neg = expand_image_doc(
            np.asarray(item["neg_input_ids"], np.int32),
            np.asarray(item["neg_labels"], np.int32),
            np.asarray(item["neg_signs"], np.int32),
            self.t,
            self.pad_id,
        )
        ref = expand_image_doc(
            np.asarray(item["ref_input_ids"], np.int32),
            np.asarray(item["ref_labels"], np.int32),
            None,
            self.t,
            self.pad_id,
        )
        return pos, neg, ref

    def add(self, item: Dict[str, Any]) -> Optional[Batch]:
        """Try to place `item`; returns a finished batch first when the
        current one is full (the item is then carried into the fresh
        batch)."""
        pos, neg, ref = self._docs(item)
        if any(len(d[0]) > self.seq_len for d in (pos, neg, ref)):
            self.dropped += 1
            return None
        out = None
        if not self._try_place(item, pos, neg, ref):
            out = self.emit()
            if not self._try_place(item, pos, neg, ref):
                # does not fit even an EMPTY batch (e.g. pn_rows=1 and
                # pos+neg together exceed seq_len): drop, like the
                # over-length drop above — never kill the run
                self.dropped += 1
        return out

    def _try_place(self, item, pos, neg, ref) -> bool:
        if self.n >= self.max_samples:
            return False
        n_imgs = (
            1 if (pos[3] is not None or neg[3] is not None) else 0
        ) + (
            1 if ref[3] is not None and item.get("ref_image") is not None
            else 0
        )
        if len(self.images) + n_imgs > self.max_images:
            return False
        # probe all three placements before mutating any row set: pos
        # and neg may land in the same row, so probe sequentially on a
        # copy of the fill state.
        fill_pn = list(self.pn.fill)
        r_pos = self._probe(fill_pn, len(pos[0]))
        if r_pos is None:
            return False
        fill_pn[r_pos] += len(pos[0])
        r_neg = self._probe(fill_pn, len(neg[0]))
        r_ref = self._probe(list(self.ref.fill), len(ref[0]))
        if r_neg is None or r_ref is None:
            return False

        sid = self.n + 1
        c_pos = self.pn.place(r_pos, pos[0], pos[1], pos[2], sid, False)
        c_neg = self.pn.place(r_neg, neg[0], neg[1], neg[2], sid, True)
        c_ref = self.ref.place(r_ref, ref[0], ref[1], ref[2], sid, False)

        if pos[3] is not None or neg[3] is not None:
            # pos and neg SHARE the sample's image feature block; either
            # side may lack the sentinel (its doc then keeps pad-token
            # embeddings — the unpacked splice's no-image behavior)
            img_idx = len(self.images)
            self.images.append(np.asarray(item["image"], np.float32))
            if pos[3] is not None:
                self.pn_scatter.append((img_idx, r_pos, c_pos + pos[3]))
            if neg[3] is not None:
                self.pn_scatter.append((img_idx, r_neg, c_neg + neg[3]))
        if ref[3] is not None and item.get("ref_image") is not None:
            img_idx = len(self.images)
            self.images.append(np.asarray(item["ref_image"], np.float32))
            self.ref_scatter.append((img_idx, r_ref, c_ref + ref[3]))
        self.n += 1
        return True

    def _probe(self, fill: List[int], length: int) -> Optional[int]:
        # first-fit on a fill snapshot (callers pass a copy)
        for r, f in enumerate(fill):
            if f + length <= self.seq_len:
                return r
        return None

    def emit(self) -> Optional[Batch]:
        """Finalize the current batch (None when empty) and reset."""
        if self.n == 0:
            return None
        out: Batch = {
            "pn_input_ids": self.pn.input_ids,
            "pn_labels": self.pn.labels,
            "pn_signs": self.pn.signs,
            "pn_sample_ids": self.pn.sample_ids,
            "pn_neg_flags": self.pn.neg_flags,
            "pn_segment_ids": self.pn.segment_ids,
            "pn_positions": self.pn.positions,
            "ref_input_ids": self.ref.input_ids,
            "ref_labels": self.ref.labels,
            "ref_segment_ids": self.ref.segment_ids,
            "ref_positions": self.ref.positions,
            "n_samples": np.int32(self.n),
        }
        imgs = np.zeros((self.max_images,) + self.image_shape, np.float32)
        for i, im in enumerate(self.images):
            imgs[i] = im
        out["images"] = imgs
        out.update(
            _scatter_arrays(
                "pn", self.pn_scatter, 2 * self.max_samples, self.pn_rows
            )
        )
        out.update(
            _scatter_arrays(
                "ref", self.ref_scatter, self.max_samples, self.ref_rows
            )
        )
        self._reset()
        return out

    def batches(self, items: Iterable[Dict[str, Any]]) -> Iterator[Batch]:
        for item in items:
            if item is None:
                continue
            b = self.add(item)
            if b is not None:
                yield b
        b = self.emit()
        if b is not None:
            yield b


def _scatter_arrays(prefix: str, entries, cap: int, drop_row: int):
    src = np.zeros(cap, np.int32)
    row = np.full(cap, drop_row, np.int32)  # out of range -> dropped
    col = np.zeros(cap, np.int32)
    assert len(entries) <= cap, (len(entries), cap)
    for i, (s, r, c) in enumerate(entries):
        src[i], row[i], col[i] = s, r, c
    return {
        f"{prefix}_img_src": src,
        f"{prefix}_img_row": row,
        f"{prefix}_img_col": col,
    }
