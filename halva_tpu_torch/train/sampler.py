"""Host-side deterministic samplers.

Replaces the reference's torch samplers:
- LengthGroupedSampler with modality grouping
  (llava/train/halva_trainer.py:60-152): batches drawn from
  length-sorted megabatches so padded waste is minimized;
- VILADistributedSampler (vila/train/halva_trainer.py:128-239): per-host
  deterministic sharding of the index stream (the host count/index are
  arguments: one card is host 0 of 1).

Counterpart of halva_tpu/train/sampler.py, its code copied: the same
`random` seeds give the same index streams.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Sequence


def split_to_even_chunks(
    indices: Sequence[int], lengths: Sequence[int], num_chunks: int
) -> List[List[int]]:
    """Greedy balance of total length across chunks (reference :60-79)."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    num_per = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    sums = [0] * num_chunks
    for idx in indices:
        slot = sums.index(min(sums))
        chunks[slot].append(idx)
        sums[slot] += lengths[idx]
        if len(chunks[slot]) == num_per:
            sums[slot] = float("inf")
    return chunks


def modality_length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    world_size: int,
    seed: int = 0,
) -> List[int]:
    """Group by modality (sign of length), sort inside megabatches
    (reference get_modality_length_grouped_indices, :82-118)."""
    rng = random.Random(seed)
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return length_grouped_indices(
            [abs(l) for l in lengths], batch_size, world_size, seed
        )
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]

    def grouped(pairs):
        idx = [i for i, _ in pairs]
        ln = {i: l for i, l in pairs}
        perm = rng.sample(idx, len(idx))
        perm.sort(key=lambda i: ln[i], reverse=True)
        return perm

    mm_sorted = grouped(mm)
    lang_sorted = grouped(lang)
    mega = batch_size * world_size
    batches = [
        mm_sorted[i : i + mega] for i in range(0, len(mm_sorted), mega)
    ] + [
        lang_sorted[i : i + mega]
        for i in range(0, len(lang_sorted), mega)
    ]
    # keep the (possibly short) last batches at the end, shuffle the rest
    full = [b for b in batches if len(b) == mega]
    tail = [b for b in batches if len(b) != mega]
    rng.shuffle(full)
    out: List[int] = []
    for b in full + tail:
        out.extend(b)
    return out


def length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    world_size: int,
    seed: int = 0,
) -> List[int]:
    rng = random.Random(seed)
    idx = list(range(len(lengths)))
    rng.shuffle(idx)
    mega = batch_size * world_size
    megabatches = [idx[i : i + mega] for i in range(0, len(idx), mega)]
    for mb in megabatches:
        mb.sort(key=lambda i: lengths[i], reverse=True)
    out: List[int] = []
    for mb in megabatches:
        out.extend(mb)
    return out


def epoch_indices(
    modality_lengths: Sequence[int],
    batch_size: int,
    world_size: int,
    epochs: float,
    seed: int = 0,
) -> List[int]:
    """Concatenated per-epoch index orders with a fresh shuffle each epoch
    (HF Trainer reshuffles per epoch via set_epoch; the reference inherits
    that through transformers.Trainer). Epoch e uses seed `seed + e` so the
    stream is deterministic and resumable by skipping a batch count."""
    out: List[int] = []
    for e in range(max(1, int(-(-epochs // 1)))):
        out.extend(
            modality_length_grouped_indices(
                modality_lengths, batch_size, world_size, seed=seed + e
            )
        )
    return out


def host_shard_batches(
    indices: Sequence[int],
    global_batch: int,
    host_index: int,
    host_count: int,
    drop_last: bool = True,
) -> Iterator[List[int]]:
    """Deterministic per-host micro-batch stream: every host sees the same
    global batch boundaries and takes its contiguous slice."""
    per_host = global_batch // host_count
    assert per_host * host_count == global_batch
    for start in range(0, len(indices), global_batch):
        gb = indices[start : start + global_batch]
        if len(gb) < global_batch:
            if drop_last:
                return
            gb = list(gb) + list(gb[: global_batch - len(gb)])
        yield list(gb[host_index * per_host : (host_index + 1) * per_host])
