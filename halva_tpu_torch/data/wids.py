"""Indexed webdataset over tar shards: shard list + LRU cache + samplers.

Reimplements the reference's vendored wids library surface
(vila/wids/wids.py: ShardListDataset:450, LRUShards:370,
DistributedChunkedSampler:758) on top of the native tario reader:

- samples are groups of tar members sharing a basename stem
  ("0001.jpg" + "0001.json" -> one sample dict keyed by extension);
- ShardListDataset maps a global index over cumulative shard sizes and
  keeps at most `cache_size` shards open (LRU);
- DistributedChunkedSampler hands each host a contiguous chunk and
  shuffles within it (reference :758; the chunking keeps shard locality
  so hosts don't thrash each other's shards).
"""

from __future__ import annotations

import bisect
import json
import random
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Sequence

from halva_tpu_torch.data.tario import IndexedTar


def _group_members(names: Sequence[str]) -> List[List[int]]:
    """Group member indices by sample stem (text before first dot of the
    basename), preserving shard order."""
    groups: "OrderedDict[str, List[int]]" = OrderedDict()
    for i, name in enumerate(names):
        base = name.rsplit("/", 1)[-1]
        stem = base.split(".", 1)[0]
        key = name[: len(name) - len(base)] + stem
        groups.setdefault(key, []).append(i)
    return list(groups.values())


class ShardIndex:
    """One open shard: member groups -> sample dicts."""

    def __init__(self, path: str):
        self.tar = IndexedTar(path)
        names = self.tar.names()
        self.names = names
        self.groups = _group_members(names)

    def __len__(self) -> int:
        return len(self.groups)

    def sample(self, i: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for m in self.groups[i]:
            name = self.names[m]
            base = name.rsplit("/", 1)[-1]
            ext = base.split(".", 1)[1] if "." in base else ""
            data = self.tar.get_by_index(m)
            if ext in ("json",):
                out[ext] = json.loads(data)
            elif ext in ("txt", "text", "caption"):
                out[ext] = data.decode()
            else:
                out[ext] = data
            out.setdefault("__key__", base.split(".", 1)[0])
        return out

    def close(self):
        self.tar.close()


class LRUShards:
    def __init__(self, cache_size: int = 4):
        self.cache_size = cache_size
        self._cache: "OrderedDict[str, ShardIndex]" = OrderedDict()

    def get(self, path: str) -> ShardIndex:
        if path in self._cache:
            self._cache.move_to_end(path)
            return self._cache[path]
        shard = ShardIndex(path)
        self._cache[path] = shard
        while len(self._cache) > self.cache_size:
            _, old = self._cache.popitem(last=False)
            old.close()
        return shard


class ShardListDataset:
    """Random access over a list of tar shards.

    `shards` is [(path, num_samples)] or just paths (sizes discovered by
    opening each shard once, like wids without a .json index).
    """

    def __init__(
        self,
        shards: Sequence,
        cache_size: int = 4,
        transform=None,
    ):
        self.lru = LRUShards(cache_size)
        self.paths: List[str] = []
        sizes: List[int] = []
        for s in shards:
            if isinstance(s, (tuple, list)):
                path, n = s
            else:
                path, n = s, len(self.lru.get(s))
            self.paths.append(path)
            sizes.append(int(n))
        self.cum = []
        total = 0
        for n in sizes:
            total += n
            self.cum.append(total)
        self.total = total
        self.transform = transform

    def __len__(self) -> int:
        return self.total

    def __getitem__(self, index: int) -> Dict[str, Any]:
        if index < 0 or index >= self.total:
            raise IndexError(index)
        shard_i = bisect.bisect_right(self.cum, index)
        prev = self.cum[shard_i - 1] if shard_i else 0
        sample = self.lru.get(self.paths[shard_i]).sample(index - prev)
        if self.transform:
            sample = self.transform(sample)
        return sample


class DistributedChunkedSampler:
    """Deterministic per-host contiguous chunk + in-chunk shuffle."""

    def __init__(
        self,
        dataset_size: int,
        rank: int,
        world_size: int,
        shuffle: bool = True,
        seed: int = 0,
    ):
        assert 0 <= rank < world_size
        per = dataset_size // world_size
        self.start = rank * per
        self.end = (
            dataset_size if rank == world_size - 1 else self.start + per
        )
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return self.end - self.start

    def __iter__(self) -> Iterator[int]:
        idx = list(range(self.start, self.end))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        return iter(idx)
