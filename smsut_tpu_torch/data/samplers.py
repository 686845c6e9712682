# -*- coding: utf-8 -*-
"""Batch samplers over per-modality sample-index pools: copies of
``smsut_tpu/data/samplers.py`` that draw the same ``random.Random`` calls in
the same order, so one seed gives one index stream in both packages.

The in-turn sampler round-robins modalities so each training batch is
single-modality, reshuffling a modality's pool on wraparound; the balance
sampler mixes every modality in each batch; the test sampler walks each
modality sequentially including the final partial batch.  Under a
process group :class:`ShardedBatchSampler` keeps a rank's contiguous rows
of each global batch.
"""
from __future__ import annotations

import random
from typing import Iterator, List, Optional


class InTurnTrainBatchSampler:
    """Single-modality round-robin batches."""

    def __init__(self, samples: List[List[int]], batch_size: int,
                 shuffle: bool = False, rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()
        self.samples = [list(s) for s in samples]
        self.num_modality = len(samples)
        self.batch_size = batch_size
        self.starts = [0 for _ in range(self.num_modality)]
        self.shuffle = shuffle
        self.queue = list(range(self.num_modality))
        self.cur_modality = 0

        max_batch_per_modality = 0
        for i, spl in enumerate(self.samples):
            n = (len(spl) // batch_size - 1 if len(spl) % batch_size
                 else len(spl) // batch_size)
            max_batch_per_modality = max(n, max_batch_per_modality)
            self.rng.shuffle(self.samples[i])
        self.n = self.num_modality * max_batch_per_modality

    def __iter__(self) -> Iterator[List[int]]:
        for _ in range(self.n):
            cur = self.cur_modality if not self.shuffle else self.queue[self.cur_modality]
            s = self.starts[cur]
            if s + self.batch_size >= len(self.samples[cur]):
                self.starts[cur] = 0
                s = 0
                self.rng.shuffle(self.samples[cur])
            else:
                self.starts[cur] += self.batch_size
            batch = self.samples[cur][s: s + self.batch_size]
            if len(batch) == self.batch_size:
                yield batch
            if self.shuffle and self.cur_modality + 1 == self.num_modality:
                self.rng.shuffle(self.queue)
            self.cur_modality = (self.cur_modality + 1) % self.num_modality

    def __len__(self) -> int:
        return self.n


class InTurnTestBatchSampler:
    """Sequential per-modality batches, partial final batch included."""

    def __init__(self, samples: List[List[int]], batch_size: int):
        self.samples = [list(s) for s in samples]
        self.batch_size = batch_size
        self.n = sum(len(spl) // batch_size for spl in self.samples)

    def __iter__(self) -> Iterator[List[int]]:
        for spl in self.samples:
            for i in range(0, len(spl), self.batch_size):
                yield spl[i: i + self.batch_size]

    def __len__(self) -> int:
        return self.n


class ShardedBatchSampler:
    """Any batch sampler's global batches cut to one rank's contiguous
    rows ``[shard_id*B/N, (shard_id+1)*B/N)`` (``parallel.distributed``
    ``local_batch_slice``).  Every rank runs the same seeded base sampler,
    so the ranks' rows together are the one-process batch stream."""

    def __init__(self, base, num_shards: int, shard_id: int):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards}")
        self.base = base
        self.num_shards = num_shards
        self.shard_id = shard_id

    def __iter__(self) -> Iterator[List[int]]:
        for idxs in self.base:
            if len(idxs) % self.num_shards:
                raise ValueError(
                    f"global batch of {len(idxs)} not divisible by "
                    f"{self.num_shards} processes; pick batch_size % "
                    f"process_count == 0")
            per = len(idxs) // self.num_shards
            yield idxs[self.shard_id * per: (self.shard_id + 1) * per]

    def __len__(self) -> int:
        return len(self.base)


class ModalityBalanceBatchSampler:
    """Mixed-modality batches: batch_size/n_modal samples of each modality."""

    def __init__(self, samples: List[List[int]], batch_size: int,
                 rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()
        self.samples = [list(s) for s in samples]
        self.num_modality = len(samples)
        self.batch_size = batch_size
        assert batch_size % self.num_modality == 0, \
            "Batch size must be an integral multiple of #modality."
        self.per_modality = batch_size // self.num_modality
        self.starts = [0 for _ in range(self.num_modality)]
        self.n = 0
        for i, spl in enumerate(self.samples):
            self.n = max(self.n, len(spl))
            self.rng.shuffle(self.samples[i])

    def __iter__(self) -> Iterator[List[int]]:
        for _ in range(0, self.n, self.per_modality):
            batch = []
            for j, spl in enumerate(self.samples):
                s = self.starts[j]
                batch.extend(spl[s: s + self.per_modality])
                self.starts[j] += self.per_modality
                if self.starts[j] > len(spl):
                    self.rng.shuffle(self.samples[j])
                    self.starts[j] = 0
            if len(batch) == self.batch_size:
                yield batch

    def __len__(self) -> int:
        return self.n // self.per_modality
