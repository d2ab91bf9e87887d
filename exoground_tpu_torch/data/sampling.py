"""Sharded index samplers + curriculum schedules.

A copy of ``exoground_tpu/data/sampling.py`` (the port imports nothing of
the JAX package): the replacement for torch DistributedSampler /
CurriculumDistributedSampler (reference train/main_egoexo4d_distributed.py:
37-103), sharding indices by (num_shards, shard). On one card the shard
count is 1 and the shard index 0.

Semantics preserved exactly from the reference:
  * deterministic shuffle from (seed + epoch)
  * pad-with-wraparound so every shard gets the same number of samples
  * curriculum subset: first ``curriculum_progress * len(dataset)`` indices,
    progress = clamp(start_frac + epoch/(max_epochs*end_frac)*end_frac, ..1)
  * phased curricula via get_phase (reference :92-103)
"""

from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np


class ShardedSampler:
    """DistributedSampler parity: shuffle, pad to divisible, stride-subsample."""

    def __init__(
        self,
        dataset_len: int,
        num_shards: int = 1,
        shard: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} outside [0, {num_shards})")
        self.dataset_len = dataset_len
        self.num_shards = num_shards
        self.shard = shard
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _base_indices(self) -> List[int]:
        n = self.dataset_len
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            return list(rng.permutation(n))
        return list(range(n))

    def _pad_and_shard(self, indices: List[int]) -> List[int]:
        if self.drop_last:
            per = len(indices) // self.num_shards
            total = per * self.num_shards
            indices = indices[:total]
        else:
            per = int(math.ceil(len(indices) / self.num_shards))
            total = per * self.num_shards
            pad = total - len(indices)
            if pad > 0:
                reps = int(math.ceil(pad / max(len(indices), 1)))
                indices = indices + (indices * reps)[:pad]
        # stride subsample: rank r takes indices[r::num_shards]
        # (reference main_egoexo4d_distributed.py:77)
        return indices[self.shard :: self.num_shards]

    def __len__(self) -> int:
        if self.drop_last:
            return self.dataset_len // self.num_shards
        return int(math.ceil(self.dataset_len / self.num_shards))

    def __iter__(self) -> Iterator[int]:
        return iter(self._pad_and_shard(self._base_indices()))


class CurriculumShardedSampler(ShardedSampler):
    """Curriculum variant (reference :37-84): the dataset is pre-sorted
    easy->hard (e.g. by cam_ego_distance, loader_egoexo4d.py:155-159); each
    epoch exposes a growing prefix, then shuffles within it.

    NOTE the reference shuffles *positions* of the prefix (randperm over the
    subset length) — reproduced here.
    """

    def __init__(
        self,
        dataset_len: int,
        num_shards: int = 1,
        shard: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        max_epochs: int = 100,
        start_frac: float = 0.50,
        end_epoch_frac: float = 0.75,
        fixed_ramp: bool = False,
    ):
        super().__init__(dataset_len, num_shards, shard, shuffle, seed)
        self.max_epochs = max_epochs
        self.start_frac = start_frac
        self.end_epoch_frac = end_epoch_frac
        self.fixed_ramp = fixed_ramp

    def curriculum_progress(self) -> float:
        # Default: formula-exact parity with the reference
        # (main_egoexo4d_distributed.py:48). NOTE the reference's expression
        # algebraically cancels end_epoch_frac — progress is always
        # start_frac + epoch/max_epochs, reaching 1.0 after
        # (1-start_frac)*max_epochs epochs regardless of --end_epoch_frac.
        # Reproduced as-is because it changes which samples train at which
        # epoch (a behavioral surface, unlike the unreachable reference bugs
        # we fix). ``fixed_ramp=True`` (our --fixed_curriculum switch, default
        # off) uses the presumably-intended ramp: linear from start_frac to
        # 1.0 at end_epoch_frac*max_epochs.
        if self.fixed_ramp:
            p = self.start_frac + (
                self.epoch / (self.max_epochs * self.end_epoch_frac)
            ) * (1.0 - self.start_frac)
        else:
            p = self.start_frac + (
                self.epoch / (self.max_epochs * self.end_epoch_frac)
            ) * self.end_epoch_frac
        return max(self.start_frac, min(1.0, p))

    def _base_indices(self) -> List[int]:
        num = int(self.curriculum_progress() * self.dataset_len)
        indices = list(range(self.dataset_len))[:num]
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            indices = list(rng.permutation(len(indices)))
        # pad with wraparound up to the FULL dataset's total_size so epoch
        # length (and the warmup-cosine schedule built from it) stays
        # constant across curriculum phases (reference
        # main_egoexo4d_distributed.py:62-74 pads to the inherited total_size)
        total = self.num_shards * int(math.ceil(self.dataset_len / self.num_shards))
        pad = total - len(indices)
        if pad > 0 and indices:
            reps = int(math.ceil(pad / len(indices)))
            indices = indices + (indices * reps)[:pad]
        return indices

    def __len__(self) -> int:
        return int(math.ceil(self.dataset_len / self.num_shards))


def get_phase(
    epoch: int, total_epochs: int, num_phases: int, final_phase_proportion: float
) -> int:
    """Phased-curriculum phase index (reference :92-103): equal-length early
    phases, one long final phase of ``final_phase_proportion`` epochs."""
    final_len = int(total_epochs * final_phase_proportion)
    other_len = (total_epochs - final_len) // max(num_phases - 1, 1)
    if epoch < (total_epochs - final_len):
        return epoch // max(other_len, 1)
    return num_phases - 1


def batched(indices: Iterator[int], batch_size: int, drop_last: bool = True):
    """Group an index stream into fixed-size batches (static shapes)."""
    buf: List[int] = []
    for i in indices:
        buf.append(i)
        if len(buf) == batch_size:
            yield list(buf)
            buf.clear()
    if buf and not drop_last:
        yield list(buf)
