"""EnlargedSampler (the reference's data/data_sampler.py:6-48; the port's
copy of the JAX package's data/sampler.py).

Enlarges the dataset virtually by ``ratio``, shuffles each epoch with
``np.random.RandomState(epoch).permutation`` (the JAX package's choice; the
reference's torch.randperm gives other sequences) and hands each replica
its strided share.
"""
from __future__ import annotations

import math
from typing import Iterator

import numpy as np


class EnlargedSampler:
    def __init__(self, num_samples: int, num_replicas: int, rank: int,
                 ratio: int = 1):
        self.dataset_len = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = math.ceil(num_samples * ratio / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        indices = np.random.RandomState(self.epoch).permutation(
            self.total_size).tolist()
        indices = indices[self.rank:self.total_size:self.num_replicas]
        return iter(idx % self.dataset_len for idx in indices)

    def __len__(self) -> int:
        return self.num_samples
