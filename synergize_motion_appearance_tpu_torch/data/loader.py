"""Threaded batch loader (the port's copy of the JAX package's
data/loader.py, which replaces the reference's DataLoader and prefetchers,
data/prefetch_dataloader.py:63-125).

Worker threads pull the sampler's indices batch by batch, stack numpy
batches, and ``epoch_iter`` yields them in order while the workers run
ahead, so reading and decoding overlap the device's step.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np

from .sampler import EnlargedSampler


class BatchLoader:
    def __init__(self, dataset, batch_size: int, sampler: EnlargedSampler,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        return len(self.sampler) // self.batch_size

    def epoch_iter(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield the stacked batches of one epoch, in the sampler's
        order; a partial last batch is dropped."""
        self.sampler.set_epoch(epoch)
        indices = list(iter(self.sampler))
        n_batches = len(indices) // self.batch_size
        idx_q: "queue.Queue" = queue.Queue()
        for b in range(n_batches):
            idx_q.put(
                (b, indices[b * self.batch_size:(b + 1) * self.batch_size]))
        stop = threading.Event()
        results: Dict[int, Any] = {}
        results_cv = threading.Condition()

        def worker():
            while not stop.is_set():
                try:
                    b, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                samples = [self.dataset[i] for i in idxs]
                batch = {k: np.stack([s[k] for s in samples])
                         for k in samples[0]}
                with results_cv:
                    results[b] = batch
                    results_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for b in range(n_batches):
                with results_cv:
                    while b not in results:
                        results_cv.wait(timeout=60.0)
                    yield results.pop(b)
        finally:
            stop.set()


def infinite_batches(loader: BatchLoader, start_epoch: int = 0):
    """Endless (epoch, batch) stream across epochs."""
    if len(loader) == 0:
        raise ValueError(
            f"dataset yields {len(loader.sampler)} samples per epoch, "
            f"smaller than one batch of {loader.batch_size}: raise "
            "dataset_enlarge_ratio or lower batch_size_per_gpu (an empty "
            "epoch would otherwise spin forever)")
    epoch = start_epoch
    while True:
        for batch in loader.epoch_iter(epoch):
            yield epoch, batch
        epoch += 1
