"""Host-side batch loader for training: shuffled batches of concatenated
`BopDataset`s, collated in numpy, with a threaded prefetch.

Port of `suo_slam_tpu/data/loader.py:46-228` in its thread mode. Every
sample's randomness is seeded per (epoch, item) from the loader's stream
(`BopDataset.sample_seeded`), so batches are bit-equal to the JAX package's
for the same seeds, whatever the number of worker threads. The process-pool
tier (`--loader process`) is ROADMAP A23; the training CLI refuses it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .bop import collate


def _sample_seeded(datasets, i, seed):
    for d in datasets:
        n = len(d)
        if i < n:
            return d.sample_seeded(i, seed)
        i -= n
    raise IndexError(i)


class ConcatLoader:
    """Shuffling batch loader over concatenated datasets: `workers` threads
    decode a batch's samples, a queue of `prefetch` batches runs ahead of
    the consumer (workers=1 loads in line)."""

    def __init__(self, datasets, batch_size, truncate_obj, seed=0, workers=4, prefetch=4):
        self.datasets = datasets
        self.lengths = [len(d) for d in datasets]
        self.total = sum(self.lengths)
        self.batch_size = batch_size
        self.truncate_obj = truncate_obj
        self.workers = max(1, int(workers))
        self.prefetch = max(1, int(prefetch))
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return max(1, self.total // self.batch_size)

    def sample(self, i, seed):
        return _sample_seeded(self.datasets, i, seed)

    def epoch(self, shuffle=True, seed=None):
        """One epoch of collated batches. `seed`: draw this epoch's shuffle,
        collate and item seeds from a local rng(seed) instead of the
        advancing loader stream (the validation epoch's fixed batches)."""
        rng = self.rng if seed is None else np.random.default_rng(seed)
        order = np.arange(self.total)
        if shuffle:
            rng.shuffle(order)
        batches = [
            (order[b * self.batch_size:(b + 1) * self.batch_size], int(rng.integers(2 ** 31)),
             rng.integers(2 ** 31, size=self.batch_size))
            for b in range(len(self))
        ]
        if self.workers == 1:
            for idx, cseed, iseeds in batches:
                samples = [self.sample(int(i), int(s)) for i, s in zip(idx, iseeds)]
                yield collate(samples, truncate_obj=self.truncate_obj, seed=cseed)
            return
        yield from self._threaded(batches)

    def _threaded(self, batches):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put(item):
            # gives up when the consumer left the epoch early
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.workers) as ex:
                    for idx, cseed, iseeds in batches:
                        if stop.is_set():
                            return
                        samples = list(ex.map(lambda a: self.sample(int(a[0]), int(a[1])),
                                              zip(idx, iseeds)))
                        if not put(collate(samples, truncate_obj=self.truncate_obj,
                                           seed=cseed)):
                            return
                put(done)
            except BaseException as e:  # raised in the consumer
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
