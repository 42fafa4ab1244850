"""Host-side batch loader for training: shuffled batches of concatenated
`BopDataset`s, collated in numpy, with a threaded prefetch or a process
pool.

Port of `suo_slam_tpu/data/loader.py`. Every sample's randomness is seeded
per (epoch, item) from the loader's stream (`BopDataset.sample_seeded`), so
batches are bit-equal to the JAX package's for the same seeds, whatever the
mode and the number of workers.

mode="process" (`--loader process`) collates whole batches in a pool of
spawned worker processes, for decoding and augmentation that must scale
past one interpreter. A worker imports numpy and the port's `data`, `kp`
and `core` modules only (the package's `__init__` imports nothing): it
never imports torch and never touches a card. A worker that dies raises
`BrokenProcessPool` in the consumer; there is no switch back to threads.
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .bop import collate

_MP_DATASETS = None  # a worker process's datasets (set by _mp_init)


def _mp_init(datasets_blob: bytes) -> None:
    global _MP_DATASETS
    _MP_DATASETS = pickle.loads(datasets_blob)


def _mp_load_batch(args):
    """Worker task: one collated batch, built in the worker (one pickle of
    the batch back)."""
    idx, cseed, item_seeds, truncate_obj = args
    samples = [_sample_seeded(_MP_DATASETS, int(i), int(s)) for i, s in zip(idx, item_seeds)]
    return collate(samples, truncate_obj=truncate_obj, seed=cseed)


def _mp_pid(_=None) -> int:
    return os.getpid()


def _sample_seeded(datasets, i, seed):
    for d in datasets:
        n = len(d)
        if i < n:
            return d.sample_seeded(i, seed)
        i -= n
    raise IndexError(i)


class ConcatLoader:
    """Shuffling batch loader over concatenated datasets. mode="thread":
    `workers` threads decode a batch's samples, a queue of `prefetch`
    batches runs ahead of the consumer; mode="process": `workers` spawned
    processes each collate whole batches, `workers + prefetch` in flight.
    workers=1 loads in line in either mode. `close()` ends the pool."""

    def __init__(self, datasets, batch_size, truncate_obj, seed=0, workers=4, prefetch=4,
                 mode="thread"):
        if mode not in ("thread", "process"):
            raise ValueError(f"loader mode {mode!r}")
        self.datasets = datasets
        self.lengths = [len(d) for d in datasets]
        self.total = sum(self.lengths)
        self.batch_size = batch_size
        self.truncate_obj = truncate_obj
        self.workers = max(1, int(workers))
        self.prefetch = max(1, int(prefetch))
        self.rng = np.random.default_rng(seed)
        self.mode = mode
        self._pool = None

    def __len__(self):
        return max(1, self.total // self.batch_size)

    def sample(self, i, seed):
        return _sample_seeded(self.datasets, i, seed)

    def _process_pool(self):
        """The worker pool, each process with its own copy of the datasets,
        started by a round of empty tasks before the first batch."""
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            pool = ProcessPoolExecutor(self.workers, mp_context=mp.get_context("spawn"),
                                       initializer=_mp_init,
                                       initargs=(pickle.dumps(self.datasets),))
            try:
                list(pool.map(_mp_pid, range(self.workers)))
            except BaseException:
                pool.shutdown(cancel_futures=True)
                raise
            self._pool = pool
        return self._pool

    def close(self):
        """End the worker processes (process mode); the next epoch starts
        a new pool."""
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

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
        if self.mode == "process":
            yield from self._processes(batches)
            return
        yield from self._threaded(batches)

    def _processes(self, batches):
        pool = self._process_pool()
        pending = [(idx, cseed, iseeds, self.truncate_obj) for idx, cseed, iseeds in batches]
        pending.reverse()
        futures = []
        try:
            while pending or futures:
                while pending and len(futures) < self.workers + self.prefetch:
                    futures.append(pool.submit(_mp_load_batch, pending.pop()))
                yield futures.pop(0).result()
        finally:
            for f in futures:  # the consumer left early: drop what is queued
                f.cancel()

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
