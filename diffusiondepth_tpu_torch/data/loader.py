"""Batched, sharded, prefetching data loader (port of
``diffusiondepth_tpu/data/loader.py``).

Each host reads ``indices[host_index::host_count]``, the order is shuffled
per epoch with ``RandomState(seed + epoch)``, and each of the host's
``rank_count`` data-parallel ranks loads only its rows of each batch: its
slice of every micro-block of ``accum_steps`` (``parallel/mesh.py::
rank_rows``; a batch that does not divide over the ranks raises, as JAX's
placement of it on the mesh does). Samples decode on a thread pool, and
finished numpy batches wait in a queue ``prefetch`` deep so that host IO
overlaps the device's steps. A worker's error is raised in the consumer.

Each sample's augmentation seed comes from (epoch seed, dataset index), so
a run does not depend on thread scheduling, and it is the JAX loader's
seed for the same index: both packages draw the same augmentations.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from ..parallel.mesh import rank_rows


def _collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def sample_seed(seed: int, epoch: int, index: int) -> int:
    """The augmentation seed of dataset ``index`` in ``epoch``, inside
    RandomState's range."""
    epoch_seed = (seed + 1) * 1_000_003 + epoch
    return (epoch_seed * 7_919 + int(index)) % (2**31 - 1)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_threads: int = 4, prefetch: int = 2,
                 seed: int = 0, host_index: int = 0, host_count: int = 1,
                 rank_index: int = 0, rank_count: int = 1, accum_steps: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        self.rank_index = rank_index
        self.rank_count = rank_count
        self.accum_steps = accum_steps
        self.epoch = 0
        # seconds the producer spent on each batch of the last iteration
        # (decode, augmentation, collation; not the time blocked on a full
        # queue): the loader's own throughput
        self.load_s = []

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx[self.host_index::self.host_count]

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batches(self):
        """The dataset indices of each batch of this epoch that this rank
        loads, in order."""
        indices = self._indices()
        host = [indices[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]
        if self.rank_count == 1:
            return host
        return [b[rank_rows(len(b), self.accum_steps, self.rank_index, self.rank_count)]
                for b in host]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self.batches()
        try:
            takes_seed = "seed" in inspect.signature(self.dataset.__getitem__).parameters
        except (TypeError, ValueError):
            takes_seed = False

        def load_sample(gidx: int):
            if takes_seed:
                return self.dataset.__getitem__(
                    int(gidx), seed=sample_seed(self.seed, self.epoch, gidx))
            return self.dataset.__getitem__(int(gidx))

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        self.load_s = []

        def safe_put(item) -> bool:
            """A bounded put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        t0 = time.perf_counter()
                        batch = _collate(list(pool.map(load_sample, b)))
                        self.load_s.append(time.perf_counter() - t0)
                        if not safe_put(batch):
                            return
                safe_put(None)
            except BaseException as e:  # raised in the consumer
                safe_put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
