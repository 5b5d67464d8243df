"""Threaded prefetching data loader (port of lavie_tpu.data.loader: the
same seeded shuffle order, None-sample skipping, drop_last and collate, so
its batches equal the JAX loader's).

Replaces torch.utils.data.DataLoader (reference: fine_tuning.py:316-317) with
a host-side thread pool that decodes/transforms ahead of the accelerator:
worker threads fill a bounded queue of collated numpy batches, the training
loop pops ready batches in order, so IO and decoding overlap with the
step.

None samples (decode failures) are dropped, mirroring the reference's
custom_collate filtering (reference: fine_tuning.py:177-181).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 2,
        prefetch: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        collate_fn: Callable = default_collate,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1

        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        work: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()
        done: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        for bi, b in enumerate(batches):
            work.put((bi, b))
        for _ in range(self.num_workers):
            work.put(None)

        results: Dict[int, Any] = {}
        lock = threading.Lock()

        def worker():
            while True:
                item = work.get()
                if item is None:
                    done.put(None)
                    return
                bi, idxs = item
                samples = [self.dataset[int(i)] for i in idxs]
                samples = [s for s in samples if s is not None]
                batch = self.collate_fn(samples) if samples else None
                done.put((bi, batch))

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        finished_workers = 0
        next_bi = 0
        try:
            while finished_workers < self.num_workers or results:
                if next_bi in results:
                    batch = results.pop(next_bi)
                    next_bi += 1
                    if batch is not None:
                        yield batch
                    continue
                item = done.get()
                if item is None:
                    finished_workers += 1
                    continue
                bi, batch = item
                with lock:
                    results[bi] = batch
        finally:
            for t in threads:
                t.join(timeout=0.1)
