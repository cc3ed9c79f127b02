"""Threaded data loader (counterpart of `ullava_tpu/data/loader.py`).

Seeded epoch shuffling, drop-last fixed batch size, a thread pool that
fetches the samples of a batch and a background thread that keeps
`prefetch` collated batches ready, so image decode overlaps the step.
With `device`, each collated numpy batch becomes torch tensors on that
device (through pinned host memory when it is the card), as the train
steps take them.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def _process_index_and_count():
    """This process's place among the data-parallel processes:
    `torch.distributed`'s rank and world size where it is initialised,
    else 0 of 1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def batch_to_device(batch, device: torch.device):
    """A collated numpy batch -> torch tensors on `device` (non-array
    values pass through). To the card through pinned memory, without
    blocking the host."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        elif t.device != device:
            t = t.to(device)
        out[k] = t
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = True,
        seed: int = 42,
        num_workers: int = 8,
        drop_last: bool = True,
        prefetch: int = 2,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        device=None,
    ):
        """batch_size is the per-process batch. With several processes
        each reads its own stripe of the seeded global order (the same
        epoch permutation everywhere). `device` None yields the numpy
        batches."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        if process_index is None or process_count is None:
            process_index, process_count = _process_index_and_count()
        self.process_index = process_index
        self.process_count = process_count
        self.device = None if device is None else torch.device(device)

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # Per-process stripe of the shared permutation.
        return idx[self.process_index :: self.process_count]

    def __iter__(self) -> Iterator:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator:
        """Iterate this epoch from batch `start_batch` on. The batches
        before it are never fetched: the permutation is seeded, so batch
        `i` is what a full iteration gives."""
        idx = self._indices()
        n_batches = len(self)
        batches = [
            idx[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(int(start_batch), n_batches)
        ]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def put(item) -> bool:
            while not stop.is_set():  # a consumer that stopped early takes nothing
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        batch = self.collate_fn(list(pool.map(self.dataset.__getitem__, b)))
                        if self.device is not None:
                            batch = batch_to_device(batch, self.device)
                        if not put(batch):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                failure.append(e)
            put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    if failure:
                        raise failure[0]
                    return
                yield item
        finally:
            stop.set()
