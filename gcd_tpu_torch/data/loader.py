"""The host input pipeline: collate, a threaded prefetching loader, and the
transfer of a batch to the card (port of gcd_tpu/data/loader.py:19-152).

Items are rendered on host threads (the native splat releases the GIL and
spreads each render over the cores with OpenMP), collated to numpy and
queued ahead of the training step; `batch_to_device` then copies a batch
from pinned memory. The shuffle order of epoch e is
np.random.default_rng((seed, e)), as in the JAX package, and the first batch
of an epoch is computed in the caller's thread before the workers start.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch


def collate_fn(example_list: List[Dict]) -> Dict:
    """Stack the examples, then merge batch and time: (B, T, ...) ->
    (B*T, ...). `image_only_indicator` (B, 1, T) becomes (B, T); per-example
    scalars stay (B,); `num_video_frames` is T."""
    out: Dict = {}
    for k in example_list[0].keys():
        stacked = np.stack([np.asarray(e[k]) for e in example_list])
        if stacked.ndim >= 2:
            b, t = stacked.shape[0], stacked.shape[1]
            if k == "image_only_indicator":
                out[k] = stacked.reshape(b, stacked.shape[-1]).astype(np.float32)
                continue
            out[k] = stacked.reshape((b * t,) + stacked.shape[2:])
        else:
            out[k] = stacked
    if "image_only_indicator" in out:
        out["num_video_frames"] = int(out["image_only_indicator"].shape[-1])
    return out


def batch_to_device(batch: Dict, device: Union[str, torch.device]) -> Dict:
    """numpy arrays -> tensors on `device`; to the card through pinned host
    memory, without blocking the host. Other values (num_video_frames) stay
    as they are."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        else:
            out[k] = v
    return out


# The JAX package's loader defaults: shuffle seed, batches queued ahead.
SHUFFLE_SEED = 0
PREFETCH = 2


class PrefetchLoader:
    """Iterates a map-style dataset in full batches (the last partial one is
    dropped), with worker threads and a prefetch queue. Each pass over it is
    one epoch.

    `process_shard` (process index, process count), set by a data-parallel
    run: `batch_size` stays the global batch, every process computes the
    same epoch order, and each loads and renders only its contiguous rows
    [p*B/P, (p+1)*B/P) of every batch (gcd_tpu/data/loader.py:54-76)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 2,
                 process_shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.process_shard = process_shard
        self._epoch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((SHUFFLE_SEED, self._epoch)).shuffle(order)
        self._epoch += 1
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.process_shard is not None:
            pid, nproc = self.process_shard
            if not 0 <= pid < nproc or self.batch_size % nproc:
                raise ValueError(f"process_shard {self.process_shard}: the global batch of "
                                 f"{self.batch_size} must split evenly over the processes")
            rows = self.batch_size // nproc
            batches = [b[pid * rows:(pid + 1) * rows] for b in batches]
        if not batches:
            return
        first_batch = collate_fn([self.dataset[int(i)] for i in batches[0]])

        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        idx_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches[1:], start=1):
            idx_q.put((bi, b))
        stop = threading.Event()
        results: Dict[int, Dict] = {}
        results_lock = threading.Lock()
        next_emit = [1]

        def emit(item) -> None:
            # Gives up once the consumer has gone, so that no worker waits
            # on a full queue for ever.
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = collate_fn([self.dataset[int(i)] for i in idxs])
                except Exception as e:  # surfaces in the consumer
                    batch = e
                with results_lock:
                    results[bi] = batch
                    while next_emit[0] in results:
                        emit(results.pop(next_emit[0]))
                        next_emit[0] += 1

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            yield first_batch
            for _ in range(len(batches) - 1):
                item = out_q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # A consumer that stops early waits for the batches in flight.
            stop.set()
            for t in threads:
                t.join()
