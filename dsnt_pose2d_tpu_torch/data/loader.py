"""Deterministic, prefetching batch loader and the host-to-device copy
(port of ``dsnt_pose2d_tpu/data/loader.py``, one host; the multi-host
split comes with data parallelism).

- **determinism / resume**: the permutation is a pure function of
  ``(seed, epoch)`` (numpy ``default_rng``, as the JAX package), and an
  epoch can start at any step, so a resumed run replays the same order;
- **fetch**: a thread pool of ``workers`` reads the samples (mmap reads and
  native decode release the GIL) and one background thread keeps a bounded
  queue of collated numpy batches;
- **to the card**: :func:`prefetch_to_device` (and :func:`prefetch_pairs`,
  which keeps the host batch beside the device one) pins each batch in the
  consumer's thread and starts its ``non_blocking`` copy ``depth`` batches
  ahead of the step that reads it.
"""

from __future__ import annotations

import queue
import threading
from collections import deque

import numpy as np
import torch


def _collate(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        out[k] = np.stack([s[k] for s in samples])
    return out


def to_device(batch: dict, device) -> dict:
    """A dict of numpy arrays as tensors on ``device``.  For a CUDA device
    each array is pinned and copied ``non_blocking``: the copy runs on the
    current stream, ordered before the step that reads it, and the pinned
    buffer is not reused before the copy has finished."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def stage_ahead(items, depth: int):
    """Yield ``items`` in order, each pulled from the iterator ``depth``
    items before the consumer takes it (pulling one starts its copy)."""
    queue_: deque = deque()
    for item in items:
        queue_.append(item)
        if len(queue_) > depth:
            yield queue_.popleft()
    while queue_:
        yield queue_.popleft()


def prefetch_to_device(batch_iter, device, depth: int = 2):
    """Keep ``depth`` batches on ``device`` ahead of the consumer.

    Each batch's host-to-device copy is started when it is queued, so it
    overlaps the steps that run before it is taken.  At most ``depth + 1``
    batches are held in pinned host memory at once.
    """
    return (dev for _, dev in prefetch_pairs(batch_iter, device, depth))


def prefetch_pairs(batch_iter, device, depth: int = 2):
    """Like :func:`prefetch_to_device` but yields ``(host, device)`` pairs:
    the eval pass also needs the host batch (sample renders), with the same
    host-to-device overlap."""
    return stage_ahead(((b, to_device(b, device)) for b in batch_iter), depth)


class ShardedLoader:
    """Batches of one epoch, in the order of a seeded permutation.

    With ``drop_last`` the tail that does not fill a batch is dropped (it
    rotates with the per-epoch shuffle); without it the last batch is padded
    to the full size by repeating its last sample, with the pad rows' mask
    zeroed, so every sample is seen once and masked metrics stay exact.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = max(1, workers)

    @property
    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, epoch)).permutation(n)
        return np.arange(n)

    def global_index_batches(self, epoch: int = 0) -> list[np.ndarray]:
        """Dataset indices of each batch of :meth:`epoch`; -1 marks pad rows.

        ``EvalDriver.predict`` scatters each batch's outputs back into
        dataset order through this map.
        """
        idx = self._epoch_indices(epoch)
        bs = self.batch_size
        out = []
        for step in range(self.steps_per_epoch):
            chunk = idx[step * bs:(step + 1) * bs]
            pad = bs - len(chunk)
            out.append(np.concatenate([chunk, np.full(pad, -1, chunk.dtype)])
                       if pad else chunk.copy())
        return out

    def epoch(self, epoch: int, start_step: int = 0):
        """Yield collated numpy batches for one epoch, from ``start_step``."""
        idx = self._epoch_indices(epoch)
        bs = self.batch_size
        starts = range(start_step * bs, len(idx) - (bs - 1 if self.drop_last else 0), bs)

        pool = None
        if self.workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=self.workers)

        def fetch(indices):
            if pool is not None:
                return list(pool.map(self.dataset.__getitem__,
                                     [int(i) for i in indices]))
            return [self.dataset[int(i)] for i in indices]

        def produce(q: queue.Queue):
            try:
                for s in starts:
                    chunk = idx[s:s + bs]
                    pad = bs - len(chunk)
                    samples = fetch(chunk)
                    batch = _collate(samples + [samples[-1]] * pad)
                    if pad and "mask" in batch:
                        batch["mask"] = batch["mask"].copy()
                        batch["mask"][bs - pad:] = 0.0
                    q.put(batch)
                q.put(None)
            except BaseException as e:  # handed to the consumer
                q.put(e)
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is None:
                break
            if isinstance(batch, BaseException):
                raise batch
            yield batch
