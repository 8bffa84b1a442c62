"""Per-host sharded, deterministic, prefetching batch loader and the
host-to-device copy (port of ``dsnt_pose2d_tpu/data/loader.py``).

- **per-host input sharding**: over ``num_hosts`` processes (one per card
  in the port) each enumerates only its stride of the (seeded, per-epoch
  permuted) index stream and loads its ``1/num_hosts`` share of every
  global batch, as the JAX package's loader does;
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
    """This host's batches of one epoch, in the order of a seeded permutation.

    ``global_batch_size`` rows make a step over all ``num_hosts`` hosts;
    host ``host_id`` loads ``local_batch_size = global_batch_size //
    num_hosts`` of them (``batch_size`` is that local size).  With
    ``drop_last`` the tail that does not fill a batch is dropped (it rotates
    with the per-epoch shuffle); without it the stream is padded so that
    every sample is seen once, the pad rows' mask zeroed, so masked metrics
    stay exact.
    """

    def __init__(self, dataset, global_batch_size: int, *, shuffle: bool,
                 seed: int = 0, num_hosts: int = 1, host_id: int = 0,
                 drop_last: bool = True, prefetch: int = 2, workers: int = 1):
        if global_batch_size % num_hosts:
            raise ValueError("global batch size must divide across hosts")
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // num_hosts
        self.shuffle = shuffle
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = max(1, workers)

    @property
    def batch_size(self) -> int:
        """The rows this host loads a step (``local_batch_size``)."""
        return self.local_batch_size

    @property
    def steps_per_epoch(self) -> int:
        if self.drop_last:
            return (len(self.dataset) // self.num_hosts) // self.local_batch_size
        per_host = -(-len(self.dataset) // self.num_hosts)
        return -(-per_host // self.local_batch_size)

    def _epoch_indices(self, epoch: int):
        return self._epoch_indices_for(epoch, self.host_id)

    def _epoch_indices_for(self, epoch: int, host_id: int):
        """(dataset indices, valid mask) of one host's epoch stream.

        Hosts enumerate streams of EQUAL length (unequal counts would run
        different numbers of collective steps and hang).  With ``drop_last``
        the permutation is cut to a common per-host length, and host ``h``
        takes every ``num_hosts``-th row from ``h``.  Without it the stream
        is padded UP by repeating the last index so that every sample is
        seen; the pad entries are marked invalid.
        """
        n = len(self.dataset)
        if self.shuffle:
            perm = np.random.default_rng((self.seed, epoch)).permutation(n)
        else:
            perm = np.arange(n)
        if self.drop_last:
            n_even = (n // self.num_hosts) * self.num_hosts
            idx = perm[:n_even][host_id::self.num_hosts]
            return idx, np.ones(len(idx), bool)
        n_pad = -(-n // self.num_hosts) * self.num_hosts
        if n_pad > n:
            perm = np.concatenate([perm, np.repeat(perm[-1:], n_pad - n)])
        pos = np.arange(host_id, n_pad, self.num_hosts)
        return perm[pos], pos < n

    def global_index_batches(self, epoch: int = 0) -> list[np.ndarray]:
        """Dataset indices of each GLOBAL batch of :meth:`epoch`; -1 marks
        pad rows.

        The row layout is the global batch's: host 0's local rows, then
        host 1's, and so on (:func:`..parallel.mesh.check_row_order`), so
        that ``EvalDriver.predict`` can scatter each gathered batch back
        into dataset order through this map.
        """
        streams = [self._epoch_indices_for(epoch, h)
                   for h in range(self.num_hosts)]
        bs = self.local_batch_size
        out = []
        for step in range(self.steps_per_epoch):
            rows = []
            for idx, valid in streams:
                chunk = idx[step * bs:(step + 1) * bs]
                g = np.where(valid[step * bs:(step + 1) * bs], chunk, -1)
                pad = bs - len(chunk)
                if pad:
                    g = np.concatenate([g, np.full(pad, -1, g.dtype)])
                rows.append(g)
            out.append(np.concatenate(rows))
        return out

    def epoch(self, epoch: int, start_step: int = 0):
        """Yield this host's collated numpy batches for one epoch, from
        ``start_step``."""
        idx, valid = self._epoch_indices(epoch)
        bs = self.local_batch_size
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
                    invalid = np.concatenate(
                        [~valid[s:s + bs], np.ones(pad, bool)])
                    if invalid.any() and "mask" in batch:
                        batch["mask"] = batch["mask"].copy()
                        batch["mask"][invalid] = 0.0
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
