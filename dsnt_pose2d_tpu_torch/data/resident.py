"""Device-resident train split: the packed arrays staged on the card once,
each batch gathered there from a vector of row indices
(port of ``dsnt_pose2d_tpu/data/resident.py``, one device).

The streaming path copies every batch from the host (a 32-sample batch of
384-px uint8 canvases is 14 MB); the resident path copies the split once
and then only a ``(B,)`` index vector per step.  The per-epoch order is a
pure function of ``(seed, epoch, shard)``, as in the JAX package; with one
device the strided shard layout is the identity and there is one shard, so
:meth:`ResidentTrainData.epoch` and :meth:`~ResidentTrainData.epoch_groups`
give the JAX package's index arrays on a 1-device mesh.
:class:`ResidentEvalData` stages the val split the same way for the
Trainer's epoch-end eval pass.  The sharded layout over several devices is
not ported yet (ROADMAP Queue 1, data parallel).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

BUDGET_SHARE = 0.7   # of the device's memory, for the 'auto' residency decision


def resident_budget_bytes(device=DEFAULT_DEVICE) -> int:
    """Memory budget for the resident split on ``device``.

    ``DSNT_RESIDENT_BUDGET_BYTES`` if set; else 70% of the card's memory
    (``torch.cuda.mem_get_info``), or of the host's for the CPU device.
    """
    env = os.environ.get("DSNT_RESIDENT_BUDGET_BYTES")
    if env is not None:
        return int(env)
    dev = resolve_device(device)
    if dev.type == "cuda":
        total = torch.cuda.mem_get_info(dev)[1]
    else:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return int(total * BUDGET_SHARE)


def resident_arrays(dataset) -> dict | None:
    """The dataset's full dict-of-arrays view, or None if unsupported.

    Supported sources are array-backed (an ``arrays`` dict) or packed-mmap
    (:class:`.pack.PackedDataset`): anything whose per-sample dict is a row
    slice of whole-split arrays.
    """
    if hasattr(dataset, "arrays"):
        return dict(dataset.arrays)
    if hasattr(dataset, "canvases") and hasattr(dataset, "meta"):
        return {"canvases": dataset.canvases, **dataset.meta}
    return None


def resident_nbytes(dataset) -> int:
    arrays = resident_arrays(dataset)
    return sum(a.nbytes for a in arrays.values()) if arrays else 0


def resident_fits(dataset, device=DEFAULT_DEVICE, extra_nbytes: int = 0) -> bool:
    """Whether the dataset (plus ``extra_nbytes`` already resident) fits the
    budget of :func:`resident_budget_bytes`."""
    if resident_arrays(dataset) is None:
        return False
    return resident_nbytes(dataset) + extra_nbytes <= resident_budget_bytes(device)


def _put(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device``, without waiting for the device:
    for a card, the copy is ``non_blocking`` from pinned memory."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class ResidentTrainData:
    """Epoch-index iterator + device-resident arrays for the train loop.

    ``resident`` maps each array name to one tensor on the device (uint8
    canvases stay uint8 until ``preprocess_batch``); :meth:`epoch` yields one
    int64 ``(B,)`` index tensor per step, on the device.
    """

    def __init__(self, dataset, batch_size: int, device=DEFAULT_DEVICE, *,
                 seed: int = 0):
        arrays = resident_arrays(dataset)
        if arrays is None:
            raise ValueError("dataset is not array-backed; pack it first or "
                             "use the streaming loader")
        self.device = resolve_device(device)
        self.seed = seed
        n = len(dataset)
        self.num_shards = 1
        self.shard_batch_size = batch_size
        self.shard_valid = np.array([n])     # real rows of each shard
        self.steps_per_epoch = n // batch_size
        if self.steps_per_epoch < 1:
            raise ValueError(f"{n} rows cannot fill a batch of {batch_size}")
        # One host copy of each array (np.array owns it, so the tensor is
        # writable), then one copy to the device.
        self.resident = {k: torch.from_numpy(np.array(a)).to(self.device)
                         for k, a in arrays.items()}
        self.nbytes = sum(a.nbytes for a in arrays.values())

    def dataset_row(self, shard: int, local: int) -> int:
        """Dataset row held at (shard, local offset) under the strided layout."""
        return int(local) * self.num_shards + int(shard)

    def _shard_streams(self, epoch: int) -> np.ndarray:
        """(num_shards, steps * batch) local row offsets for one epoch."""
        rows = self.steps_per_epoch * self.shard_batch_size
        out = np.empty((self.num_shards, rows), np.int64)
        for s in range(self.num_shards):
            rng = np.random.default_rng((self.seed, epoch, s))
            out[s] = rng.permutation(int(self.shard_valid[s]))[:rows]
        return out

    def _put_idx(self, host_idx: np.ndarray) -> torch.Tensor:
        return _put(host_idx, self.device)

    def epoch(self, epoch: int, start_step: int = 0):
        """Yield per-step ``(B,)`` device index vectors."""
        streams = self._shard_streams(epoch)
        bs = self.shard_batch_size
        for step in range(start_step, self.steps_per_epoch):
            yield self._put_idx(streams[:, step * bs:(step + 1) * bs].reshape(-1))

    def epoch_groups(self, epoch: int, k: int, start_step: int = 0):
        """The epoch's steps in groups of ``k``: ``("multi", idx (k, B))``
        for each full group and ``("single", idx (B,))`` for each step of
        the ragged tail, as the JAX package's ``epoch_groups``."""
        streams = self._shard_streams(epoch)
        bs = self.shard_batch_size
        step = start_step
        while step < self.steps_per_epoch:
            take = min(k, self.steps_per_epoch - step)
            block = streams[:, step * bs:(step + take) * bs]
            # (shards, take * bs) -> (take, shards * bs) batch layout
            block = block.reshape(self.num_shards, take, bs).transpose(1, 0, 2)
            block = block.reshape(take, -1)
            if take == k:
                yield "multi", self._put_idx(block)
            else:
                for i in range(take):
                    yield "single", self._put_idx(block[i])
            step += take


class ResidentEvalData:
    """Device-resident val split + a sequential index stream covering it.

    Every dataset row is evaluated exactly once, as with the streaming
    loader's ``drop_last=False``: the ragged last batch is padded by
    repeating the last row, and each step carries a ``(B,)`` ``valid``
    vector beside its ``(B,)`` row indices, which the resident eval step
    multiplies into the joint mask, so that pad rows count in neither the
    masked loss nor the PCKh counts.  One device: one shard of all rows,
    as the JAX package's layout on a 1-device mesh.
    """

    def __init__(self, dataset, batch_size: int, device=DEFAULT_DEVICE):
        arrays = resident_arrays(dataset)
        if arrays is None:
            raise ValueError("dataset is not array-backed; pack it first or "
                             "use the streaming loader")
        self.device = resolve_device(device)
        n = len(dataset)
        if n < 1:
            raise ValueError("empty val split")
        self.num_shards = 1
        self.shard_batch_size = batch_size
        self.rows_per_shard = n
        self.shard_valid = np.array([n])
        self.steps_per_epoch = -(-n // batch_size)
        self.resident = {k: torch.from_numpy(np.array(a)).to(self.device)
                         for k, a in arrays.items()}
        self.nbytes = sum(a.nbytes for a in arrays.values())

    def _step_host_arrays(self, step: int):
        """Host ``(idx int32, valid float32)`` of one step, each ``(B,)``."""
        bs = self.shard_batch_size
        local = np.arange(step * bs, (step + 1) * bs)
        idx = np.minimum(local, self.rows_per_shard - 1)
        idx = np.broadcast_to(idx, (self.num_shards, bs))
        valid = local[None, :] < self.shard_valid[:, None]
        return (np.ascontiguousarray(idx).reshape(-1).astype(np.int32),
                valid.reshape(-1).astype(np.float32))

    def host_rows(self, step: int) -> np.ndarray:
        """Dataset row of each batch position of one step (pads repeat the
        last valid row), for host-side sample renders."""
        bs = self.shard_batch_size
        local = np.arange(step * bs, (step + 1) * bs)
        shard = np.repeat(np.arange(self.num_shards), bs)
        local = np.tile(local, self.num_shards)
        clamped = np.minimum(local, self.shard_valid[shard] - 1)
        return (clamped * self.num_shards + shard).astype(np.int64)

    def _put_pair(self, idx: np.ndarray, valid: np.ndarray):
        return _put(idx.astype(np.int64), self.device), _put(valid, self.device)

    def epoch(self):
        """Yield per-step device ``(idx, valid)`` pairs covering the split."""
        for step in range(self.steps_per_epoch):
            yield self._put_pair(*self._step_host_arrays(step))

    def epoch_stacked(self):
        """The whole epoch's ``(idx, valid)`` as ``(steps, B)`` device
        tensors, the input of :func:`..train.loop.make_resident_eval_scan`."""
        pairs = [self._step_host_arrays(s) for s in range(self.steps_per_epoch)]
        return self._put_pair(np.stack([p[0] for p in pairs]),
                              np.stack([p[1] for p in pairs]))
