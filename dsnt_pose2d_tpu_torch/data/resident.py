"""Device-resident splits: the packed arrays staged on the card once, each
batch gathered there from a vector of row indices
(port of ``dsnt_pose2d_tpu/data/resident.py``).

The streaming path copies every batch from the host (a 32-sample batch of
384-px uint8 canvases is 14 MB); the resident path copies the split once
and then only a ``(B,)`` index vector per step.

Over ``num_shards`` data-parallel ranks the split is laid out as the JAX
package lays it over a ``data`` mesh (``_stage_strided``): shard ``s``
holds dataset rows ``{s, s + d, s + 2d, ...}``, padded to a common length
by repeating its last valid row, and rank ``s`` stages only shard ``s``.
The per-epoch order of each shard is a pure function of ``(seed, epoch,
shard)``, so the index arrays are the JAX package's on a mesh of that size
(the ``(shards * B,)`` global layout, of which a rank takes block ``s``).
:class:`ResidentEvalData` stages the val split the same way for the
Trainer's epoch-end eval pass.
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


def resident_fits(dataset, device=DEFAULT_DEVICE, extra_nbytes: int = 0,
                  num_shards: int = 1) -> bool:
    """Whether one shard of the dataset (plus ``extra_nbytes`` of splits
    already resident, over the same shards) fits the budget of
    :func:`resident_budget_bytes`."""
    if resident_arrays(dataset) is None:
        return False
    per_device = (resident_nbytes(dataset) + extra_nbytes) // max(num_shards, 1)
    return per_device <= resident_budget_bytes(device)


def _strided_layout(n: int, d: int):
    """``(rows_per_shard, shard_valid)`` of the strided layout of ``n`` rows
    over ``d`` shards (the JAX package's ``_stage_strided``)."""
    if n < d:
        raise ValueError(f"dataset ({n}) smaller than the shard count ({d})")
    return -(-n // d), (n - np.arange(d) + d - 1) // d


def _stage_shard(arrays: dict, device: torch.device, shard: int, d: int,
                 rows_per_shard: int, valid: int) -> dict:
    """Shard ``shard``'s rows of every array on ``device``: dataset rows
    ``local * d + shard``, padded by repeating the shard's last valid row.
    One host copy of each array (``np.take``'s, which the tensor owns, so
    it is writable), then one copy to the device."""
    rows = np.minimum(np.arange(rows_per_shard), valid - 1) * d + shard
    return {k: torch.from_numpy(np.take(a, rows, axis=0)).to(device)
            for k, a in arrays.items()}


def _put(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device``, without waiting for the device:
    for a card, the copy is ``non_blocking`` from pinned memory."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _check_shards(global_batch_size: int, num_shards: int, shard: int):
    if global_batch_size % num_shards:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{num_shards} shards")
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} of {num_shards}")


class ResidentTrainData:
    """Epoch-index iterator + device-resident arrays for the train loop.

    ``resident`` maps each array name to this rank's shard (``shard`` of
    ``num_shards``) as one tensor on the device (uint8 canvases stay uint8
    until ``preprocess_batch``); :meth:`epoch` yields one int64 index
    tensor of the shard's ``global_batch_size // num_shards`` local row
    offsets per step, on the device.  ``nbytes`` is the whole split's.
    """

    def __init__(self, dataset, global_batch_size: int, device=DEFAULT_DEVICE,
                 *, seed: int = 0, num_shards: int = 1, shard: int = 0):
        arrays = resident_arrays(dataset)
        if arrays is None:
            raise ValueError("dataset is not array-backed; pack it first or "
                             "use the streaming loader")
        _check_shards(global_batch_size, num_shards, shard)
        self.device = resolve_device(device)
        self.seed = seed
        self.num_shards = num_shards
        self.shard = shard
        self.global_batch_size = global_batch_size
        self.shard_batch_size = global_batch_size // num_shards
        self.rows_per_shard, self.shard_valid = _strided_layout(
            len(dataset), num_shards)
        self.steps_per_epoch = int(self.shard_valid.min()) // self.shard_batch_size
        if self.steps_per_epoch < 1:
            raise ValueError(
                f"shards of {int(self.shard_valid.min())} rows cannot fill a "
                f"batch of {self.shard_batch_size}")
        self.resident = _stage_shard(arrays, self.device, shard, num_shards,
                                     self.rows_per_shard,
                                     int(self.shard_valid[shard]))
        self.nbytes = sum(a.nbytes for a in arrays.values())

    def dataset_row(self, shard: int, local: int) -> int:
        """Dataset row held at (shard, local offset) under the strided layout."""
        return int(local) * self.num_shards + int(shard)

    def _shard_stream(self, epoch: int, s: int) -> np.ndarray:
        """Shard ``s``'s ``(steps * batch,)`` local row offsets for one epoch."""
        rows = self.steps_per_epoch * self.shard_batch_size
        rng = np.random.default_rng((self.seed, epoch, s))
        return rng.permutation(int(self.shard_valid[s]))[:rows].astype(np.int64)

    def _shard_streams(self, epoch: int) -> np.ndarray:
        """(num_shards, steps * batch) local row offsets of every shard."""
        return np.stack([self._shard_stream(epoch, s)
                         for s in range(self.num_shards)])

    def _put_idx(self, host_idx: np.ndarray) -> torch.Tensor:
        return _put(host_idx, self.device)

    def epoch(self, epoch: int, start_step: int = 0):
        """Yield this shard's per-step ``(B,)`` device index vectors."""
        stream = self._shard_stream(epoch, self.shard)
        bs = self.shard_batch_size
        for step in range(start_step, self.steps_per_epoch):
            yield self._put_idx(stream[step * bs:(step + 1) * bs])

    def epoch_groups(self, epoch: int, k: int, start_step: int = 0):
        """This shard's steps in groups of ``k``: ``("multi", idx (k, B))``
        for each full group and ``("single", idx (B,))`` for each step of
        the ragged tail, as the JAX package's ``epoch_groups`` (whose
        ``(k, shards * B)`` blocks hold this shard's in column block
        ``shard``)."""
        stream = self._shard_stream(epoch, self.shard)
        bs = self.shard_batch_size
        step = start_step
        while step < self.steps_per_epoch:
            take = min(k, self.steps_per_epoch - step)
            block = stream[step * bs:(step + take) * bs].reshape(take, bs)
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
    masked loss nor the PCKh counts.  The shards' pad rows (the strided
    layout's) are invalid the same way.  Rank ``shard`` stages its shard and
    runs block ``shard`` of each step's ``(num_shards * B,)`` global
    arrays.
    """

    def __init__(self, dataset, global_batch_size: int, device=DEFAULT_DEVICE,
                 *, num_shards: int = 1, shard: int = 0):
        arrays = resident_arrays(dataset)
        if arrays is None:
            raise ValueError("dataset is not array-backed; pack it first or "
                             "use the streaming loader")
        if len(dataset) < 1:
            raise ValueError("empty val split")
        _check_shards(global_batch_size, num_shards, shard)
        self.device = resolve_device(device)
        self.num_shards = num_shards
        self.shard = shard
        self.global_batch_size = global_batch_size
        self.shard_batch_size = global_batch_size // num_shards
        self.rows_per_shard, self.shard_valid = _strided_layout(
            len(dataset), num_shards)
        self.steps_per_epoch = -(-self.rows_per_shard // self.shard_batch_size)
        self.resident = _stage_shard(arrays, self.device, shard, num_shards,
                                     self.rows_per_shard,
                                     int(self.shard_valid[shard]))
        self.nbytes = sum(a.nbytes for a in arrays.values())

    def _step_host_arrays(self, step: int):
        """Host ``(idx int32, valid float32)`` of one step in the global
        layout, each ``(num_shards * B,)``: shard ``s``'s rows in block
        ``s``."""
        bs = self.shard_batch_size
        local = np.arange(step * bs, (step + 1) * bs)
        idx = np.minimum(local, self.rows_per_shard - 1)
        idx = np.broadcast_to(idx, (self.num_shards, bs))
        valid = local[None, :] < self.shard_valid[:, None]
        return (np.ascontiguousarray(idx).reshape(-1).astype(np.int32),
                valid.reshape(-1).astype(np.float32))

    def host_rows(self, step: int) -> np.ndarray:
        """Dataset row of each global batch position of one step (pads
        repeat their shard's last valid row), for host-side sample
        renders."""
        bs = self.shard_batch_size
        local = np.arange(step * bs, (step + 1) * bs)
        shard = np.repeat(np.arange(self.num_shards), bs)
        local = np.tile(local, self.num_shards)
        clamped = np.minimum(local, self.shard_valid[shard] - 1)
        return (clamped * self.num_shards + shard).astype(np.int64)

    def _put_pair(self, idx: np.ndarray, valid: np.ndarray):
        """This shard's block of global ``(..., shards * B)`` arrays, on the
        device."""
        bs, lo = self.shard_batch_size, self.shard * self.shard_batch_size
        return (_put(idx[..., lo:lo + bs].astype(np.int64), self.device),
                _put(valid[..., lo:lo + bs], self.device))

    def epoch(self):
        """Yield this shard's per-step device ``(idx, valid)`` pairs; over
        all shards they cover the split."""
        for step in range(self.steps_per_epoch):
            yield self._put_pair(*self._step_host_arrays(step))

    def epoch_stacked(self):
        """This shard's whole epoch as ``(steps, B)`` device ``(idx, valid)``,
        the input of :func:`..train.loop.make_resident_eval_scan`."""
        pairs = [self._step_host_arrays(s) for s in range(self.steps_per_epoch)]
        return self._put_pair(np.stack([p[0] for p in pairs]),
                              np.stack([p[1] for p in pairs]))
