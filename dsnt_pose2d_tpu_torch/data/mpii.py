"""In-memory datasets (port of ``dsnt_pose2d_tpu/data/mpii.py``, the
array-backed dataset only).

:class:`ArrayDataset` serves a dict of whole-split arrays row by row: the
synthetic fixture or a split already in memory.  The decoding MPII reader
(``MPIIDataset``) is not ported yet (ROADMAP Queue 1, host data).
"""

from __future__ import annotations


class ArrayDataset:
    """In-memory dict-of-arrays dataset (synthetic fixture or packed MPII)."""

    def __init__(self, arrays: dict):
        self.arrays = arrays
        self._n = len(next(iter(arrays.values())))

    def __len__(self):
        return self._n

    def __getitem__(self, i: int) -> dict:
        return {k: v[i] for k, v in self.arrays.items()}
