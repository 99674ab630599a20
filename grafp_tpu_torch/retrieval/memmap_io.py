"""Fingerprint-database memmap IO, bit-compatible with the reference (the
port's own copy of ``grafp_tpu.retrieval.memmap_io``, host-only numpy).

Format (reference eval.py:126-168, test_fp.py:108-158): float32 raw
binary at ``<dir>/<fname>.mm`` plus the (n, d) shape at
``<dir>/<fname>_shape.npy``. The loader scrubs NaNs to 0 in place, as the
reference does (eval.py:165) - silent segments NaN through the
reference's peak extractor.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def load_memmap_data(
    source_dir: str,
    fname: str,
    append_extra_length: Optional[int] = None,
    shape_only: bool = False,
    display: bool = True,
):
    """Same contract as reference eval.py:126-168."""
    path_shape = os.path.join(source_dir, fname + "_shape.npy")
    path_data = os.path.join(source_dir, fname + ".mm")
    data_shape = np.load(path_shape)
    if shape_only:
        return data_shape
    if append_extra_length:
        data_shape[0] += append_extra_length
    if int(data_shape[0]) == 0:
        # np.memmap would raise a cryptic "cannot mmap an empty file";
        # an empty db means the builder saw zero usable tracks (e.g. a
        # degenerate split at toy scale, or every track under the
        # silence threshold)
        raise ValueError(
            f"fingerprint db '{path_data}' is empty (0 rows) - the "
            f"builder produced no segments; check the dataset split "
            f"sizes and silence threshold")
    data = np.memmap(
        path_data, dtype="float32", mode="r+",
        shape=(int(data_shape[0]), int(data_shape[1])),
    )
    data[np.isnan(data)] = 0.0
    if display:
        print(f"Load {data_shape[0]:,} items from {path_data}.")
    return data, data_shape


def save_memmap(output_dir: str, fname: str, arr: np.ndarray) -> None:
    """Write <fname>.mm + <fname>_shape.npy (reference test_fp.py:108-125)."""
    os.makedirs(output_dir, exist_ok=True)
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    mm = np.memmap(
        os.path.join(output_dir, f"{fname}.mm"), dtype="float32",
        mode="w+", shape=arr.shape,
    )
    mm[:] = arr[:]
    mm.flush()
    del mm
    np.save(os.path.join(output_dir, f"{fname}_shape.npy"), arr.shape)


class MemmapWriter:
    """Streaming writer: append fingerprint blocks without holding the
    whole DB in RAM (the reference accumulates in a Python list,
    test_fp.py:127-148; a 31M-row fma_large DB is 16 GB)."""

    def __init__(self, output_dir: str, fname: str, dim: int, capacity: int):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{fname}.mm")
        self.shape_path = os.path.join(output_dir, f"{fname}_shape.npy")
        self.dim = dim
        self.capacity = capacity
        self.n = 0
        self._mm = np.memmap(
            self.path, dtype="float32", mode="w+", shape=(capacity, dim)
        )

    def _grow(self, need: int) -> None:
        new_cap = max(need, int(self.capacity * 1.5) + 1024)
        self._mm.flush()
        del self._mm
        with open(self.path, "r+b") as f:
            f.truncate(new_cap * self.dim * 4)
        self._mm = np.memmap(
            self.path, dtype="float32", mode="r+",
            shape=(new_cap, self.dim),
        )
        self.capacity = new_cap

    def append(self, block: np.ndarray) -> None:
        block = np.asarray(block, np.float32)
        if block.ndim != 2 or block.shape[1] != self.dim:
            raise ValueError(f"MemmapWriter: block {block.shape} for width {self.dim}")
        end = self.n + len(block)
        if end > self.capacity:
            # capacity is an estimate (track lengths vary); grow in place
            self._grow(end)
        self._mm[self.n:end] = block
        self.n = end

    def close(self) -> Tuple[int, int]:
        self._mm.flush()
        del self._mm
        # shrink file to the rows actually written
        if self.n < self.capacity:
            with open(self.path, "r+b") as f:
                f.truncate(self.n * self.dim * 4)
        np.save(self.shape_path, (self.n, self.dim))
        return self.n, self.dim
