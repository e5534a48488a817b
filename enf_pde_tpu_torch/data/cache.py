"""Generate-on-first-touch trajectory cache (npz files, one per trajectory).

Counterpart of ``enf_pde_tpu/data/cache.py``, in the same file format so that each
package reads the other's cache: ``traj_%06d.npz`` (key ``data``), its flat float32
``.raw`` companion (which the prefetcher, ``data/native_loader.py``, reads) and
``shape.json``. Missing trajectories are generated a whole block of ``batch_size_gen``
ids at a time, so the solver runs batched on the device.
A failed generation raises: there is no fallback to generation elsewhere.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Sequence

import numpy as np

__all__ = ["TrajectoryCache", "test_seed"]

_MAX_INT32 = np.iinfo(np.int32).max


def test_seed(index: int) -> int:
    """Seed-disjoint test split: ``max_int32 - index`` (reference ``pdes.py:273``)."""
    return _MAX_INT32 - index


class TrajectoryCache:
    """Disk cache of trajectories keyed by integer id.

    Args:
        root: cache directory.
        generate_batch: ``fn(ids: np.ndarray) -> array [len(ids), T, *spatial, C]``.
        batch_size_gen: how many trajectories to generate per solver invocation.
    """

    def __init__(self, root: str, generate_batch: Callable[[np.ndarray], np.ndarray],
                 batch_size_gen: int = 32):
        self.root = root
        self.generate_batch = generate_batch
        self.batch_size_gen = batch_size_gen
        os.makedirs(root, exist_ok=True)
        self._mem: dict[int, np.ndarray] = {}

    def path(self, idx: int) -> str:
        """The npz file of trajectory ``idx``."""
        return os.path.join(self.root, f"traj_{idx:06d}.npz")

    def raw_path(self, idx: int) -> str:
        """Flat float32 companion file (the native prefetchers of both packages read it)."""
        return os.path.join(self.root, f"traj_{idx:06d}.raw")

    def shape(self):
        """The shape of one trajectory, from ``shape.json`` (None before the first write)."""
        meta = os.path.join(self.root, "shape.json")
        if not os.path.exists(meta):
            return None
        with open(meta) as f:
            return tuple(json.load(f))

    def write(self, idx: int, traj) -> None:
        """Store trajectory ``idx``: the npz and its raw companion, each by a rename,
        and ``shape.json`` with the first trajectory."""
        arr = np.asarray(traj, dtype=np.float32)
        tmp = self.path(idx) + ".tmp.npz"
        np.savez_compressed(tmp, data=arr)
        os.replace(tmp, self.path(idx))
        self._write_raw(idx, arr)

    def _write_raw(self, idx: int, arr: np.ndarray) -> None:
        tmp_raw = f"{self.raw_path(idx)}.{os.getpid()}.tmp"
        arr.tofile(tmp_raw)
        os.replace(tmp_raw, self.raw_path(idx))
        meta = os.path.join(self.root, "shape.json")
        if not os.path.exists(meta):
            tmp_meta = f"{meta}.{os.getpid()}.tmp"
            with open(tmp_meta, "w") as f:
                json.dump(list(arr.shape), f)
            os.replace(tmp_meta, meta)

    def ensure_raw(self, idx: int) -> str:
        """The raw companion's path of trajectory ``idx``, written from its npz first
        when it is missing (a cache filled without companions)."""
        if not os.path.exists(self.raw_path(idx)):
            self._write_raw(idx, np.asarray(self.get(idx), dtype=np.float32))
        return self.raw_path(idx)

    def get(self, idx: int) -> np.ndarray:
        if idx in self._mem:
            return self._mem[idx]
        path = self.path(idx)
        if not os.path.exists(path):
            self._generate_block(idx)
        data = np.load(path)["data"]
        self._mem[idx] = data
        return data

    def _generate_block(self, idx: int):
        """Generate the missing trajectories of the aligned block containing ``idx``."""
        start = (idx // self.batch_size_gen) * self.batch_size_gen
        ids = np.arange(start, start + self.batch_size_gen)
        missing = [i for i in ids if not os.path.exists(self.path(i))]
        if not missing:
            return
        block = self.generate_batch(np.asarray(missing))
        for i, traj in zip(missing, block):
            self.write(i, traj)

    def ensure(self, ids: Sequence[int]):
        for i in ids:
            if not os.path.exists(self.path(i)):
                self._generate_block(i)
