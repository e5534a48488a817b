"""Minimal batch loader over a trajectory fetch function.

Counterpart of ``enf_pde_tpu/data/loader.py``: yields ``(trajectories [b, T, *spatial,
C], coords, indices)`` batches with the same ``np.random.default_rng(seed)`` shuffle
(so its batch order equals the JAX loader's for one seed), drop-last and
``max_frames``. Batches are numpy arrays, or tensors on the loader's device once
``enable_device_cache`` is on.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["TrajectoryLoader"]


class TrajectoryLoader:
    """Batches of trajectories by id.

    Args:
        fetch: ``fetch(id) -> [T, *spatial, C]``.
        indices: the ids, in their unshuffled order.
        coords: the coordinate grid yielded with every batch.
        batch_size: signals per batch (at most ``len(indices)``); the last partial
            batch is dropped.
        shuffle / seed: reshuffle the ids every epoch with ``np.random.default_rng(seed)``.
        max_frames: keep only the first ``max_frames`` frames.
        batch_fetch: optional vectorized fetch, ``ids -> stacked trajectories``.
        device: where ``enable_device_cache`` keeps the trajectories.
    """

    def __init__(self, fetch: Callable[[int], np.ndarray], indices: Sequence[int],
                 coords: np.ndarray, batch_size: int, shuffle: bool = False, seed: int = 0,
                 max_frames: Optional[int] = None,
                 batch_fetch: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 device="cuda"):
        self.fetch = fetch
        self.batch_fetch = batch_fetch
        self.indices = np.asarray(list(indices))
        self.coords = np.asarray(coords)
        self.batch_size = min(batch_size, len(self.indices))
        self.shuffle = shuffle
        self.max_frames = max_frames
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self.device_cache = False
        self._dev_signals: dict = {}

    def __len__(self) -> int:
        return len(self.indices) // self.batch_size  # drop_last=True

    def _fetch(self, idx: int) -> np.ndarray:
        traj = self.fetch(int(idx))
        return traj if self.max_frames is None else traj[: self.max_frames]

    def enable_device_cache(self, max_bytes: int = 2 << 30) -> bool:
        """Keep the trajectories on the loader's device across epochs.

        Trajectories are static (the npz cache is immutable), so each is copied to the
        device once and batches are stacked there. Returns False, and stays off, when
        the whole set would exceed ``max_bytes``.
        """
        if self._fetch(self.indices[0]).nbytes * len(self.indices) > max_bytes:
            return False
        self.device_cache = True
        return True

    def _device_batch(self, ids) -> torch.Tensor:
        for i in ids:
            if int(i) not in self._dev_signals:
                self._dev_signals[int(i)] = torch.as_tensor(
                    np.ascontiguousarray(self._fetch(i)), dtype=torch.float32, device=self.device)
        return torch.stack([self._dev_signals[int(i)] for i in ids])

    def __iter__(self):
        order = self.indices.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        for b in range(len(self)):
            ids = order[b * self.batch_size : (b + 1) * self.batch_size]
            if self.device_cache:
                yield self._device_batch(ids), self.coords, ids
                continue
            if self.batch_fetch is not None:
                trajs = self.batch_fetch(ids)
            else:
                trajs = np.stack([self.fetch(int(i)) for i in ids])
            if self.max_frames is not None:
                trajs = trajs[:, : self.max_frames]
            yield trajs, self.coords, ids
