"""Datasets: generate on first touch, cache to disk, load as batches.

Counterpart of ``enf_pde_tpu/data/__init__.py``: ``get_dataloader(dataset_cfg) ->
(train_loader, test_loader)``, each yielding ``(traj [b, T, *spatial, C], coords,
indices)``; planar datasets use a [-1, 1]^2 grid, spherical ones the (phi, theta)
generation grid, the ball a (phi, theta, r) meshgrid. The solvers run on the card unless
the caller asks for the CPU. Every dataset of the JAX package's registry is ported
(``data/registry.py``). Batches that do not come from the device cache are read by the
native prefetcher (``data/native_loader.py``) from the cache's raw files.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from enf_pde_tpu_torch.data.cache import TrajectoryCache, test_seed
from enf_pde_tpu_torch.data.loader import TrajectoryLoader

__all__ = ["get_dataloader", "planar_coords", "angular_coords", "ball_coords", "TrajectoryLoader",
           "TrajectoryCache", "test_seed"]


def planar_coords(h: int, w: int, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """[-1, 1]^2 coordinate grid, flattened row-major to match frame flattening."""
    u = np.linspace(lo, hi, h)
    v = np.linspace(lo, hi, w)
    U, V = np.meshgrid(u, v, indexing="ij")
    return np.stack([U, V], axis=-1).reshape(-1, 2).astype(np.float32)


def angular_coords(phi: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """(phi, theta) pairs of a sphere grid, flattened longitude-major like its frames."""
    P, T = np.meshgrid(phi, theta, indexing="ij")
    return np.stack([P, T], axis=-1).reshape(-1, 2).astype(np.float32)


def ball_coords(nphi: int, ntheta: int, nr: int) -> np.ndarray:
    """(phi, theta, r) of the ball's output grid (uniform phi, uniform theta in (0, pi) from
    1e-3, r = linspace(0, 1)), flattened in the order of its frames [nphi, ntheta, nr]."""
    phi = np.linspace(0, 2 * np.pi, nphi, endpoint=False)
    theta = np.linspace(1e-3, np.pi, ntheta, endpoint=False)
    r = np.linspace(0, 1, nr)
    P, T, R = np.meshgrid(phi, theta, r, indexing="ij")
    return np.stack([P, T, R], axis=-1).reshape(-1, 3).astype(np.float32)


def _prefetched_batch_fetch(cache: TrajectoryCache, postprocess):
    """A loader's ``batch_fetch``: the batch's raw files through one ``NativePrefetcher``,
    built at the first batch, each trajectory then postprocessed as ``fetch`` does."""
    prefetcher = None

    def batch_fetch(ids):
        nonlocal prefetcher
        if prefetcher is None:
            from enf_pde_tpu_torch.data.native_loader import NativePrefetcher

            prefetcher = NativePrefetcher(num_threads=2)
        cache.ensure(ids)
        paths = [cache.ensure_raw(int(i)) for i in ids]
        block = prefetcher.load_batch(paths, cache.shape())
        return np.stack([postprocess(t) for t in block])

    return batch_fetch


def get_dataloader(dataset_cfg, device="cuda") -> Tuple[TrajectoryLoader, TrajectoryLoader]:
    """Train (shuffled, seed 0, ``n_frames_train`` frames) and test (in order) loaders
    over the caches under ``<dataset_cfg.path>/<cache_name>/{train,test}``; missing
    trajectories are generated on ``device``, which also holds the device cache. Each
    loader's ``batch_fetch`` is the native prefetcher, as the JAX package's."""
    from enf_pde_tpu_torch.data.registry import dataset_spec

    spec = dataset_spec(dataset_cfg.name, dataset_cfg, device=device)
    root = os.path.join(dataset_cfg.path, spec.cache_name)
    cache_tr = TrajectoryCache(os.path.join(root, "train"), spec.gen_train,
                               batch_size_gen=spec.batch_size_gen)
    cache_ts = TrajectoryCache(os.path.join(root, "test"), spec.gen_test,
                               batch_size_gen=spec.batch_size_gen)

    train = TrajectoryLoader(
        lambda i: spec.postprocess(cache_tr.get(i)),
        indices=range(dataset_cfg.num_signals_train),
        coords=spec.coords,
        batch_size=dataset_cfg.batch_size,
        shuffle=True,
        seed=0,
        max_frames=spec.n_frames_train,
        batch_fetch=_prefetched_batch_fetch(cache_tr, spec.postprocess),
        device=device,
    )
    test = TrajectoryLoader(
        lambda i: spec.postprocess(cache_ts.get(i)),
        indices=range(dataset_cfg.num_signals_test),
        coords=spec.coords,
        batch_size=dataset_cfg.batch_size,
        shuffle=False,
        seed=1,
        batch_fetch=_prefetched_batch_fetch(cache_ts, spec.postprocess),
        device=device,
    )
    # Pre-generation hooks: entry points generate every missing trajectory once at
    # startup, before training, rather than at a loader's first touch.
    train.ensure_all = lambda: cache_tr.ensure(train.indices)
    test.ensure_all = lambda: cache_ts.ensure(test.indices)
    return train, test
