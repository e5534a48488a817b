"""Coordinate grids (counterpart of ``enf_pde_tpu/data/__init__.py``; the dataset
loaders are not ported yet)."""

from __future__ import annotations

import numpy as np

__all__ = ["planar_coords"]


def planar_coords(h: int, w: int, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """[-1, 1]^2 coordinate grid, flattened row-major to match frame flattening."""
    u = np.linspace(lo, hi, h)
    v = np.linspace(lo, hi, w)
    U, V = np.meshgrid(u, v, indexing="ij")
    return np.stack([U, V], axis=-1).reshape(-1, 2).astype(np.float32)
