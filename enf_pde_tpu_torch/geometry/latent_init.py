"""Deterministic latent-pose initializers (cartesian, polar and ball).

Counterpart of ``enf_pde_tpu/geometry/latent_init.py``: a cell-centred grid over
[-1, 1]^d (``num_latents = k**d``), the orientations of SE(2) latents, a (phi, theta)
grid on the sphere with twice the resolution in longitude (``num_latents = 2 k**2``),
Fibonacci-lattice Euler angles on the ball at radius 0.75, and the window size that makes
neighbouring windows overlap.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["init_positions_grid", "init_positions_polar", "init_positions_ball",
           "init_orientations_grid", "default_gaussian_window_size"]


def _latents_per_dim(num_latents: int, num_dims: int) -> int:
    per_dim = round(num_latents ** (1.0 / num_dims), 5)
    if abs(per_dim % 1) > 1e-5:
        raise ValueError(
            f"num_latents ({num_latents}) must be a perfect {num_dims}-th power for grid init."
        )
    return int(round(per_dim))


def init_positions_grid(num_signals: int, num_latents: int, num_dims: int) -> torch.Tensor:
    """Uniform grid over [-1, 1]^d, cell-centered. Returns [num_signals, num_latents, d]."""
    k = _latents_per_dim(num_latents, num_dims)
    axis = np.linspace(-1 + 1 / k, 1 - 1 / k, k, dtype=np.float32)
    grids = np.meshgrid(*([axis] * num_dims), indexing="ij")
    pos = torch.from_numpy(np.stack(grids, axis=-1).reshape(-1, num_dims))
    return pos[None].repeat(num_signals, 1, 1)


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)``'s f32 formula: with s = i / (num - 1), start (1 - s)
    + stop s, the end point exact. Equal to JAX's values bit for bit at the shipped sizes
    (the polar grids of 2, 8, 18 and 32 latents); XLA may round a larger grid's interior
    points one unit in the last place apart."""
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start32])
    s = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    return np.append(start32 * (np.float32(1) - s) + stop32 * s, stop32)


def init_positions_polar(num_signals: int, num_latents: int, num_dims: int) -> torch.Tensor:
    """Spherical (phi, theta) grid, cell-centred, with twice the longitudinal resolution:
    ``num_latents = 2 k**2``. Returns [num_signals, num_latents, 2]."""
    k = _latents_per_dim(num_latents // 2, num_dims)
    grid_phi = _linspace_f32(np.pi / (2 * k), 2 * np.pi - np.pi / (2 * k), 2 * k)
    grid_theta = _linspace_f32((np.pi / 2) / k, np.pi - (np.pi / 2) / k, k)
    grids = np.meshgrid(grid_phi, grid_theta, indexing="ij")
    pos = torch.from_numpy(np.stack(grids, axis=-1).reshape(-1, num_dims))
    return pos[None].repeat(num_signals, 1, 1)


def init_positions_ball(num_signals: int, num_latents: int, num_dims: int) -> torch.Tensor:
    """Fibonacci-lattice Euler angles and a linear roll at radius 0.75, in f32: alpha =
    arccos(1 - 2 i / (n + 1)), beta = pi (1 + sqrt 5) i for i = 1..n, gamma = 2 pi k / n.
    Returns [num_signals, num_latents, 4] with columns (alpha, beta, gamma, r); ``num_dims``
    is unused (the poses are 4-wide), as in the JAX package."""
    idx = np.arange(1, num_latents + 1, dtype=np.float32)
    alpha = np.arccos(np.float32(1) - np.float32(2) * idx / np.float32(num_latents + 1))
    beta = np.float32(np.pi * (1 + 5**0.5)) * idx
    gamma = np.arange(0, 2 * np.pi, 2 * np.pi / num_latents, dtype=np.float32)
    radius = np.full(num_latents, 0.75, dtype=np.float32)
    pos = torch.from_numpy(np.stack([alpha, beta, gamma, radius], axis=-1))
    return pos[None].repeat(num_signals, 1, 1)


def init_orientations_grid(num_signals: int, num_latents: int) -> torch.Tensor:
    """Rotation-covariant orientations: arctan2 of the 2D grid position. Returns
    [num_signals, num_latents, 1]."""
    pos = init_positions_grid(num_signals, num_latents, 2)
    return torch.atan2(pos[:, :, 0], pos[:, :, 1])[:, :, None]


def default_gaussian_window_size(coordinate_system: str, num_latents: int, num_pos_dims: int) -> float:
    """Initial per-latent Gaussian window std such that neighbouring windows overlap."""
    if coordinate_system == "cartesian":
        return num_pos_dims / _latents_per_dim(num_latents, num_pos_dims)
    if coordinate_system == "polar":
        return float(num_pos_dims * np.pi / _latents_per_dim(num_latents // 2, num_pos_dims))
    if coordinate_system == "ball":
        return 1.0
    raise ValueError(f"Unknown coordinate system: {coordinate_system!r}")
