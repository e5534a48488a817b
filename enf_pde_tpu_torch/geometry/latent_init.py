"""Deterministic latent-pose initializers (cartesian only).

Counterpart of ``enf_pde_tpu/geometry/latent_init.py``: a cell-centred grid over
[-1, 1]^d (``num_latents = k**d``), the orientations of SE(2) latents, and the window
size that makes neighbouring windows overlap. The polar and ball geometries are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["init_positions_grid", "init_orientations_grid", "default_gaussian_window_size"]


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


def init_orientations_grid(num_signals: int, num_latents: int) -> torch.Tensor:
    """Rotation-covariant orientations: arctan2 of the 2D grid position. Returns
    [num_signals, num_latents, 1]."""
    pos = init_positions_grid(num_signals, num_latents, 2)
    return torch.atan2(pos[:, :, 0], pos[:, :, 1])[:, :, None]


def default_gaussian_window_size(coordinate_system: str, num_latents: int, num_pos_dims: int) -> float:
    """Initial per-latent Gaussian window std such that neighbouring windows overlap."""
    if coordinate_system == "cartesian":
        return num_pos_dims / _latents_per_dim(num_latents, num_pos_dims)
    raise NotImplementedError(
        f"Coordinate system {coordinate_system!r} is not ported yet; see ROADMAP.md."
    )
