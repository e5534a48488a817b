"""Latent point sets as plain dicts of tensors.

Counterpart of ``enf_pde_tpu/models/latents.py``: latents are
``{'p_pos', 'a', 'gaussian_window'}``, every entry batch-leading, updated by plain
functions in the inner loop. The ``'p_ori'`` of oriented geometries is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from enf_pde_tpu_torch.geometry.latent_init import default_gaussian_window_size, init_positions_grid

__all__ = ["init_latents", "latents_to_pose", "tile_latents", "LatentParams"]

LatentParams = Dict[str, torch.Tensor]


def init_latents(
    num_signals: int,
    num_latents: int,
    latent_dim: int,
    num_pos_dims: int,
    num_ori_dims: int,
    coordinate_system: str = "cartesian",
    gaussian_window_size: Optional[float] = None,
) -> LatentParams:
    """Latents for ``num_signals`` signals: grid positions, unit contexts, and a window
    size that defaults (``None`` or negative) to the latent spacing."""
    if coordinate_system != "cartesian":
        raise NotImplementedError(
            f"Coordinate system {coordinate_system!r} is not ported yet; see ROADMAP.md."
        )
    if num_ori_dims > 0:
        raise NotImplementedError("Oriented latents are not ported yet; see ROADMAP.md.")
    if gaussian_window_size is None or gaussian_window_size <= 0:
        window = default_gaussian_window_size(coordinate_system, num_latents, num_pos_dims)
    else:
        window = float(gaussian_window_size)
    return {
        "p_pos": init_positions_grid(num_signals, num_latents, num_pos_dims),
        "a": torch.ones(num_signals, num_latents, latent_dim),
        "gaussian_window": torch.full((num_signals, num_latents, 1), window),
    }


def latents_to_pose(params: LatentParams) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assemble (p, a, gaussian_window) from the latent dict."""
    return params["p_pos"], params["a"], params["gaussian_window"]


def tile_latents(params: LatentParams, batch_size: int) -> LatentParams:
    """Broadcast shared (num_signals=1) meta latents over a batch (meta-SGD path)."""
    return {k: v.repeat_interleave(batch_size, dim=0) for k, v in params.items()}
