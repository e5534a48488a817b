"""Latent point sets as plain dicts of tensors.

Counterpart of ``enf_pde_tpu/models/latents.py``: latents are
``{'p_pos', ['p_ori'], 'a', 'gaussian_window'}``, every entry batch-leading, updated by
plain functions in the inner loop. ``p_ori`` is the raw angle of an SE(2) latent
(``ponita``); the decoder and PONITA see it only through its cosine and sine.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from enf_pde_tpu_torch.geometry.latent_init import (
    default_gaussian_window_size,
    init_orientations_grid,
    init_positions_ball,
    init_positions_grid,
    init_positions_polar,
)

__all__ = ["init_latents", "latents_to_pose", "gather_latents", "tile_latents", "LatentParams"]

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
    """Latents for ``num_signals`` signals: grid positions (cartesian, a (phi, theta) grid
    on the sphere for ``polar``, Fibonacci Euler angles and a radius for ``ball``), with ``num_ori_dims`` > 0 their orientations (2D
    only), unit contexts, and a window size that defaults (``None`` or negative) to the
    latent spacing."""
    if coordinate_system == "cartesian":
        p_pos = init_positions_grid(num_signals, num_latents, num_pos_dims)
    elif coordinate_system == "polar":
        p_pos = init_positions_polar(num_signals, num_latents, num_pos_dims)
    elif coordinate_system == "ball":
        p_pos = init_positions_ball(num_signals, num_latents, num_pos_dims)
    else:
        raise ValueError(f"Unknown coordinate system: {coordinate_system!r}")
    params: LatentParams = {"p_pos": p_pos}
    if num_ori_dims > 0:
        if num_pos_dims != 2:
            raise ValueError("Orientation latents are only supported in 2D.")
        params["p_ori"] = init_orientations_grid(num_signals, num_latents)
    if gaussian_window_size is None or gaussian_window_size <= 0:
        window = default_gaussian_window_size(coordinate_system, num_latents, num_pos_dims)
    else:
        window = float(gaussian_window_size)
    params["a"] = torch.ones(num_signals, num_latents, latent_dim)
    params["gaussian_window"] = torch.full((num_signals, num_latents, 1), window)
    return params


def latents_to_pose(params: LatentParams) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assemble (p, a, gaussian_window) from the latent dict; p is [.., pos (+ angle)]."""
    p = params["p_pos"]
    if "p_ori" in params:
        p = torch.cat([p, params["p_ori"]], dim=-1)
    return p, params["a"], params["gaussian_window"]


def gather_latents(params: LatentParams, idx) -> LatentParams:
    """Select per-signal latents (rows of a table) by trajectory index (autodecoding path)."""
    idx = torch.as_tensor(idx, dtype=torch.long, device=params["a"].device)
    return {k: v[idx] for k, v in params.items()}


def tile_latents(params: LatentParams, batch_size: int) -> LatentParams:
    """Broadcast shared (num_signals=1) meta latents over a batch (meta-SGD path)."""
    return {k: v.repeat_interleave(batch_size, dim=0) for k, v in params.items()}
