"""Planar heat-equation data (a point heat source on [-3, 3]^2, D = 0.1), on the card.

Counterpart of ``enf_pde_tpu/data/diffusion_plane.py`` (reference ``pdes.py:407-453``):
a heat source of random magnitude is inserted into one grid cell at a random location
(upper half-plane for the training split, lower half-plane for the test split: an
out-of-distribution initial condition), diffused with ``dt(u) = D lap(u)``, recorded
every 0.5 time units, frames 7..26 kept. The solution is analytic: the heat kernel
integrated over the source cell is a separable product of error-function differences,
with first-order method-of-images reflections for the no-flux boundaries.

The source is drawn with numpy's ``RandomState(seed)`` as in the JAX package, so a seed
gives the JAX package's trajectory to f32 rounding; the frames are computed with
``torch.special.erf`` on ``device``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["sample_source", "diffusion_frames", "generate_diffusion_trajectories"]

_SIZE = 64
_LO, _HI = -3.0, 3.0
_D = 0.1


def sample_source(seed: int, test: bool = False):
    """Heat-source location and magnitude ``(x, y, value)``: x in [-2, 2], y in [0, 2]
    (train) or [-2, 0] (test), value in [5, 5.5]."""
    rng = np.random.RandomState(seed)
    x = rng.rand() * 4 - 2
    y = rng.rand() * 2
    if test:
        y = -y
    value = rng.rand() * 0.5 + 5.0
    return float(x), float(y), float(value)


def diffusion_frames(sources: torch.Tensor, t_start: float, dt: float, num_frames: int,
                     size: int = _SIZE) -> torch.Tensor:
    """Heat-kernel frames [n, num_frames, size, size] for cell-seeded sources.

    Args:
        sources: [n, 3] rows ``(x0, y0, value)``, f32 on the device that computes.
    """
    dev = sources.device
    cell = (_HI - _LO) / size
    centers = _LO + cell * (torch.arange(size, device=dev, dtype=torch.float32) + 0.5)
    # Snap each source to the centre of its grid cell (py-pde inserts into the nearest cell).
    idx = torch.clamp(torch.floor((sources[:, :2] - _LO) / cell), 0, size - 1)
    cxy = _LO + cell * (idx + 0.5)  # [n, 2]
    ts = t_start + dt * torch.arange(num_frames, device=dev, dtype=torch.float32)
    s = torch.sqrt(4 * _D * ts)[None, :, None, None]  # [1, T, 1, 1]

    def k(center):  # [n, 2] -> [n, T, 2, size]: the 1D kernel over the cell, both axes
        c = center[:, None, :, None]
        a = (centers - (c - cell / 2)) / s
        b = (centers - (c + cell / 2)) / s
        return 0.5 * (torch.special.erf(a) - torch.special.erf(b))

    # First-order images across the no-flux walls at +-3 conserve the heat in the domain.
    u = k(cxy) + k(2 * _HI - cxy) + k(2 * _LO - cxy)
    field = u[:, :, 0, :, None] * u[:, :, 1, None, :]
    return sources[:, 2, None, None, None] * field / (cell * cell)


@torch.no_grad()
def generate_diffusion_trajectories(seeds: Sequence[int], test: bool = False, size: int = _SIZE,
                                    device="cuda") -> np.ndarray:
    """Trajectories [len(seeds), 20, size, size, 1] float32, frames at t = 3.5 + 0.5 k,
    k = 0..19 (the reference records every 0.5 from t = 0 and keeps frames 7..26)."""
    sources = torch.tensor([sample_source(int(s), test=test) for s in seeds],
                           dtype=torch.float32).reshape(-1, 3).to(device)
    frames = diffusion_frames(sources, t_start=3.5, dt=0.5, num_frames=20, size=size)
    return frames.cpu().numpy().astype(np.float32)[..., None]
