"""Sphere diffusion data: the heat equation on S^2 from a random Gaussian bump, on the card.

Counterpart of ``enf_pde_tpu/data/diffusion_sphere.py`` (reference ``pdes.py:461-551``,
Dedalus RK222 on a 128 x 64 sphere grid). The heat equation is diagonal in the
spherical-harmonic basis, so the evolution is exact:
``h_lm(t) = h_lm(0) exp(-D l (l+1) t)`` (``SphereGrid.diffuse``).

Frame times follow the reference's recorder: the initial condition, then every 10
solver steps of 0.5 starting after the first step, t in {0, 0.5, 5.5, 10.5, ...};
20 frames. The bump centres are drawn with numpy's ``RandomState`` as in the JAX
package, so a seed gives the JAX package's trajectory to f32 rounding; a block of
trajectories is computed at once on ``device``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from enf_pde_tpu_torch.data.sphere_harmonics import SphereGrid

__all__ = ["generate_sphere_diffusion_trajectories", "sphere_diffusion_grid", "reference_frame_times",
           "bump_centre"]

_NPHI, _NTHETA = 128, 64
_D = 0.01


def sphere_diffusion_grid(nphi: int = _NPHI, ntheta: int = _NTHETA, device="cuda") -> SphereGrid:
    return SphereGrid(nphi, ntheta, device=device)


def reference_frame_times(num_frames: int = 20, dt: float = 0.5, cadence: int = 10) -> np.ndarray:
    """Frame times of the reference recorder: IC, then t = dt * (1 + cadence * k)."""
    ts = [0.0] + [dt * (1 + cadence * k) for k in range(num_frames - 1)]
    return np.asarray(ts)


def bump_centre(seed: int):
    """The bump's ``(phi0, theta0)`` for a seed, drawn as the reference draws it:
    ``theta0 ~ U[0, 2 pi)`` and ``phi0 = arccos(1 - 2u)`` (the roles swapped,
    ``pdes.py:507-512``, kept for distributional parity)."""
    rng = np.random.RandomState(int(seed) % (2**31 - 1))
    theta0 = rng.rand() * 2 * np.pi
    phi0 = np.arccos(1 - 2 * rng.rand())
    return phi0, theta0


def _gauss_peaks(grid: SphereGrid, centres: np.ndarray, sigma: float = 0.25) -> torch.Tensor:
    """exp(-d^2 / 2 sigma^2), d the great-circle distance to each centre: [n, nphi, ntheta]
    in f32, the products in the JAX package's order."""
    f32 = dict(dtype=torch.float32, device=grid.device)
    phi = torch.tensor(grid.phi, **f32)[None, :, None]
    theta = torch.tensor(grid.theta, **f32)[None, None, :]
    phi0, theta0 = centres[:, 0], centres[:, 1]

    def col(v):  # a float64 factor per centre, rounded to f32 as JAX rounds a numpy scalar
        return torch.tensor(v, **f32)[:, None, None]

    cos_d = (
        torch.sin(theta) * torch.cos(phi) * col(np.sin(theta0)) * col(np.cos(phi0))
        + torch.sin(theta) * torch.sin(phi) * col(np.sin(theta0)) * col(np.sin(phi0))
        + torch.cos(theta) * col(np.cos(theta0))
    )
    d = torch.arccos(torch.clamp(cos_d, -1.0, 1.0))
    return torch.exp(-(d**2) / (2 * sigma**2))


@torch.no_grad()
def generate_sphere_diffusion_trajectories(seeds: Sequence[int], nphi: int = _NPHI, ntheta: int = _NTHETA,
                                           num_frames: int = 20, grid: SphereGrid | None = None,
                                           device="cuda") -> np.ndarray:
    """Trajectories [len(seeds), num_frames, nphi, ntheta, 1] float32, computed on the
    grid's device (``device`` when no grid is given)."""
    grid = grid or sphere_diffusion_grid(nphi, ntheta, device=device)
    centres = np.asarray([bump_centre(s) for s in seeds], dtype=np.float64).reshape(-1, 2)
    h0 = _gauss_peaks(grid, centres)
    frames = grid.diffuse(h0, _D, reference_frame_times(num_frames))  # [T, n, nphi, ntheta]
    return frames.transpose(0, 1).cpu().numpy().astype(np.float32)[..., None]
