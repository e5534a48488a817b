"""Pseudo-spectral 2D Navier-Stokes (vorticity form) on the torus, with ``torch.fft``.

Counterpart of ``enf_pde_tpu/data/navier_stokes.py`` (reference
``experiments/fitting/datasets/pdes.py:186-303``): forced incompressible flow in
vorticity form, Crank-Nicolson diffusion and explicit 2/3-dealiased advection, in
complex64 on whatever device the initial field lives on, so the trajectories are
generated on the card. Physics as the JAX package's: 64^2 grid on [0,1]^2, viscosity
1e-3, forcing ``0.3 (cos(4 pi x) + cos(4 pi y))``, initial fields from a Gaussian
random field (alpha 2.5, tau 7) burned in for 30 time units, one frame per time unit.

Each trajectory's Gaussian coefficients come from a CPU ``torch.Generator`` seeded by
the trajectory's seed, so one seed gives one initial field on the CPU and on the card.
The PRNG streams of JAX and torch differ, so the two packages' datasets are equally
valid draws, not the same draws. ``split_fft=True`` runs the JAX package's complex-free
path instead (``navier_stokes_rollout_split``): the same physics with every transform a
pair of real matmuls (``data/splitfft.py``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from enf_pde_tpu_torch.data.splitfft import dft_matrices, fft2_real_input, ifft2_real_output

__all__ = [
    "GaussianRF2D",
    "default_forcing",
    "navier_stokes_rollout",
    "navier_stokes_rollout_split",
    "generate_ns_trajectories",
]


class GaussianRF2D:
    """Gaussian random field sampler with spectral density ~ (4 pi^2 |k|^2 + tau^2)^-alpha."""

    def __init__(self, size: int, alpha: float = 2.5, tau: float = 7.0, sigma: float | None = None):
        self.size = size
        if sigma is None:
            sigma = tau ** (0.5 * (2 * alpha - 2.0))
        k = torch.cat([torch.arange(0, size // 2), torch.arange(-(size // 2), 0)])
        kx, ky = k[:, None], k[None, :]
        sqrt_eig = (
            (size**2) * torch.sqrt(torch.tensor(2.0)) * sigma
            * ((4 * math.pi**2 * (kx**2 + ky**2) + tau**2) ** (-alpha / 2.0))
        )
        sqrt_eig[0, 0] = 0.0
        self.sqrt_eig = sqrt_eig.float()

    def coefficients(self, seed: int) -> torch.Tensor:
        """One field's standard complex Gaussian coefficients ``N + iN`` [size, size],
        drawn on the CPU from ``seed`` (real parts first)."""
        gen = torch.Generator().manual_seed(int(seed))
        shape = (self.size, self.size)
        re = torch.randn(shape, generator=gen)
        return torch.complex(re, torch.randn(shape, generator=gen))

    def field(self, coeff: torch.Tensor) -> torch.Tensor:
        """Fields [..., size, size] from coefficients: ``ifft2(sqrt_eig * coeff).real``."""
        return torch.fft.ifftn(self.sqrt_eig.to(coeff.device) * coeff, dim=(-2, -1)).real

    def sample(self, seeds: Sequence[int], device="cuda") -> torch.Tensor:
        """One field per seed, [len(seeds), size, size] on ``device``."""
        coeff = torch.stack([self.coefficients(s) for s in seeds]).to(device)
        return self.field(coeff)

    def sample_split(self, seeds: Sequence[int], device="cuda") -> torch.Tensor:
        """``sample`` without complex arithmetic on the device: the same coefficients,
        inverted with the split DFT (``splitfft.ifft2_real_output``); equal to
        ``sample`` to f32 rounding."""
        coeff = torch.stack([self.coefficients(s) for s in seeds])
        eig = self.sqrt_eig
        re, im = (eig * coeff.real).to(device), (eig * coeff.imag).to(device)
        C, S = dft_matrices(self.size, re.dtype, device)
        return ifft2_real_output(re, im, C, S)


def default_forcing(size: int, device="cuda") -> torch.Tensor:
    """Kolmogorov-type forcing 0.3 (cos(4 pi x) + cos(4 pi y)) on [0,1)^2."""
    t = torch.linspace(0, 1, size + 1)[:-1]
    X, Y = torch.meshgrid(t, t, indexing="ij")
    return (0.3 * (torch.cos(4 * math.pi * X) + torch.cos(4 * math.pi * Y))).to(device)


@torch.no_grad()
def navier_stokes_rollout(w0: torch.Tensor, f: torch.Tensor, visc: float, delta_t: float,
                          record_steps: int, steps_per_record: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integrate batched vorticity fields and record snapshots.

    Args:
        w0: initial vorticity [batch, N, N] (f32, on the device that integrates).
        f: forcing [N, N].
        visc: kinematic viscosity.
        delta_t: solver step size.
        record_steps: number of recorded snapshots.
        steps_per_record: solver steps between snapshots.

    Returns:
        ``(snapshots [batch, record_steps, N, N], w_final [batch, N, N])``. Each
        snapshot is taken *before* its stretch of ``steps_per_record`` steps, so the
        first one is the initial state.
    """
    N, dev = w0.shape[-1], w0.device
    k_max = N // 2
    k = torch.cat([torch.arange(0, k_max), torch.arange(-k_max, 0)]).to(dev)
    k_y = k[None, :].expand(N, N)
    k_x = k_y.T
    lap = 4 * math.pi**2 * (k_x**2 + k_y**2)
    lap[0, 0] = 1.0
    dealias = ((k_y.abs() <= (2.0 / 3.0) * k_max) & (k_x.abs() <= (2.0 / 3.0) * k_max)).float()

    w_h = torch.fft.fftn(w0, dim=(-2, -1))
    f_h = torch.fft.fftn(f.to(dev))
    two_pi_i_kx, two_pi_i_ky = 2j * math.pi * k_x, 2j * math.pi * k_y
    # u = dpsi/dy, v = -dpsi/dx with psi = w / lap, then w_x and w_y: one stacked
    # multiplier and one batched inverse transform for the four fields.
    deriv = torch.stack([two_pi_i_ky / lap, -two_pi_i_kx / lap, two_pi_i_kx, two_pi_i_ky])
    cn_num = 1.0 - 0.5 * delta_t * visc * lap
    cn_den = 1.0 + 0.5 * delta_t * visc * lap
    advect = -delta_t * dealias / cn_den
    force = delta_t * f_h / cn_den
    decay = cn_num / cn_den

    snaps = []
    for _ in range(record_steps):
        snaps.append(torch.fft.ifftn(w_h, dim=(-2, -1)).real)
        for _ in range(steps_per_record):
            u, v, w_x, w_y = torch.fft.ifftn(deriv * w_h[:, None], dim=(-2, -1)).real.unbind(1)
            F_h = torch.fft.fftn(u * w_x + v * w_y, dim=(-2, -1))
            w_h = advect * F_h + force + decay * w_h
    w_final = torch.fft.ifftn(w_h, dim=(-2, -1)).real
    return torch.stack(snaps, dim=1), w_final


@torch.no_grad()
def navier_stokes_rollout_split(w0: torch.Tensor, f: torch.Tensor, visc: float, delta_t: float,
                                record_steps: int, steps_per_record: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``navier_stokes_rollout`` with split-complex matmul DFTs (no complex dtypes).

    The same physics, discretization and recording cadence; the spectral state is a
    pair of f32 planes ``(re, im)`` and every transform a full-f32 real matmul
    (``data/splitfft.py``). It agrees with the complex path to f32 rounding a step;
    long chaotic rollouts drift apart as any two f32 orders of the sums do.

    Returns ``(snapshots [batch, record_steps, N, N], w_final [batch, N, N])``.
    """
    N, dev = w0.shape[-1], w0.device
    k_max = N // 2
    k = torch.cat([torch.arange(0, k_max), torch.arange(-k_max, 0)]).to(dev)
    k_y = k[None, :].expand(N, N)
    k_x = k_y.T
    lap = 4 * math.pi**2 * (k_x**2 + k_y**2)
    lap[0, 0] = 1.0
    dealias = ((k_y.abs() <= (2.0 / 3.0) * k_max) & (k_x.abs() <= (2.0 / 3.0) * k_max)).float()

    C, S = dft_matrices(N, w0.dtype, dev)
    w_re, w_im = fft2_real_input(w0, C, S)
    f_re, f_im = fft2_real_input(f.to(dev), C, S)
    two_pi_kx, two_pi_ky = 2 * math.pi * k_x, 2 * math.pi * k_y
    cn_num = 1.0 - 0.5 * delta_t * visc * lap
    cn_den = 1.0 + 0.5 * delta_t * visc * lap
    # (a + i b) (i c) = -c b + i c a: the spectral derivatives of u = dpsi/dy,
    # v = -dpsi/dx (psi = w / lap), w_x and w_y, stacked for one batched transform.
    c = torch.stack([two_pi_ky, -two_pi_kx, two_pi_kx, two_pi_ky])[:, None]

    snaps = []
    for _ in range(record_steps):
        snaps.append(ifft2_real_output(w_re, w_im, C, S))
        for _ in range(steps_per_record):
            psi_re, psi_im = w_re / lap, w_im / lap
            x_re = torch.stack([psi_re, psi_re, w_re, w_re])
            x_im = torch.stack([psi_im, psi_im, w_im, w_im])
            u, v, w_x, w_y = ifft2_real_output(-c * x_im, c * x_re, C, S)
            F_re, F_im = fft2_real_input(u * w_x + v * w_y, C, S)
            w_re = (-delta_t * F_re * dealias + delta_t * f_re + cn_num * w_re) / cn_den
            w_im = (-delta_t * F_im * dealias + delta_t * f_im + cn_num * w_im) / cn_den
    return torch.stack(snaps, dim=1), ifft2_real_output(w_re, w_im, C, S)


def generate_ns_trajectories(seeds: Sequence[int], size: int = 64, visc: float = 1e-3,
                             t_horizon: int = 20, delta_t: float = 1e-3, burn_in: float = 30.0,
                             split_fft: bool = False, device="cuda") -> np.ndarray:
    """Navier-Stokes trajectories for per-trajectory seeds, integrated on ``device``.

    Each initial field is a GRF sample evolved for ``burn_in`` time units; the recorded
    trajectory then has one frame per time unit over ``t_horizon``. ``split_fft`` builds
    the initial fields from the same coefficients and integrates with the split DFT
    (``navier_stokes_rollout_split``), as the JAX package's option does.

    Returns [len(seeds), t_horizon, size, size, 1] float32.
    """
    grf = GaussianRF2D(size)
    w0 = grf.sample_split(seeds, device) if split_fft else grf.sample(seeds, device)
    rollout = navier_stokes_rollout_split if split_fft else navier_stokes_rollout
    f = default_forcing(size, device)
    _, burned = rollout(w0, f, visc, delta_t, record_steps=1,
                        steps_per_record=int(burn_in / delta_t))
    traj, _ = rollout(burned, f, visc, delta_t, record_steps=t_horizon,
                      steps_per_record=int(1.0 / delta_t))
    return traj.cpu().numpy().astype(np.float32)[..., None]
