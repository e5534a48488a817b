"""Internally heated convection in the unit ball (the ``ihc`` dataset).

Counterpart of ``enf_pde_tpu/data/ihc.py``. Trajectories come from the spectral
Boussinesq solver of ``data/ball_convection.py`` (reference ``pdes.py:738-846``: Rayleigh
1e6, Prandtl 1, internal source 6, stress-free impenetrable velocity, fixed-flux
temperature, CFL-adaptive SBDF2), a block of seeds batched on the card. Frames are recorded
on the reference output grid (48 x 24 x 24 uniform phi / theta / r, ``fit_ihc.py:33-37``)
every 0.2 time units from t = 2.

``BallModes`` (the exact Neumann heat-kernel eigenbasis of the ball, host numpy / SciPy)
is the validation oracle: with buoyancy off, the convection solver started from
``BallModes.conduction_state`` must reproduce its closed-form frames.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
from scipy.optimize import brentq
from scipy.special import spherical_jn

from enf_pde_tpu_torch.data.ball_convection import KAPPA, BallConvectionSolver, BallOutputGrid
from enf_pde_tpu_torch.data.sphere_harmonics import legendre_table

__all__ = ["BallModes", "full_size_solver", "generate_ihc_trajectories", "neumann_bessel_roots"]


def neumann_bessel_roots(l: int, num: int) -> np.ndarray:
    """First ``num`` positive roots of d/dx j_l(x) = 0."""
    roots = []
    x = 1e-3 if l == 0 else 0.5
    prev = spherical_jn(l, x, derivative=True)
    step = 0.01
    while len(roots) < num:
        x2 = x + step
        cur = spherical_jn(l, x2, derivative=True)
        if prev * cur < 0:
            roots.append(brentq(lambda t: spherical_jn(l, t, derivative=True), x, x2))
        x, prev = x2, cur
        if x > 400:
            raise RuntimeError("Bessel root search ran away")
    return np.asarray(roots)


class BallModes:
    """Neumann heat-kernel eigenbasis of the unit ball on a (phi, theta, r) grid.

    Exact conduction solutions: the perturbation ``u = T - (1 - r^2)`` obeys the pure
    heat equation with a homogeneous Neumann boundary and is diagonal in the basis
    ``Y_lm(theta, phi) * j_l(lambda_{l,n} r)`` with ``j_l'(lambda) = 0``.
    """

    def __init__(self, nphi: int = 48, ntheta: int = 24, nr: int = 24, lmax: int = 12, nmax: int = 8):
        self.nphi, self.ntheta, self.nr = nphi, ntheta, nr
        self.lmax, self.nmax = lmax, nmax
        self.mmax = min(lmax, nphi // 2)
        # The output grid of the reference entry point: uniform phi, uniform theta in
        # (0, pi), r = linspace(0, 1, nr).
        self.phi = np.linspace(0, 2 * np.pi, nphi, endpoint=False)
        self.theta = np.linspace(1e-3, np.pi, ntheta, endpoint=False)
        self._P_out = legendre_table(lmax, np.cos(self.theta))[:, : self.mmax + 1, :]  # [L, M, ntheta]

        # Radial Gauss-Legendre quadrature on [0, 1] (weight r^2 dr).
        nodes, weights = np.polynomial.legendre.leggauss(64)
        self.rq = 0.5 * (nodes + 1.0)
        self.wq = 0.5 * weights
        self.r_out = np.linspace(0, 1, nr)

        # Radial modes j_l(lambda_{l,n} r), Neumann at r=1, L2(r^2 dr)-normalized.
        self.lam = np.zeros((lmax + 1, nmax))
        self.radial_norm = np.zeros((lmax + 1, nmax))
        self.radial_out = np.zeros((lmax + 1, nmax, nr))
        for l in range(lmax + 1):
            lams = neumann_bessel_roots(l, nmax)
            self.lam[l] = lams
            for n, lam in enumerate(lams):
                fq = spherical_jn(l, lam * self.rq)
                norm = np.sqrt(np.sum(self.wq * fq**2 * self.rq**2))
                self.radial_norm[l, n] = norm
                self.radial_out[l, n] = spherical_jn(l, lam * self.r_out) / norm

    def sample_ic_coeffs(self, seed: int, scale: float = 0.1) -> np.ndarray:
        """Random band-limited modal coefficients for a noise IC."""
        rng = np.random.RandomState(seed % (2**31 - 1))
        L, M, N = self.lmax + 1, self.mmax + 1, self.nmax
        coeffs = (rng.randn(L, M, N) + 1j * rng.randn(L, M, N)) * scale
        ls = np.arange(L)[:, None, None]
        ms = np.arange(M)[None, :, None]
        coeffs = np.where(ls >= ms, coeffs, 0.0)
        coeffs[:, 0] = coeffs[:, 0].real  # m = 0 modes are real
        # Taper the spectrum so the field is smooth at grid scale.
        taper = np.exp(-0.5 * (ls / (L / 2)) ** 2) * np.exp(
            -0.5 * (np.arange(N)[None, None, :] / (N / 2)) ** 2
        )
        return coeffs * taper

    def frames(self, coeffs: np.ndarray, times: np.ndarray) -> np.ndarray:
        """Exact heat-equation frames [T, nphi, ntheta, nr] for modal IC ``coeffs``."""
        decay = np.exp(-KAPPA * (self.lam[:, None, :] ** 2)[None] * times[:, None, None, None])
        ct = coeffs[None] * decay  # [T, L, M, N]
        field_lm_r = np.einsum("tlmn,lnr->tlmr", ct, self.radial_out)
        g_m = np.einsum("lmj,tlmr->trmj", self._P_out, field_lm_r)  # [T, nr, M, ntheta]
        pad = self.nphi // 2 + 1 - (self.mmax + 1)
        if pad > 0:
            g_m = np.pad(g_m, [(0, 0), (0, 0), (0, pad), (0, 0)])
        grid = np.fft.irfft(g_m * self.nphi, n=self.nphi, axis=-2)  # [T, nr, nphi, ntheta]
        pert = np.moveaxis(grid, 1, -1)  # [T, nphi, ntheta, nr]
        return pert + (1.0 - self.r_out**2)[None, None, None, :]

    def conduction_state(self, solver: BallConvectionSolver, coeffs: np.ndarray):
        """``solver``'s state (Tc, Wc, Zc), each [1, L, M, n] on its device, at rest with
        the modal field ``coeffs`` on the conductive profile: with buoyancy off, its frames
        on ``BallOutputGrid(solver, nphi, ntheta, nr)`` are ``frames(coeffs, t)``."""
        Tc, Wc, Zc = solver.initial_condition([0], scale=0.0)
        PT = solver.PT.cpu().numpy()  # [L, NT, nq]: values at the solver's radii -> coefficients
        pert = np.zeros(Tc.shape[1:], np.complex128)
        for l in range(self.lmax + 1):
            radial = spherical_jn(l, self.lam[l][:, None] * solver.rq) / self.radial_norm[l][:, None]  # [N, nq]
            pert[l, : self.mmax + 1] = coeffs[l] @ radial @ PT[l].T
        return Tc + torch.from_numpy(pert).to(Tc.device), Wc, Zc


@functools.lru_cache(maxsize=None)
def _full_size_solver(device: str) -> BallConvectionSolver:
    return BallConvectionSolver(device=device)


def full_size_solver(device="cuda") -> BallConvectionSolver:
    """The full-size solver (lmax 23, nmax 24) on ``device``, built once: its set-up builds
    the bases on the host."""
    return _full_size_solver(str(torch.device(device)))


def generate_ihc_trajectories(seeds: Sequence[int], solver=None, num_frames: int = 20,
                              device="cuda") -> np.ndarray:
    """Convection trajectories [len(seeds), num_frames, 48, 24, 24, 1] float32, the seeds
    run as one batch on the solver's device (``full_size_solver(device)`` when none is
    given). Frames at ``t = 2.0 + 0.2 k``: the reference recorder's cadence (every 10 steps
    of about 0.02 time units, the first 10 records skipped)."""
    solver = solver or full_size_solver(device)
    frames = solver.simulate([int(s) for s in seeds], record_interval=0.2, t_start_record=2.0,
                             num_frames=num_frames, out_grid=BallOutputGrid(solver))
    return frames.cpu().numpy().astype(np.float32)[..., None]
