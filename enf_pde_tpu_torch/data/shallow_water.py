"""Spectral rotating shallow-water solver on the sphere (Galewsky-jet data), on the card.

Counterpart of ``enf_pde_tpu/data/shallow_water.py`` (reference ``pdes.py:559-730``,
Dedalus on a 192 x 96 sphere grid in Earth-radius / hour units, recording 20 frames of
(h, u_phi, u_theta)). The same system is solved in vorticity-divergence form with the
scalar spherical-harmonic transforms of ``SphereGrid``:

    dt(zeta) = -div((zeta + f) V)
    dt(delta) = curl_r((zeta + f) V) - lap(E + g h),  E = |V|^2 / 2
    dt(h) = -div(h V) - H delta

with ``V`` from the streamfunction and velocity potential (``psi = lap^-1 zeta``,
``chi = lap^-1 delta``). A step is a Strang split: half a step of the exact per-mode
gravity-wave propagator, SSPRK3 on the advective tendencies, the other half, then the
``nu lap^2`` hyperdiffusion by its exact factor; the triangular truncation at ``lmax =
2/3 ntheta`` dealiases the quadratic terms.

The state is complex64 SH coefficients ``[..., lmax+1, mmax+1]``, the tables and their
products f32 without TF32 (``SphereGrid``), the JAX package's operations in its order,
and ``lax.scan`` a Python loop. A block of seeds runs as one state with a leading batch
axis, so a step's launches serve the whole block. The bump's random widths and height
come from numpy's ``RandomState`` as in the JAX package, so a seed gives its trajectory.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from enf_pde_tpu_torch.data.sphere_harmonics import SphereGrid

__all__ = ["SWUnits", "ShallowWaterSolver", "galewsky_state", "generate_sw_trajectories",
           "sw_grid", "STEPS_PER_RECORD"]

STEPS_PER_RECORD = 150  # 150 steps of 400 s: one frame per 60,000 simulated seconds
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (zeta_lm, delta_lm, h_lm)


class SWUnits:
    """Simulation units matching the reference (Earth radius = 1, hour = 1)."""

    meter = 1.0 / 6.37122e6
    hour = 1.0
    second = hour / 3600.0
    R = 1.0
    Omega = 7.292e-5 / second
    g = 9.80616 * meter / second**2
    H = 1e4 * meter
    nu = 1e5 * meter**2 / second / 32**2  # hyperdiffusion matched at ell = 32
    umax = 80 * meter / second
    timestep = 1200 * second


def sw_grid(nphi: int = 192, ntheta: int = 96, device="cuda") -> SphereGrid:
    """The generation grid: Gauss-Legendre 192 x 96 with ``lmax = 2/3 ntheta`` = 64."""
    return SphereGrid(nphi, ntheta, lmax=(2 * ntheta) // 3, device=device)


class ShallowWaterSolver:
    def __init__(self, grid: SphereGrid, units: SWUnits = SWUnits()):
        self.grid = grid
        self.u = units
        f32 = dict(dtype=torch.float32, device=grid.device)
        lap = grid.laplacian_eig / units.R**2  # [-l(l+1)/R^2]
        self.lap = lap[:, None]
        inv = torch.zeros_like(lap)  # lap^-1 with the l = 0 mode nulled
        inv[1:] = 1.0 / lap[1:]
        self.lap_inv = inv[:, None]
        self.f_grid = 2 * units.Omega * torch.tensor(grid.x, **f32)[None, :]  # 2 Omega cos(theta)
        self.inv_sin = 1.0 / grid.sin_theta[None, :]
        # Triangular truncation mask (l >= m; l <= lmax by construction).
        L = torch.arange(grid.lmax + 1, device=grid.device)[:, None]
        M = torch.arange(grid.mmax + 1, device=grid.device)[None, :]
        self.valid = L >= M

    # -- differential operators on the grid ---------------------------------------

    def velocities(self, zeta_lm, delta_lm):
        """V = k x grad(psi) + grad(chi) in physical orientation (eastward u_phi): solid-
        body eastward rotation has zeta = +2 w cos(theta)."""
        g = self.grid
        psi = zeta_lm * self.lap_inv
        chi = delta_lm * self.lap_inv
        psi_t = g.synthesis_dtheta(psi)
        chi_t = g.synthesis_dtheta(chi)
        psi_p = g.synthesis(g.dphi_coeffs(psi))
        chi_p = g.synthesis(g.dphi_coeffs(chi))
        R = self.u.R
        u_phi = (psi_t + chi_p * self.inv_sin) / R
        u_theta = (-psi_p * self.inv_sin + chi_t) / R
        return u_phi, u_theta

    def div(self, a_phi, a_theta):
        """Divergence of a grid vector field, as SH coefficients."""
        g = self.grid
        dphi = g.dphi_coeffs(g.analysis(a_phi * self.inv_sin))
        dtheta_lm = g.analysis_dtheta_flux(a_theta)
        return (dphi + dtheta_lm) / self.u.R

    def curl_r(self, a_phi, a_theta):
        """Radial curl (physical orientation), (1/R sin t)[d(a_phi sin t)/dt - d a_theta/d phi],
        as SH coefficients."""
        g = self.grid
        dphi = g.dphi_coeffs(g.analysis(a_theta * self.inv_sin))
        dtheta_lm = g.analysis_dtheta_flux(a_phi)
        return (dtheta_lm - dphi) / self.u.R

    # -- tendencies ----------------------------------------------------------------

    def tendencies_nonlinear(self, state: State) -> State:
        """Advective and rotational tendencies: everything but the linear gravity waves
        ``d(delta)/dt = -g lap h, dh/dt = -H delta``, which ``linear_propagator`` steps
        exactly (lifting their CFL limit at the reference's step)."""
        zeta_lm, delta_lm, h_lm = state
        g = self.grid
        u_phi, u_theta = self.velocities(zeta_lm, delta_lm)
        zeta = g.synthesis(zeta_lm)
        h = g.synthesis(h_lm)
        eta = zeta + self.f_grid

        flux_phi, flux_theta = eta * u_phi, eta * u_theta
        d_zeta = -self.div(flux_phi, flux_theta)
        energy = 0.5 * (u_phi**2 + u_theta**2)
        d_delta = self.curl_r(flux_phi, flux_theta) - self.lap * g.analysis(energy)
        d_h = -self.div(h * u_phi, h * u_theta)
        return d_zeta * self.valid, d_delta * self.valid, d_h * self.valid

    def linear_propagator(self, t: float):
        """Exact exp(t M) of the per-mode gravity-wave system ``d/dt [delta, h] = M [delta, h]``,
        ``M = [[0, g k2], [-H, 0]]``, ``k2 = l(l+1)/R^2``: ``M^2 = -g H k2 I`` gives
        ``exp(tM) = cos(w t) I + sin(w t)/w M`` with ``w = sqrt(g H k2)``. Returns
        ``(cos, a12, a21)``, each [L, 1]."""
        un = self.u
        k2 = -self.lap
        w = torch.sqrt(un.g * un.H * k2)
        cos = torch.cos(w * t)
        sinc = torch.where(w > 0, torch.sin(w * t) / torch.where(w > 0, w, 1.0), t)
        a12 = sinc * un.g * k2  # delta <- h
        a21 = -sinc * un.H  # h <- delta
        return cos, a12, a21

    @torch.no_grad()
    def rollout(self, state: State, dt: float, num_records: int, steps_per_record: int):
        """Strang split (half linear, SSPRK3, half linear) and the hyperdiffusion factor,
        ``steps_per_record`` steps a record; returns ``(h, u_phi, u_theta)``, each
        ``[num_records, ..., nphi, ntheta]``, recorded after each stretch (the reference's
        recorder skips the initial condition)."""
        hyper = torch.exp(-self.u.nu * (self.lap**2) * dt)
        cos, a12, a21 = self.linear_propagator(0.5 * dt)

        def half_linear(s: State) -> State:
            zeta_lm, delta_lm, h_lm = s
            return zeta_lm, cos * delta_lm + a12 * h_lm, a21 * delta_lm + cos * h_lm

        def step(s: State) -> State:
            s = half_linear(s)
            # SSPRK3 (Shu-Osher): its stability region covers the imaginary axis up to sqrt(3).
            k1 = self.tendencies_nonlinear(s)
            s1 = tuple(x + dt * d for x, d in zip(s, k1))
            k2 = self.tendencies_nonlinear(s1)
            s2 = tuple(0.75 * x + 0.25 * (y + dt * d) for x, y, d in zip(s, s1, k2))
            k3 = self.tendencies_nonlinear(s2)
            s = tuple(x / 3.0 + (2.0 / 3.0) * (y + dt * d) for x, y, d in zip(s, s2, k3))
            s = half_linear(s)
            return tuple(x * hyper for x in s)

        records = []
        for _ in range(num_records):
            for _ in range(steps_per_record):
                state = step(state)
            zeta_lm, delta_lm, h_lm = state
            u_phi, u_theta = self.velocities(zeta_lm, delta_lm)
            records.append((self.grid.synthesis(h_lm), u_phi, u_theta))
        return tuple(torch.stack(r) for r in zip(*records))


def galewsky_state(grid: SphereGrid, seed: int, units: SWUnits = SWUnits()) -> State:
    """Balanced Galewsky zonal jet plus a randomized height bump, as SH coefficients on
    the grid's device.

    Randomization matches the reference (``pdes.py:621-637``): bump amplitude
    ``120 m +- 30 m``, widths ``alpha ~ 1/3 +- 1/9``, ``beta ~ 1/15 +- 1/45``.
    """
    rng = np.random.RandomState(seed % (2**31 - 1))
    hpert = 120 * units.meter + 30 * units.meter * (1 - 2 * rng.rand())
    alpha = 1 / 3 + 1 / 9 * (1 - 2 * rng.rand())
    beta = 1 / 15 + 1 / 45 * (1 - 2 * rng.rand())

    lat0 = np.pi / 7
    lat1 = np.pi / 2 - lat0
    en = np.exp(-4 / (lat1 - lat0) ** 2)

    def u_jet(lat):
        lat = np.asarray(lat)
        inside = (lat > lat0) & (lat < lat1)
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            prof = np.where(
                inside, units.umax / en * np.exp(1.0 / ((lat - lat0) * (lat - lat1) + 1e-300)), 0.0
            )
        return np.nan_to_num(prof)

    # Balanced height by meridional integration of gradient-wind balance:
    # g dh/dlat = -u (f R + u tan(lat)).
    lat_fine = np.linspace(-np.pi / 2 + 1e-6, np.pi / 2 - 1e-6, 20001)
    uj = u_jet(lat_fine)
    f = 2 * units.Omega * np.sin(lat_fine)
    integrand = -(uj * (units.R * f + uj * np.tan(lat_fine))) / units.g
    h_fine = np.concatenate([[0.0], np.cumsum(0.5 * (integrand[1:] + integrand[:-1]) * np.diff(lat_fine))])

    lat_grid = np.pi / 2 - grid.theta  # colatitude -> latitude
    h_bal = np.interp(lat_grid, lat_fine, h_fine)
    # Area-weighted zero mean (the reference LBVP enforces ave(h) = 0).
    h_bal = h_bal - np.sum(h_bal * grid.w) / np.sum(grid.w)

    phi = grid.phi[:, None]
    lat2d = lat_grid[None, :]
    lat_bump = np.pi / 4
    bump = hpert * np.cos(lat2d) * np.exp(-((phi / alpha) ** 2)) * np.exp(
        -(((lat_bump - lat2d) / beta) ** 2)
    )
    f32 = dict(dtype=torch.float32, device=grid.device)
    h0 = torch.tensor(h_bal[None, :] + bump, **f32)

    # Initial vorticity of the zonal jet: zeta = -(1/(R sin t)) d(u_phi sin t)/d theta.
    solver = ShallowWaterSolver(grid, units)
    u_phi0 = torch.tensor(u_jet(lat_grid), **f32)[None, :] * torch.ones((grid.nphi, 1), **f32)
    zeta0 = solver.curl_r(u_phi0, torch.zeros_like(u_phi0))
    delta0 = torch.zeros_like(zeta0)
    return zeta0 * solver.valid, delta0, grid.analysis(h0) * solver.valid


@torch.no_grad()
def generate_sw_trajectories(seeds: Sequence[int], nphi: int = 192, ntheta: int = 96,
                             num_frames: int = 20, grid: SphereGrid | None = None,
                             device="cuda") -> np.ndarray:
    """SW trajectories [len(seeds), num_frames, nphi, ntheta, 3] float32 with channels
    (h, u_phi, u_theta), every seed of the block in one batched state on the grid's device
    (``device`` when no grid is given).

    360 simulated hours, one frame per 60,000 simulated seconds: the reference's
    recording protocol (the first stored frame comes one cadence after t = 0). The step
    is 400 s, a third of the reference's IMEX step: the split treats the mean-depth
    gravity waves exactly, but height deviations reach about 25 % of H and their explicit
    residual needs the margin at lmax = 64.
    """
    grid = grid or sw_grid(nphi, ntheta, device=device)
    units = SWUnits()
    solver = ShallowWaterSolver(grid, units)
    states = [galewsky_state(grid, int(s), units) for s in seeds]
    state = tuple(torch.stack(c) for c in zip(*states))
    h, u_phi, u_theta = solver.rollout(state, units.timestep / 3, num_records=num_frames,
                                       steps_per_record=STEPS_PER_RECORD)
    traj = torch.stack([h, u_phi, u_theta], dim=-1).transpose(0, 1)  # [n, T, nphi, ntheta, 3]
    return traj.cpu().numpy().astype(np.float32)


def _avg_pool_2x2(traj: np.ndarray) -> np.ndarray:
    """[T, H, W, C] -> [T, H//2, W//2, C] by 2x2 mean pooling."""
    t, h, w, c = traj.shape
    return traj.reshape(t, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))
