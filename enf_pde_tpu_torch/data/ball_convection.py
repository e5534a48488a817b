"""Boussinesq convection in the unit ball, on the card: a toroidal-poloidal spectral solver.

Counterpart of ``enf_pde_tpu/data/ball_convection.py`` (reference ``pdes.py:738-846``, a
Dedalus BallBasis IVP): internally heated convection at Rayleigh 1e6, Prandtl 1,

    div(u) = 0
    dt(u) - nu*lap(u) + grad(p) - r*T*rhat = -curl(u) x u
    dt(T) - kappa*lap(T)                  = -u.grad(T) + kappa*T_source,  T_source = 6

with stress-free, impenetrable velocity and fixed-flux temperature (``dT/dr(1) = -2``),
initial conditions of low-passed random noise on the conductive profile ``1 - r^2``,
SBDF2 with a CFL-adaptive step. The discretization is the JAX package's: spherical
harmonics on a 3/2-dealiased Gauss-Legendre x uniform-phi grid, one-sided Jacobi radial
bases regular at the origin, u = curl(curl(W rhat)) + curl(Z rhat), and a Galerkin weak
form whose operators are symmetric and sign-definite, so SBDF is unconditionally stable
for the linear part.

Where things run. Set-up builds the bases on the host in float64 numpy / SciPy, as the
JAX package does (Jacobi polynomials, Gauss-Legendre nodes, the boundary recombinations
``RZ`` / ``RW``, the weak-form matrices), and moves the tables to the solver's device
once. Stepping runs there in float64 / complex128: the transforms (``torch.fft`` and real
matrix products, the real and imaginary parts as two products), the weak-form forcing,
the SBDF right-hand sides, one batched ``torch.linalg.lu_solve`` per field (the LU
factors of every degree l from one ``lu_factor`` per field and order, cached per dt), the
mask, the CFL (one host read every ``CFL_CADENCE`` steps) and the output grid.

A block of seeds runs as one state ``[B, L, M, n]``: each trajectory keeps its own CFL dt,
SBDF1 restarts and LU factors, and leaves the batch once it has recorded its frames. The
initial noise is drawn with ``np.random.RandomState(seed)`` as in the JAX package, so a
seed gives the JAX package's trajectory up to float64 rounding.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from scipy.special import eval_jacobi

from enf_pde_tpu_torch.data.sphere_harmonics import legendre_table

__all__ = ["AngularGrid", "RadialBasis", "BallConvectionSolver", "BallOutputGrid", "KAPPA"]

F64 = torch.float64

RAYLEIGH, PRANDTL = 1e6, 1.0
T_SOURCE = 6.0  # internal heating
KAPPA = (RAYLEIGH * PRANDTL) ** (-0.5)  # thermal diffusivity
NU = (RAYLEIGH / PRANDTL) ** (-0.5)  # kinematic viscosity
MAX_DT, MIN_DT = 0.02, 1e-4  # the first step and the CFL step's bounds
CFL_SAFETY = 0.5
CFL_CADENCE = 10  # steps between CFL checks


def _bmm_c(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` for complex A and real B: two real matrix products (numpy broadcasting)."""
    return torch.complex(torch.matmul(A.real, B), torch.matmul(A.imag, B))


# ------------------------------------------------------------------ angular


class AngularGrid:
    """Scalar SHT on a Gauss-Legendre x uniform-phi grid, float64 on ``device``.

    Fields are ``[..., nphi, ntheta]``; coefficients ``[..., L, M]`` complex with the
    m >= 0 rfft convention. ``analysis(f)[l, m] = <f, Y*_lm>`` for orthonormal
    ``Y_lm = Pbar_l^m(cos theta) e^{i m phi}``. The tables are tensors.
    """

    def __init__(self, nphi: int, ntheta: int, lmax: int, device="cuda"):
        if lmax >= ntheta:
            raise ValueError(f"lmax ({lmax}) must be < ntheta ({ntheta}) for exact quadrature.")
        self.nphi, self.ntheta, self.lmax = nphi, ntheta, lmax
        self.mmax = min(lmax, nphi // 2)
        nodes, weights = np.polynomial.legendre.leggauss(ntheta)
        order = np.argsort(-nodes)
        x, w = nodes[order], weights[order]  # cos(theta), theta ascending from 0 to pi
        sin_theta = np.sqrt(1.0 - x**2)

        P_ext = legendre_table(lmax + 1, x)
        P = P_ext[: lmax + 1, : self.mmax + 1, :]  # [L, M, J]

        # dPbar/dtheta by the normalized recurrence (as SphereGrid).
        L1 = lmax + 2
        ls = np.arange(L1, dtype=np.float64)[:, None]
        ms = np.arange(L1, dtype=np.float64)[None, :]
        with np.errstate(invalid="ignore", divide="ignore"):
            eps = np.sqrt(np.maximum(ls**2 - ms**2, 0.0) / np.maximum(4 * ls**2 - 1.0, 1e-300))
        H = np.zeros((lmax + 1, lmax + 1, ntheta))
        for m in range(lmax + 1):
            for l in range(m, lmax + 1):
                up = l * eps[l + 1, m] * P_ext[l + 1, m]
                down = (l + 1) * eps[l, m] * (P_ext[l - 1, m] if l >= 1 else 0.0)
                H[l, m] = (up - down) / sin_theta
        H = H[:, : self.mmax + 1, :]

        t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=F64, device=device)  # noqa: E731
        # m-major copies for the products: synthesis sums over l, analysis over j.
        self.P_m = t(P.transpose(1, 0, 2))  # [M, L, J]
        self.H_m = t(H.transpose(1, 0, 2))
        self.PwT_m = t((P * w[None, None, :]).transpose(1, 2, 0))  # [M, J, L]
        self.HwT_m = t((H * w[None, None, :]).transpose(1, 2, 0))
        self.sin_theta = t(sin_theta)
        self.llp1 = t(np.arange(lmax + 1) * (np.arange(lmax + 1) + 1.0))  # [L]
        self.im = 1j * torch.arange(self.mmax + 1, dtype=F64, device=device)  # [M], complex128

    # fields <-> m-space -----------------------------------------------------------
    def _to_m(self, f):
        return torch.fft.rfft(f, dim=-2)[..., : self.mmax + 1, :] / self.nphi

    def _from_m(self, g_m):
        pad = self.nphi // 2 + 1 - (self.mmax + 1)
        if pad > 0:
            g_m = torch.nn.functional.pad(g_m, (0, 0, 0, pad))
        return torch.fft.irfft(g_m * self.nphi, n=self.nphi, dim=-2)

    def _contract_analysis(self, table_T, f):
        """c_m [..., M, J] x table [M, J, L] -> [..., L, M]."""
        cm = self._to_m(f).movedim(-2, 0)  # [M, ..., J]
        lead = cm.shape[1:-1]
        out = _bmm_c(cm.reshape(cm.shape[0], -1, cm.shape[-1]), table_T)  # [M, N, L]
        out = out.reshape(out.shape[0], *lead, out.shape[-1])
        return 2 * np.pi * out.movedim((0, -1), (-1, -2))

    def _contract_synthesis(self, table, flm):
        """flm [..., L, M] x table [M, L, J] -> grid (via irfft)."""
        fm = flm.movedim(-1, 0)  # [M, ..., L]
        lead = fm.shape[1:-1]
        g = _bmm_c(fm.reshape(fm.shape[0], -1, fm.shape[-1]), table)  # [M, N, J]
        return self._from_m(g.reshape(g.shape[0], *lead, g.shape[-1]).movedim(0, -2))

    # transforms ---------------------------------------------------------------
    def analysis(self, f):
        """[..., nphi, ntheta] -> [..., L, M]: f_lm = <f, Y*_lm>."""
        return self._contract_analysis(self.PwT_m, f)

    def analysis_dtheta(self, f):
        """Coefficients of <f, dY*_lm/dtheta> (no integration by parts)."""
        return self._contract_analysis(self.HwT_m, f)

    def synthesis(self, flm):
        return self._contract_synthesis(self.P_m, flm)

    def synthesis_dtheta(self, flm):
        return self._contract_synthesis(self.H_m, flm)

    def synthesis_dphi_over_sin(self, flm):
        """Grid values of (1/sin theta) d/dphi of the field with coefficients flm."""
        return self._contract_synthesis(self.P_m, flm * self.im) / self.sin_theta


# ------------------------------------------------------------------ radial (numpy, set-up)


class RadialBasis:
    """One-sided Jacobi radial basis, regular at the origin (host numpy, set-up only).

    Basis: ``phi^l_n(r) = c_n r^{l+sigma} P_n^{(0, l+sigma+1/2)}(2 r^2 - 1)``,
    orthonormalized under ``int_0^1 f g r^2 dr``. Derivatives of any order are exact:
    each is a sum of terms ``coeff * r^p * d^j/dt^j P_n (t=2r^2-1)`` maintained
    symbolically (differentiation maps (c, p, j) -> (c p, p-1, j) + (4c, p+1, j+1)).
    """

    def __init__(self, lmax: int, nmax: int, sigma: int, lmin: int = 0):
        self.lmax, self.nmax, self.sigma, self.lmin = lmax, nmax, sigma, lmin
        qn, qw = np.polynomial.legendre.leggauss(2 * nmax + lmax + 8)
        rq = 0.5 * (qn + 1.0)
        wq = 0.5 * qw
        self._norm = np.ones((lmax + 1, nmax))
        for l in range(lmin, lmax + 1):
            vals = self._eval_raw(l, rq, 0)
            self._norm[l] = np.sqrt(np.sum(wq[:, None] * vals**2 * rq[:, None] ** 2, axis=0))

    def _alpha_beta(self, l):
        p0 = l + self.sigma
        return 0.0, p0 + 0.5, p0

    def _eval_raw(self, l, r, deriv):
        """Un-normalized [len(r), nmax] matrix of the deriv-th radial derivative."""
        a, b, p0 = self._alpha_beta(l)
        r = np.asarray(r, dtype=np.float64)
        t = 2 * r**2 - 1
        terms = {(p0, 0): 1.0}  # (power of r, derivative order of P) -> coefficient
        for _ in range(deriv):
            new: Dict[Tuple[float, int], float] = {}
            for (p, j), c in terms.items():
                if p != 0:
                    new[(p - 1, j)] = new.get((p - 1, j), 0.0) + c * p
                new[(p + 1, j + 1)] = new.get((p + 1, j + 1), 0.0) + 4.0 * c
            terms = new
        out = np.zeros((len(r), self.nmax))
        ns = np.arange(self.nmax)
        for (p, j), c in terms.items():
            # d^j/dt^j P_n^{(a,b)} = 2^{-j} prod_{i<j}(n+a+b+1+i) P_{n-j}^{(a+j,b+j)}
            scale = np.ones(self.nmax)
            for i in range(j):
                scale *= (ns + a + b + 1 + i) / 2.0
            pj = np.zeros((len(r), self.nmax))
            for n in range(j, self.nmax):
                pj[:, n] = scale[n] * eval_jacobi(n - j, a + j, b + j, t)
            if p < 0:
                # falling-factorial coefficients kill negative powers exactly
                if abs(c) >= 1e-12:
                    raise ValueError(f"negative power r^{p} with coefficient {c}")
                continue
            out += c * (r[:, None] ** p) * pj
        return out

    def eval(self, l, r, deriv=0):
        """Normalized evaluation matrix [len(r), nmax] of the deriv-th derivative."""
        return self._eval_raw(l, r, deriv) / self._norm[l][None, :]

    def stack(self, r, deriv=0):
        """[L, len(r), nmax] evaluation tensor over all l (zeros below lmin)."""
        out = np.zeros((self.lmax + 1, len(r), self.nmax))
        for l in range(self.lmin, self.lmax + 1):
            out[l] = self.eval(l, r, deriv)
        return out

    def projector(self, r, w):
        """[L, nmax, len(r)] weighted least-squares projection (grid values at the
        quadrature nodes ``r`` with weights ``w`` -> coefficients)."""
        out = np.zeros((self.lmax + 1, self.nmax, len(r)))
        for l in range(self.lmin, self.lmax + 1):
            E = self.eval(l, r, 0)
            Wsq = (w * r**2)[:, None]
            out[l] = np.linalg.solve(E.T @ (Wsq * E), (Wsq * E).T)
        return out


# ------------------------------------------------------------------ the solver


class BallConvectionSolver:
    """Galerkin toroidal-poloidal solver for internally heated ball convection.

    Per (l, m), with c = l(l+1), D_l f = f'' - c f / r^2 and quadrature over [0, 1]:

        temperature (weight r^2 dr):   M_T dT/dt = -kappa K_T T + F_T
        toroidal    (weight dr):       M_Z dZ/dt = -nu K_Z Z + F_Z
        poloidal    (weight dr):       M_W dW/dt = -nu G_W W + F_W

    Test functions live in the recombined radial bases of the trial functions, which
    satisfy the velocity boundary conditions exactly (Z'(1) = 2Z(1); W(1) = 0,
    W''(1) = 2W'(1)); temperature's fixed flux enters as a boundary term. See the JAX
    package's class for the weak forms. Coefficient states are ``[B, L, M, n]``
    complex128 on ``device``.
    """

    def __init__(self, lmax: int = 23, nmax: int = 24, buoyancy: float = 1.0, device="cuda"):
        self.device = torch.device(device)
        self.lmax, self.nmax = lmax, nmax
        self.buoyancy = buoyancy  # 0 disables the r*T*rhat force (conduction limit)
        self.last_run: list = []  # (steps, smallest dt, largest dt) per trajectory of the latest run

        # Dealiased angular grid.
        nphi_grid = 3 * lmax + 3
        nphi_grid += nphi_grid % 2  # rfft-friendly
        self.ang = AngularGrid(nphi_grid, int(np.ceil(1.5 * (lmax + 1))), lmax, device=self.device)
        self.M = self.ang.mmax + 1
        self.L = lmax + 1

        # Radial quadrature (the nonlinear grid and every weak-form integral), 3/2-dealiased.
        nq = (3 * nmax) // 2
        qn, qw = np.polynomial.legendre.leggauss(nq)
        rq, wq = 0.5 * (qn + 1.0), 0.5 * qw
        self.rq, self.nq = rq, nq  # numpy: the quadrature radii

        bT = RadialBasis(lmax, nmax, sigma=0)
        bV = RadialBasis(lmax, nmax, sigma=1, lmin=1)
        self.bT = bT

        # Temperature basis: unconstrained, N modes.
        self.NT = nmax
        ET0 = bT.stack(rq, 0)  # [L, nq, NT]
        ET1 = bT.stack(rq, 1)
        PT = bT.projector(rq, wq)  # initial conditions only
        one = np.array([1.0])
        bT_bnd0 = bT.stack(one, 0)[:, 0]  # psi(1) [L, NT]

        # Velocity bases: raw sigma=+1 functions recombined to satisfy the BCs.
        self.NZ, self.NW = nmax - 1, nmax - 2
        V0q, V1q, V2q = (bV.stack(rq, d) for d in (0, 1, 2))
        v0, v1, v2 = (bV.stack(one, d)[:, 0] for d in (0, 1, 2))  # values at r=1 [L, N]
        L, N = self.L, nmax
        RZ = np.zeros((L, N, self.NZ))  # recombined -> raw coefficients
        RW = np.zeros((L, N, self.NW))
        for l in range(1, L):
            g1 = v1[l] - 2 * v0[l]  # zeta'(1) - 2 zeta(1) functional
            for n in range(self.NZ):
                RZ[l, n, n] = 1.0
                RZ[l, n + 1, n] = -g1[n] / g1[n + 1]
            g2 = v2[l] - 2 * v1[l]  # omega''(1) - 2 omega'(1) functional
            for n in range(self.NW):
                A2 = np.array([[v0[l, n + 1], v0[l, n + 2]], [g2[n + 1], g2[n + 2]]])
                ab = np.linalg.solve(A2, -np.array([v0[l, n], g2[n]]))
                RW[l, n, n] = 1.0
                RW[l, n + 1, n] = ab[0]
                RW[l, n + 2, n] = ab[1]
            # Normalize each recombined function in L2(dr) for conditioning.
            for R in (RZ, RW):
                vals = V0q[l] @ R[l]
                R[l] /= np.maximum(np.sqrt(np.sum(wq[:, None] * vals**2, axis=0)), 1e-300)

        # Effective evaluation tensors for the recombined bases [L, nq, NZ/NW].
        EZ0 = np.einsum("lqn,lnk->lqk", V0q, RZ)
        EZ1 = np.einsum("lqn,lnk->lqk", V1q, RZ)
        EW0 = np.einsum("lqn,lnk->lqk", V0q, RW)
        EW1 = np.einsum("lqn,lnk->lqk", V1q, RW)
        EW2 = np.einsum("lqn,lnk->lqk", V2q, RW)
        zeta_b = np.einsum("ln,lnk->lk", v0, RZ)  # zeta(1)
        omega_b1 = np.einsum("ln,lnk->lk", v1, RW)  # omega'(1)

        # Weak-form matrices per l.
        c = np.arange(L) * (np.arange(L) + 1.0)
        w_r2 = (wq * rq**2)[None, :, None]
        w_1 = wq[None, :, None]
        w_inv2 = (wq / rq**2)[None, :, None]
        MT = np.einsum("lqa,lqb->lab", ET0 * w_r2, ET0)
        KT = np.einsum("lqa,lqb->lab", ET1 * w_r2, ET1) + c[:, None, None] * np.einsum(
            "lqa,lqb->lab", ET0 * w_1, ET0)
        MZ = np.einsum("lqa,lqb->lab", EZ0 * w_1, EZ0)
        KZ = (np.einsum("lqa,lqb->lab", EZ1 * w_1, EZ1)
              + c[:, None, None] * np.einsum("lqa,lqb->lab", EZ0 * w_inv2, EZ0)
              - 2 * np.einsum("la,lb->lab", zeta_b, zeta_b))
        MW = np.einsum("lqa,lqb->lab", EW1 * w_1, EW1) + c[:, None, None] * np.einsum(
            "lqa,lqb->lab", EW0 * w_inv2, EW0)
        DW = EW2 - c[:, None, None] * EW0 / rq[None, :, None] ** 2
        GW = np.einsum("lqa,lqb->lab", DW * w_1, DW) - 2 * np.einsum("la,lb->lab", omega_b1, omega_b1)

        # Internal heating (constant in space: the mean mode) and the flux boundary term.
        heat = KAPPA * T_SOURCE * np.sqrt(4 * np.pi) * (ET0[0].T @ (wq * rq**2))
        flux = KAPPA * (-2.0 * np.sqrt(4 * np.pi)) * bT_bnd0[0]

        # CFL on the resolved scales: a Gauss grid of nmax radii, lmax+1 colatitudes,
        # 2 mmax longitudes (the 3/2-dealiased grid would be 2-4x over-strict).
        r_res = 0.5 * (np.sort(np.polynomial.legendre.leggauss(nmax)[0]) + 1.0)
        cfl_dr = np.interp(rq, r_res, np.gradient(r_res))
        self._cfl_dth = np.pi / (lmax + 1)
        self._cfl_dph = np.pi / max(self.ang.mmax, 1)

        t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=F64, device=self.device)  # noqa: E731
        self.ET0, self.ET1, self.PT = t(ET0), t(ET1), t(PT)
        self.EZ0, self.EZ1, self.EW0, self.EW1, self.EW2 = t(EZ0), t(EZ1), t(EW0), t(EW1), t(EW2)
        self.MT, self.KT, self.MZ, self.KZ, self.MW, self.GW = t(MT), t(KT), t(MZ), t(KZ), t(MW), t(GW)
        # The weak-form integrals' test functions times the quadrature weights.
        self._ET0_w, self._EZ0_w = t(ET0 * w_r2), t(EZ0 * w_1)
        self._EW0_w, self._EW1_w = t(EW0 * w_1), t(EW1 * w_1)
        self._heat, self._flux = t(heat), t(flux)
        self._rq = t(rq)
        self._cfl_dr = t(cfl_dr)
        ls = torch.arange(L, device=self.device)[:, None]
        ms = torch.arange(self.M, device=self.device)[None, :]
        self._keep = (ms <= ls).to(F64)[..., None]  # [L, M, 1]: m <= l
        self._keep_imag = self._keep.clone()
        self._keep_imag[:, 0] = 0.0  # and the m = 0 rows real
        with np.errstate(divide="ignore"):
            self._inv_llp1 = t(np.where(c > 0, 1.0 / np.maximum(c, 1), 0.0))

        self._lu_cache: dict = {}
        self._plan_key = None
        self._plan = None

    # ----------------------------------------------------------------- solve set-up

    def _matrices(self, dt: float) -> dict:
        """LU factors of the SBDF implicit matrices of every l, for SBDF2 and SBDF1:
        ``{field: [(LU, pivots) of SBDF2, of SBDF1]}``, each [L', n, n] with L' the
        degrees the field has (l >= 1 for Z and W)."""
        key = round(float(dt), 14)
        if key not in self._lu_cache:
            mats: dict = {"T": [], "Z": [], "W": []}
            for a0 in (1.5, 1.0):  # SBDF2, SBDF1
                for name, Mass, K, coef, lmin in (("T", self.MT, self.KT, KAPPA, 0),
                                                  ("Z", self.MZ, self.KZ, NU, 1),
                                                  ("W", self.MW, self.GW, NU, 1)):
                    A = (a0 / dt) * Mass[lmin:] + coef * K[lmin:]
                    mats[name].append(torch.linalg.lu_factor(A))
            self._lu_cache[key] = mats
        return self._lu_cache[key]

    def _plan_for(self, dts: Sequence[float], sbdf1: Sequence[bool]):
        """The step's right-hand-side coefficients [B, 4, 1, 1, 1] (of M X, the previous
        M X, F and the previous F) and each field's LU factors stacked over the batch, for
        per-trajectory steps ``dts`` and orders; rebuilt only when these change."""
        key = (tuple(dts), tuple(sbdf1))
        if key != self._plan_key:
            coeffs = [(1 / dt, 0.0, 1.0, 0.0) if first else (2 / dt, -0.5 / dt, 2.0, -1.0)
                      for dt, first in zip(dts, sbdf1)]
            mats = [self._matrices(dt) for dt in dts]
            lus = {name: tuple(torch.stack([m[name][int(first)][k] for m, first in zip(mats, sbdf1)])
                               for k in range(2)) for name in ("T", "Z", "W")}
            used = {round(float(dt), 14) for dt in dts}
            self._lu_cache = {k: v for k, v in self._lu_cache.items() if k in used}
            self._plan_key = key
            self._plan = (torch.tensor(coeffs, dtype=F64, device=self.device)[..., None, None, None], lus)
        return self._plan

    # -------------------------------------------------------------- grid synthesis

    def _radial_eval(self, X, E):
        """coeffs [B, L, M, n] x eval [L, nr, n] -> profiles [B, nr, L, M]."""
        return _bmm_c(X, E.transpose(1, 2)).permute(0, 3, 1, 2)

    def _vector_grid(self, pol_q, dpol_q, tor_q):
        """A solenoidal vector field from potential profiles at the radii rq.

        pol_q / dpol_q / tor_q: [B, nr, L, M] profiles of P, P' and the toroidal
        potential. Returns (F_r, F_theta, F_phi) grids [B, nr, nphi, ntheta].
        """
        rq = self._rq[:, None, None]
        llp1 = self.ang.llp1[None, :, None]
        f_r = self.ang.synthesis(llp1 * pol_q / rq**2)
        s_prof = dpol_q / rq  # S = P'/r
        t_prof = -tor_q / rq  # T = -Z/r
        f_t = self.ang.synthesis_dtheta(s_prof) - self.ang.synthesis_dphi_over_sin(t_prof)
        f_p = self.ang.synthesis_dphi_over_sin(s_prof) + self.ang.synthesis_dtheta(t_prof)
        return f_r, f_t, f_p

    def _qst_analysis(self, f_r, f_t, f_p):
        """Grid vector field -> (Q, S, T) coefficient profiles [B, nr, L, M]."""
        inv_llp1 = self._inv_llp1[None, :, None]
        sin, im = self.ang.sin_theta, self.ang.im
        Q = self.ang.analysis(f_r)
        S = inv_llp1 * (self.ang.analysis_dtheta(f_t) - im * self.ang.analysis(f_p / sin))
        T = inv_llp1 * (im * self.ang.analysis(f_t / sin) + self.ang.analysis_dtheta(f_p))
        return Q, S, T

    # -------------------------------------------------------------- explicit terms

    def _explicit(self, Tc, Wc, Zc):
        """Weak-form forcing integrals (F_T, F_Z, F_W), each [B, L, M, n], and the
        velocity grids."""
        ang = self.ang
        rq = self._rq[:, None, None]
        llp1 = ang.llp1[None, :, None]

        W0 = self._radial_eval(Wc, self.EW0)
        W1 = self._radial_eval(Wc, self.EW1)
        W2 = self._radial_eval(Wc, self.EW2)
        Z0 = self._radial_eval(Zc, self.EZ0)
        Z1 = self._radial_eval(Zc, self.EZ1)
        T0 = self._radial_eval(Tc, self.ET0)
        T1 = self._radial_eval(Tc, self.ET1)

        u_r, u_t, u_p = self._vector_grid(W0, W1, Z0)
        dlW = W2 - llp1 * W0 / rq**2
        o_r, o_t, o_p = self._vector_grid(Z0, Z1, -dlW)

        T_g = ang.synthesis(T0)
        dTr = ang.synthesis(T1)
        dTt = ang.synthesis_dtheta(T0) / rq
        dTp = ang.synthesis_dphi_over_sin(T0) / rq

        # F = r T rhat - omega x u ; temperature advection u . grad T.
        f_r = self.buoyancy * rq * T_g - (o_t * u_p - o_p * u_t)
        f_t = -(o_p * u_r - o_r * u_p)
        f_p = -(o_r * u_t - o_t * u_r)
        adv = u_r * dTr + u_t * dTt + u_p * dTp

        Q, S, Tf = self._qst_analysis(f_r, f_t, f_p)
        adv_lm = ang.analysis(adv)  # [B, nq, L, M]

        # Weak-form forcing integrals (quadrature over r).
        to_lmq = lambda x: x.permute(0, 2, 3, 1)  # [B, q, L, M] -> [B, L, M, q]  # noqa: E731
        F_T = -_bmm_c(to_lmq(adv_lm), self._ET0_w)
        F_T[:, 0, 0] += self._heat
        F_T[:, 0, 0] += self._flux
        F_Z = -_bmm_c(to_lmq(rq * Tf), self._EZ0_w)
        # Poloidal: the equation for -D_l W is tested with omega, so the weak RHS is
        # -<omega, E> with E = -(Q - d_r(rS)); by parts this is +<omega, Q> + <omega', rS>.
        F_W = _bmm_c(to_lmq(Q), self._EW0_w) + _bmm_c(to_lmq(rq * S), self._EW1_w)
        return F_T, F_Z, F_W, (u_r, u_t, u_p)

    # -------------------------------------------------------------- time stepping

    def _apply(self, Mats, X):
        """Batched per-l matrix application: [L, a, b] x [B, L, M, b] -> [B, L, M, a]."""
        return _bmm_c(X, Mats.transpose(1, 2))

    def _solve(self, lu, rhs, lmin: int):
        """The per-l LU solves of all trajectories at once: rhs [B, L, M, n] ->
        coefficients [B, L, M, n], zero below ``lmin``."""
        LU, piv = lu
        R = rhs[:, lmin:].transpose(-1, -2)  # [B, L', n, M]
        M = R.shape[-1]
        X = torch.linalg.lu_solve(LU, piv, torch.cat([R.real, R.imag], dim=-1))
        X = torch.complex(X[..., :M], X[..., M:]).transpose(-1, -2)
        if lmin:
            X = torch.cat([torch.zeros_like(rhs[:, :lmin]), X], dim=1)
        return X

    def _mask(self, X):
        """Zero coefficients with m > l, and keep the m = 0 rows real."""
        return torch.complex(X.real * self._keep, X.imag * self._keep_imag)

    def initial_condition(self, seeds: Sequence[int], scale: float = 0.1):
        """Reference IC per seed: normal grid noise (``RandomState(seed)``) low-passed to
        half resolution, plus (1 - r^2). Returns (Tc, Wc, Zc), each [B, L, M, n]."""
        noise = np.stack([np.random.RandomState(int(s) % (2**31 - 1)).normal(
            scale=scale, size=(self.nq, self.ang.nphi, self.ang.ntheta)) for s in seeds])
        n_lm = self.ang.analysis(torch.tensor(noise, dtype=F64, device=self.device))
        n_lm = n_lm * (torch.arange(self.L, device=self.device) <= self.lmax // 2)[:, None]
        Tc = _bmm_c(n_lm.permute(0, 2, 3, 1), self.PT.transpose(1, 2))  # [B, L, M, NT]
        Tc[..., self.nmax // 2:] = 0.0
        # Conductive equilibrium on the mean mode.
        Tc[:, 0, 0] += self.PT[0] @ (np.sqrt(4 * np.pi) * (1.0 - self._rq**2))
        B = len(seeds)
        zeros = lambda n: torch.zeros(B, self.L, self.M, n, dtype=torch.complex128, device=self.device)  # noqa: E731
        return self._mask(Tc), zeros(self.NW), zeros(self.NZ)

    def _cfl_dt(self, u_grids):
        """Advective CFL on the resolved scales, one dt per trajectory (one host read)."""
        u_r, u_t, u_p = u_grids
        rq = self._rq[:, None, None]
        freq = (u_r.abs() / self._cfl_dr[:, None, None] + u_t.abs() / (rq * self._cfl_dth)
                + u_p.abs() / torch.clamp(rq * self.ang.sin_theta * self._cfl_dph, min=1e-9))
        return [MAX_DT if f <= 0 else float(np.clip(CFL_SAFETY / f, MIN_DT, MAX_DT))
                for f in freq.amax(dim=(1, 2, 3)).tolist()]

    @torch.no_grad()
    def simulate(self, seeds: Sequence[int], stop_time: float = 12.0, record_interval: float = 0.2,
                 t_start_record: float = 2.0, num_frames: int = 20, out_grid: "BallOutputGrid | None" = None,
                 on_step=None, ic=None) -> torch.Tensor:
        """Run one trajectory per seed as one batch; frames on the output grid
        [B, num_frames, nphi, ntheta, nr] (float64, on the device).

        Each trajectory adopts a new CFL dt (checked every ``CFL_CADENCE`` steps) only
        when it differs by more than 10 %, restarting its SBDF2 history with an SBDF1
        step, and leaves the batch when it has recorded ``num_frames`` frames or reached
        ``stop_time``; ``last_run`` then holds each trajectory's steps and dt range.
        ``ic`` replaces the seeded initial state; ``on_step(step, t, dt, solver, Tc, Wc,
        Zc)`` sees the trajectories still advancing after every step (``t`` and ``dt``
        lists, one entry per row of the states).
        """
        Tc, Wc, Zc = ic if ic is not None else self.initial_condition(seeds)
        B = Tc.shape[0]
        out_grid = out_grid or BallOutputGrid(self)
        record_times = t_start_record + record_interval * np.arange(num_frames)
        frames = [[] for _ in range(B)]
        t, dt, next_rec = [0.0] * B, [MAX_DT] * B, [0] * B
        steps, dt_lo, dt_hi = [0] * B, [MAX_DT] * B, [0.0] * B
        sbdf1 = [True] * B  # no SBDF2 history yet
        active = list(range(B))  # the trajectory in each row of the states
        X_prev = E_prev = None
        step = 0

        while active:
            F_T, F_Z, F_W, u_grids = self._explicit(Tc, Wc, Zc)
            if step % CFL_CADENCE == 0:
                for i, new_dt in zip(active, self._cfl_dt(u_grids)):
                    # Adopt only significant changes; a changed dt invalidates the SBDF2
                    # history weighting -> restart with SBDF1.
                    if abs(new_dt - dt[i]) > 0.1 * dt[i]:
                        dt[i], sbdf1[i] = new_dt, True
            coeffs, lus = self._plan_for([dt[i] for i in active], [sbdf1[i] for i in active])

            X = (self._apply(self.MT, Tc), self._apply(self.MZ, Zc), self._apply(self.MW, Wc))
            E = (F_T, F_Z, F_W)
            if X_prev is None:
                X_prev, E_prev = [torch.zeros_like(x) for x in X], [torch.zeros_like(e) for e in E]
            rhs = [coeffs[:, 0] * x + coeffs[:, 1] * xp + coeffs[:, 2] * e + coeffs[:, 3] * ep
                   for x, xp, e, ep in zip(X, X_prev, E, E_prev)]
            X_prev, E_prev = X, E

            Tc = self._mask(self._solve(lus["T"], rhs[0], 0))
            Zc = self._mask(self._solve(lus["Z"], rhs[1], 1))
            Wc = self._mask(self._solve(lus["W"], rhs[2], 1))
            step += 1
            for i in active:
                t[i] += dt[i]
                sbdf1[i] = False
                steps[i] += 1
                dt_lo[i], dt_hi[i] = min(dt_lo[i], dt[i]), max(dt_hi[i], dt[i])
            if on_step is not None:
                on_step(step, [t[i] for i in active], [dt[i] for i in active], self, Tc, Wc, Zc)

            for row, i in enumerate(active):
                while next_rec[i] < num_frames and t[i] >= record_times[next_rec[i]] - 1e-9:
                    frames[i].append(out_grid.temperature(self, Tc[row:row + 1])[0])
                    next_rec[i] += 1
            keep = [row for row, i in enumerate(active) if t[i] < stop_time - 1e-12 and next_rec[i] < num_frames]
            if len(keep) < len(active):
                rows = torch.tensor(keep, dtype=torch.long, device=self.device)
                Tc, Wc, Zc = (x.index_select(0, rows) for x in (Tc, Wc, Zc))
                X_prev = [x.index_select(0, rows) for x in X_prev]
                E_prev = [e.index_select(0, rows) for e in E_prev]
                active = [active[row] for row in keep]

        self.last_run = list(zip(steps, dt_lo, dt_hi))
        for f in frames:  # safety: pad with the last frame
            f.extend(f[-1:] * (num_frames - len(f)))
        return torch.stack([torch.stack(f) for f in frames])


class BallOutputGrid:
    """Synthesis tables for the reference output grid: uniform phi (48), uniform theta
    in (0, pi) (24), r = linspace(0, 1, 24) (matches ``data.ball_coords``)."""

    def __init__(self, solver: BallConvectionSolver, nphi: int = 48, ntheta: int = 24, nr: int = 24):
        self.nphi, self.ntheta, self.nr = nphi, ntheta, nr
        self.theta = np.linspace(1e-3, np.pi, ntheta, endpoint=False)
        self.r = np.linspace(0, 1, nr)
        self.mmax = solver.ang.mmax
        P = legendre_table(solver.lmax, np.cos(self.theta))[:, : self.mmax + 1, :]  # [L, M, ntheta]
        t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=F64, device=solver.device)  # noqa: E731
        self.P_out = t(P.transpose(1, 0, 2))  # [M, L, ntheta]
        self.ET_out = t(solver.bT.stack(self.r, 0))  # [L, nr, N]

    def temperature(self, solver: BallConvectionSolver, Tc: torch.Tensor) -> torch.Tensor:
        """[B, nphi, ntheta, nr] grid values of the temperature coefficients Tc [B, L, M, N]."""
        prof = _bmm_c(Tc, self.ET_out.transpose(1, 2))  # [B, L, M, nr]
        B, L, M, nr = prof.shape
        pm = prof.permute(2, 0, 3, 1).reshape(M, B * nr, L)  # [M, B nr, L]
        g_m = _bmm_c(pm, self.P_out).reshape(M, B, nr, self.ntheta).permute(1, 2, 0, 3)  # [B, nr, M, ntheta]
        pad = self.nphi // 2 + 1 - (self.mmax + 1)
        if pad > 0:
            g_m = torch.nn.functional.pad(g_m, (0, 0, 0, pad))
        grid = torch.fft.irfft(g_m * self.nphi, n=self.nphi, dim=-2)  # [B, nr, nphi, ntheta]
        return grid.movedim(1, -1)
