"""Scalar spherical-harmonic transforms on a Gauss-Legendre x uniform-phi grid.

Counterpart of ``enf_pde_tpu/data/sphere_harmonics.py``. Analysis and synthesis are an
FFT over longitude (``torch.fft.rfft`` / ``irfft``) and, per order m, a product with a
table of normalized associated Legendre functions, exact for band-limited fields
(Gauss-Legendre quadrature in cos(theta) integrates polynomials up to degree
``2 ntheta - 1`` exactly). The tables are computed in float64 numpy and held in f32 on
the grid's device, as the JAX package holds them; the products run in f32 with TF32 off
(``strict_fp32``): one batched real matrix product over the orders m, the real and
imaginary parts of every field side by side as its columns, against tables laid out
m-major once, so that a transform is a few launches and no ``einsum`` planning.

Used by the sphere-diffusion dataset (the heat kernel is diagonal in the SH basis:
``f_lm(t) = f_lm(0) exp(-D l (l+1) t)``); the theta-derivative tables serve the
spherical shallow-water solver.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from enf_pde_tpu_torch.ops.fused_decode import strict_fp32

__all__ = ["SphereGrid", "legendre_table"]


def legendre_table(lmax: int, x: np.ndarray) -> np.ndarray:
    """Orthonormal associated Legendre functions ``Pbar[l, m, j]`` at nodes ``x``.

    Normalized so that ``2 pi * sum_j w_j Pbar[l,m] Pbar[l',m] = delta_ll'`` with
    Gauss-Legendre weights w, i.e. the spherical harmonics
    ``Y_lm = Pbar_l^m(cos theta) e^{i m phi}`` are orthonormal on the sphere.
    Computed with the standard stable recurrences in float64.
    """
    x = np.asarray(x, dtype=np.float64)
    J = x.shape[0]
    s = np.sqrt(1.0 - x * x)
    P = np.zeros((lmax + 1, lmax + 1, J))
    P[0, 0] = np.sqrt(1.0 / (4.0 * np.pi))
    for m in range(1, lmax + 1):
        P[m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * s * P[m - 1, m - 1]
    for m in range(0, lmax):
        P[m + 1, m] = np.sqrt(2 * m + 3.0) * x * P[m, m]
    for m in range(0, lmax + 1):
        for l in range(m + 2, lmax + 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            P[l, m] = a * (x * P[l - 1, m] - b * P[l - 2, m])
    return P


def _per_order(table_m: torch.Tensor, coeffs: torch.Tensor, analysis: bool) -> torch.Tensor:
    """``out[..., m, r] = sum_k table_m[m, r, k] coeffs[..., m, k]`` for a real f32 table
    [M, R, K] and complex coefficients: one ``bmm`` over the orders m, the real and
    imaginary parts of every field as its columns (no TF32). Analysis takes modes
    [..., M, K] to [..., R, M]; synthesis coefficients [..., K, M] to [..., M, R]."""
    strict_fp32()
    M, R, K = table_m.shape
    lead = coeffs.shape[:-2]
    x = torch.view_as_real(coeffs).reshape(-1, *coeffs.shape[-2:], 2)
    x = x.permute(1, 2, 0, 3) if analysis else x.permute(2, 1, 0, 3)  # [M, K, fields, 2]
    y = torch.bmm(table_m, x.reshape(M, K, -1)).reshape(M, R, -1, 2)
    y = y.permute(2, 1, 0, 3) if analysis else y.permute(2, 0, 1, 3)
    return torch.view_as_complex(y.contiguous()).reshape(*lead, *y.shape[1:3])


class SphereGrid:
    """A (phi, theta) grid with SH analysis and synthesis.

    phi: ``nphi`` uniform points in [0, 2pi); theta: ``ntheta`` Gauss-Legendre
    colatitude nodes. Fields are laid out ``[..., nphi, ntheta]`` (longitude first).
    ``phi``, ``theta``, ``x`` and ``w`` are float64 numpy arrays; the tables live on
    ``device`` in f32.
    """

    def __init__(self, nphi: int, ntheta: int, lmax: int | None = None, device="cuda"):
        self.nphi = nphi
        self.ntheta = ntheta
        self.lmax = lmax if lmax is not None else ntheta - 1
        if self.lmax >= ntheta:
            raise ValueError(f"lmax ({self.lmax}) must be < ntheta ({ntheta}) for exact quadrature.")
        self.mmax = min(self.lmax, nphi // 2)
        self.device = torch.device(device)
        f32 = dict(dtype=torch.float32, device=self.device)

        nodes, weights = np.polynomial.legendre.leggauss(ntheta)
        # Descending in x = cos(theta): theta ascending from 0 to pi.
        order = np.argsort(-nodes)
        self.x = nodes[order]
        self.w = weights[order]
        self.theta = np.arccos(self.x)
        self.phi = 2 * np.pi * np.arange(nphi) / nphi

        # One extra degree, so that the theta-derivative recurrence has P_{l+1}.
        P_ext = legendre_table(self.lmax + 1, self.x)  # [L+2, L+2, J]
        P = P_ext[: self.lmax + 1, : self.mmax + 1, :]
        self._P = torch.tensor(P, **f32)  # [L, M, J]
        self._Pw = torch.tensor(P * self.w[None, None, :], **f32)
        # m-major copies for the products: synthesis sums over l, analysis over j.
        self._P_syn = self._P.permute(1, 2, 0).contiguous()  # [M, J, L]
        self._Pw_ana = self._Pw.permute(1, 0, 2).contiguous()  # [M, L, J]

        # d Pbar_l^m / d theta by the normalized recurrence
        #   sin(theta) dP_l^m/dtheta = l eps_{l+1}^m P_{l+1}^m - (l+1) eps_l^m P_{l-1}^m,
        # eps_l^m = sqrt((l^2 - m^2) / (4 l^2 - 1)).
        L1 = self.lmax + 2
        ls_f = np.arange(L1, dtype=np.float64)[:, None]
        ms_f = np.arange(L1, dtype=np.float64)[None, :]
        with np.errstate(invalid="ignore", divide="ignore"):
            eps = np.sqrt(np.maximum(ls_f**2 - ms_f**2, 0.0) / np.maximum(4.0 * ls_f**2 - 1.0, 1e-300))
        sin_t = np.sqrt(1.0 - self.x**2)
        H = np.zeros((self.lmax + 1, self.lmax + 1, ntheta))
        for m in range(self.lmax + 1):
            for l in range(m, self.lmax + 1):
                up = l * eps[l + 1, m] * P_ext[l + 1, m]
                down = (l + 1) * eps[l, m] * (P_ext[l - 1, m] if l >= 1 else 0.0)
                H[l, m] = (up - down) / sin_t
        self._H = torch.tensor(H[:, : self.mmax + 1, :], **f32)
        self._Hw = self._H * torch.tensor(self.w, **f32)[None, None, :]  # f32 product, as JAX's
        self._H_syn = self._H.permute(1, 2, 0).contiguous()
        self._Hw_ana = self._Hw.permute(1, 0, 2).contiguous()

        self.sin_theta = torch.tensor(sin_t, **f32)
        ls = np.arange(self.lmax + 1)
        self.l_values = torch.tensor(ls, dtype=torch.int32, device=self.device)
        self.m_values = torch.arange(self.mmax + 1, dtype=torch.int32, device=self.device)
        self._im = 1j * self.m_values.to(torch.float32)  # d/dphi of e^{i m phi}, complex64
        self.laplacian_eig = torch.tensor(-ls * (ls + 1.0), **f32)  # on the unit sphere

    # -- transforms --------------------------------------------------------

    def _modes(self, f: torch.Tensor) -> torch.Tensor:
        """The longitude Fourier modes m = 0..mmax of f: [..., mmax+1, ntheta], complex."""
        return (torch.fft.rfft(f, dim=-2) / self.nphi)[..., : self.mmax + 1, :]

    def _to_grid(self, g_m: torch.Tensor) -> torch.Tensor:
        """Modes [..., mmax+1, ntheta] (zero above mmax) -> field [..., nphi, ntheta]."""
        pad = self.nphi // 2 + 1 - (self.mmax + 1)
        if pad > 0:
            g_m = torch.nn.functional.pad(g_m, (0, 0, 0, pad))
        return torch.fft.irfft(g_m * self.nphi, n=self.nphi, dim=-2)

    def analysis(self, f: torch.Tensor) -> torch.Tensor:
        """Field [..., nphi, ntheta] -> SH coefficients [..., lmax+1, mmax+1] (complex):
        ``f_lm = 2 pi sum_j w_j Pbar[l, m, j] c_m[..., m, j]``."""
        return 2 * math.pi * _per_order(self._Pw_ana, self._modes(f), analysis=True)

    def synthesis(self, flm: torch.Tensor) -> torch.Tensor:
        """SH coefficients [..., lmax+1, mmax+1] -> field [..., nphi, ntheta]."""
        return self._to_grid(_per_order(self._P_syn, flm, analysis=False))

    def synthesis_dtheta(self, flm: torch.Tensor) -> torch.Tensor:
        """Colatitude derivative: coefficients -> d(field)/d(theta) on the grid."""
        return self._to_grid(_per_order(self._H_syn, flm, analysis=False))

    def analysis_dtheta_flux(self, a: torch.Tensor) -> torch.Tensor:
        """SH coefficients of ``(1/sin t) d(a sin t)/dt`` by integration by parts:
        ``< (1/sin t) d(a sin t)/dt, Y*_lm > = - < a, dY*_lm/dt >`` (the boundary term
        vanishes at the poles), an analysis with the theta-derivative table."""
        return -2 * math.pi * _per_order(self._Hw_ana, self._modes(a), analysis=True)

    def dphi_coeffs(self, flm: torch.Tensor) -> torch.Tensor:
        """Longitude derivative in spectral space: multiply by i m."""
        return flm * self._im

    def filter_lowpass(self, f: torch.Tensor, lcut: int) -> torch.Tensor:
        """Zero all SH modes with l > lcut."""
        flm = self.analysis(f)
        mask = (self.l_values <= lcut)[:, None]
        return self.synthesis(flm * mask)

    # -- diffusion ----------------------------------------------------------

    def diffuse(self, f: torch.Tensor, D: float, t) -> torch.Tensor:
        """Exact heat-equation evolution of f [..., nphi, ntheta] at times ``t`` [T]:
        fields [T, ..., nphi, ntheta]."""
        flm = self.analysis(f)
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        decay = torch.exp(self.laplacian_eig[None, :] * D * t[:, None])  # [T, L]
        evolved = flm[None] * decay.reshape(len(t), *([1] * (flm.dim() - 2)), self.lmax + 1, 1)
        return self.synthesis(evolved)
