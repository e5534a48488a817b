"""Numeric equivariance checks on a decoder.

Counterpart of ``enf_pde_tpu/utils/equivariance.py`` (reference: the visual check of
``_base_pde_trainer.py:731-757``): transform latent poses and query coordinates
together and measure the decode discrepancy, as a relative error. ``decoder_apply``
is ``decoder_apply(coords, p, a, window) -> values`` (the module holds its weights;
the JAX functions take the parameters first).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from enf_pde_tpu_torch.geometry.invariants import (
    AbsolutePositionND,
    BallInvariant,
    RelativePositionPolarPeriodic,
    euler_zyx_matrix,
)

__all__ = [
    "equivariance_errors",
    "equivariance_errors_2d",
    "equivariance_errors_sphere",
    "equivariance_errors_ball",
]

DecoderApply = Callable[..., torch.Tensor]


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / (a.abs().max() + 1e-12))


# ------------------------------------------------------------------ S^2 / B^3 helpers


def _angles_to_vec(ang: torch.Tensor) -> torch.Tensor:
    """(phi, theta) spherical angles [..., 2] -> unit vectors [..., 3]."""
    phi, theta = ang[..., 0], ang[..., 1]
    return torch.stack(
        [torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi), torch.cos(theta)],
        dim=-1,
    )


def _vec_to_angles(v: torch.Tensor) -> torch.Tensor:
    """Unit vectors [..., 3] -> (phi in [0, 2pi), theta in [0, pi]) [..., 2]."""
    phi = torch.remainder(torch.atan2(v[..., 1], v[..., 0]), 2 * math.pi)
    theta = torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))
    return torch.stack([phi, theta], dim=-1)


def _rotation_matrix(a: float = 0.7, b: float = 0.4, c: float = 0.2) -> torch.Tensor:
    """A fixed generic SO(3) element Rz(a) @ Ry(b) @ Rz(c)."""

    def rz(t):
        return torch.tensor(
            [[math.cos(t), -math.sin(t), 0.0], [math.sin(t), math.cos(t), 0.0], [0.0, 0.0, 1.0]]
        )

    ry = torch.tensor(
        [[math.cos(b), 0.0, math.sin(b)], [0.0, 1.0, 0.0], [-math.sin(b), 0.0, math.cos(b)]]
    )
    return rz(a) @ ry @ rz(c)


def _matrix_to_euler_zyx(M: torch.Tensor):
    """Inverse of ``euler_zyx_matrix`` (generic branch; gimbal lock unhandled)."""
    beta = torch.arcsin(torch.clamp(-M[..., 2, 0], -1.0, 1.0))
    alpha = torch.atan2(M[..., 1, 0], M[..., 0, 0])
    gamma = torch.atan2(M[..., 2, 1], M[..., 2, 2])
    return alpha, beta, gamma


@torch.no_grad()
def equivariance_errors_2d(decoder_apply: DecoderApply, coords, p, a, window,
                           has_orientation: bool, periodic: bool,
                           translation=(0.31, -0.17), angle: float = math.pi / 6) -> Dict[str, float]:
    """Relative decode errors under joint (coords, poses) transformations.

    For an equivariant decoder, ``f(g x; g p, a) == f(x; p, a)``: translations for
    translation-invariant geometries, rotations when poses carry orientation.

    Args:
        coords: [b, n, 2]; p: [b, z, pose_dim]; a / window: latents.
        has_orientation: p[..., 2:] holds an angle (SE(2) geometries).
        periodic: the domain is the [-1, 1] torus (translations wrap).

    Returns:
        dict with 'translation' and (if oriented) 'rotation' relative errors.
    """
    base = decoder_apply(coords, p, a, window)
    out: Dict[str, float] = {}

    t = torch.tensor(translation, dtype=coords.dtype, device=coords.device)
    coords_t = coords + t
    p_t = p.clone()
    p_t[..., :2] += t  # angular pose components (if any) are untouched
    if periodic:
        coords_t = (coords_t + 1) % 2 - 1
        p_t[..., :2] = (p_t[..., :2] + 1) % 2 - 1
    out["translation"] = _rel_err(base, decoder_apply(coords_t, p_t, a, window))

    if has_orientation:
        R = torch.tensor([[math.cos(angle), -math.sin(angle)], [math.sin(angle), math.cos(angle)]],
                         dtype=coords.dtype, device=coords.device)
        coords_r = coords @ R.T
        p_r = torch.cat([p[..., :2] @ R.T, p[..., 2:] + angle], dim=-1)
        out["rotation"] = _rel_err(base, decoder_apply(coords_r, p_r, a, window))
    return out


@torch.no_grad()
def equivariance_errors_sphere(decoder_apply: DecoderApply, coords, p, a, window,
                               full_so3: bool, lon_shift: float = 0.83) -> Dict[str, float]:
    """Decode errors on S^2 under joint (coords, poses) rotations.

    Coordinates and poses are (phi, theta) spherical angles. The SO(3)-invariant
    geometry (``polar_periodic``) gets a generic rotation of both through unit
    vectors; every geometry gets a longitude shift (all that ``latitude_periodic``
    claims).
    """
    base = decoder_apply(coords, p, a, window)
    out: Dict[str, float] = {}

    coords_l, p_l = coords.clone(), p.clone()
    coords_l[..., 0] += lon_shift
    p_l[..., 0] += lon_shift
    out["longitude"] = _rel_err(base, decoder_apply(coords_l, p_l, a, window))

    if full_so3:
        Q = _rotation_matrix().to(coords)
        coords_r = _vec_to_angles(_angles_to_vec(coords) @ Q.T)
        p_r = _vec_to_angles(_angles_to_vec(p[..., :2]) @ Q.T)
        out["rotation"] = _rel_err(base, decoder_apply(coords_r, p_r, a, window))
    return out


@torch.no_grad()
def equivariance_errors_ball(decoder_apply: DecoderApply, coords, p, a, window,
                             euler_poses: bool, lon_shift: float = 0.83) -> Dict[str, float]:
    """Decode errors on the solid ball B^3 under joint rotations.

    Coordinates are (phi, theta, r); poses are (alpha, beta, gamma, r) Euler angles
    (``euler_poses=True``, the ``ball`` invariant) or (phi, theta, <unused>, r)
    (``ball_lat``). For ``ball`` the pose rotation transforms as R -> R @ Q^T; its
    window reuses (alpha, beta) as sphere angles (reference ``ball.py:36-52``) and is
    not equivariant under that recomposition, so the rotation error measures that
    quirk of the reference architecture. For ``ball_lat`` the longitude shift is exact.
    """
    base = decoder_apply(coords, p, a, window)
    out: Dict[str, float] = {}

    if euler_poses:
        Q = _rotation_matrix().to(coords)
        dirs = _vec_to_angles(_angles_to_vec(coords[..., :2]) @ Q.T)
        coords_r = torch.cat([dirs, coords[..., 2:3]], dim=-1)
        R = euler_zyx_matrix(p[..., 0], p[..., 1], p[..., 2])
        alpha, beta, gamma = _matrix_to_euler_zyx(R @ Q.T)
        p_r = torch.stack([alpha, beta, gamma, p[..., 3]], dim=-1)
        out["rotation"] = _rel_err(base, decoder_apply(coords_r, p_r, a, window))
    else:
        coords_l, p_l = coords.clone(), p.clone()
        coords_l[..., 0] += lon_shift
        p_l[..., 0] += lon_shift
        out["longitude"] = _rel_err(base, decoder_apply(coords_l, p_l, a, window))
    return out


def equivariance_errors(decoder_apply: DecoderApply, coords, p, a, window, invariant,
                        coordinate_system: str) -> Dict[str, float]:
    """Dispatch the numeric equivariance check on the trained geometry.

    ``invariant`` is the decoder's cross-attention invariant (its class decides which
    group actions the architecture claims); ``coordinate_system`` the dataset's. On the
    sphere the SO(3)-invariant ``polar_periodic`` geometry gets the rotation check too.
    On the ball the Euler-angle ``ball`` invariant gets the joint rotation, ``ball_lat`` the
    longitude shift. The non-equivariant ``abs_pos`` ablation claims no group action: ``{}``.
    """
    if isinstance(invariant, AbsolutePositionND):
        return {}
    if coordinate_system == "cartesian":
        return equivariance_errors_2d(decoder_apply, coords, p, a, window,
                                      has_orientation=invariant.num_z_ori_dims > 0,
                                      periodic=invariant.is_periodic)
    if coordinate_system == "polar":
        return equivariance_errors_sphere(decoder_apply, coords, p, a, window,
                                          full_so3=isinstance(invariant, RelativePositionPolarPeriodic))
    if coordinate_system == "ball":
        return equivariance_errors_ball(decoder_apply, coords, p, a, window,
                                        euler_poses=isinstance(invariant, BallInvariant))
    raise ValueError(f"Unknown coordinate system: {coordinate_system!r}")
