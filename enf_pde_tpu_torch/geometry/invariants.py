"""Bi-invariant geometry functions between query coordinates and latent point poses.

Counterpart of ``enf_pde_tpu/geometry/invariants.py``. Each invariant maps
``(x[b, n, x_dim], p[b, z, p_dim]) -> inv[b, n, z, dim]`` and provides the Gaussian
window that is added to the attention logits. Ported: the paper's ablations on R^n
(``rel_pos``, x - p; ``norm_rel_pos``, ||p - x||, I = 1; and the non-equivariant
``abs_pos``, x itself), the torus invariant of the Navier-Stokes experiment, the SE(2) ``ponita`` pair of the planar experiments
(``PonitaPos2D`` for cross attention, whose queries carry no orientation, ``Ponita2D``
for the latent ODE), the SO(3) ``polar_periodic`` invariant on S^2 (the cosine of
the great-circle angle, I = 1) and the longitude-only ``latitude_periodic`` one
(``[theta_x, theta_p, cos dphi, sin dphi]``, I = 4), and on the solid ball the SO(3)
``ball`` invariant (the query direction rotated into the latent's Z-Y-X Euler frame and
both radii, I = 5) and the longitude-only ``ball_lat`` one (I = 6). An unknown name
raises ``ValueError``.

The window flavours are part of the trained-model contract: the planar default is the
log-domain ``-(1/sigma^2) * d^2``; the torus window is ``+(1/sigma^2) * sum cos^2(pi*d)``;
the sphere window is probability-domain, ``exp(-d^2 / (2 sigma^2))`` with d the
great-circle distance (its arccos clipped away from +-1), and is added all the same.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "BaseInvariant",
    "RelativePositionND",
    "NormRelativePositionND",
    "AbsolutePositionND",
    "RelativePositionPeriodic",
    "PonitaPos2D",
    "Ponita2D",
    "RelativePositionPolarPeriodic",
    "RelativeLatitudePeriodic",
    "BallInvariant",
    "BallLatInvariant",
    "euler_zyx_matrix",
    "get_sa_invariant",
    "get_ca_invariant",
]


def _sq_dist(x_pos, p_pos):
    """Squared euclidean distance, broadcast to [b, n, z, 1]."""
    return torch.sum((p_pos[:, None, :, :] - x_pos[:, :, None, :]) ** 2, dim=-1, keepdim=True)


def _sphere_unit_vec(phi, theta):
    """(phi, theta) spherical angles -> unit vectors on S^2, stacked on the last axis."""
    return torch.stack(
        [torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi), torch.cos(theta)],
        dim=-1,
    )


def _great_circle_cos(x_ang, p_ang):
    """Cosine of the great-circle angle between angular coords [b, n, 2] and [b, z, 2]
    (``[..., 0] = phi``, the longitude; ``[..., 1] = theta``, the colatitude): [b, n, z, 1]."""
    xv = _sphere_unit_vec(x_ang[:, :, 0], x_ang[:, :, 1])
    pv = _sphere_unit_vec(p_ang[:, :, 0], p_ang[:, :, 1])
    cos = torch.einsum("bnd,bmd->bnm", xv, pv)
    norm = torch.linalg.norm(xv, dim=-1)[:, :, None] * torch.linalg.norm(pv, dim=-1)[:, None, :]
    return (cos / norm)[:, :, :, None]


def _sphere_window(cos_ang, sigma):
    """exp(-d^2 / 2 sigma^2) with d the clipped great-circle distance; sigma [b, z, 1]."""
    dist = torch.arccos(torch.clamp(cos_ang, -1 + 1e-6, 1 - 1e-6))
    return torch.exp(-(dist ** 2) / (2 * sigma[:, None, :, :] ** 2))


@dataclasses.dataclass(frozen=True)
class BaseInvariant:
    """Static metadata + window dispatch shared by all invariants.

    Attributes:
        dim: dimensionality of the produced invariant feature.
        num_x_pos_dims / num_x_ori_dims: positional / orientation dims of queries.
        num_z_pos_dims / num_z_ori_dims: positional / orientation dims of latent poses.
        is_periodic: whether the underlying domain is periodic.
    """

    dim: int = 0
    num_x_pos_dims: int = 0
    num_x_ori_dims: int = 0
    num_z_pos_dims: int = 0
    num_z_ori_dims: int = 0
    is_periodic: bool = False

    def __call__(self, x, p):
        raise NotImplementedError

    def gaussian_window(self, x, p, sigma):
        """Additive attention-logit bias. Default: non-periodic log-domain window."""
        p_pos = p[:, :, : self.num_z_pos_dims]
        x_pos = x[:, :, : self.num_x_pos_dims]
        return -(1.0 / sigma[:, None, :] ** 2) * _sq_dist(x_pos, p_pos)


@dataclasses.dataclass(frozen=True)
class RelativePositionND(BaseInvariant):
    """Translation invariant on R^n: x - p. Planar log-domain window."""

    def __init__(self, num_dims: int):
        super().__init__(dim=num_dims, num_x_pos_dims=num_dims, num_x_ori_dims=0,
                         num_z_pos_dims=num_dims, num_z_ori_dims=0)

    def __call__(self, x, p):
        return x[:, :, None, : self.num_x_pos_dims] - p[:, None, :, : self.num_z_pos_dims]


@dataclasses.dataclass(frozen=True)
class NormRelativePositionND(BaseInvariant):
    """E(n)-invariant distance ||p - x|| (I = 1). Planar log-domain window.

    At a coincident point its gradient is 0 here (``torch.linalg.vector_norm``) where
    ``jnp.linalg.norm``'s is NaN; everywhere else the two agree."""

    def __init__(self, num_dims: int):
        super().__init__(dim=1, num_x_pos_dims=num_dims, num_x_ori_dims=0,
                         num_z_pos_dims=num_dims, num_z_ori_dims=0)

    def __call__(self, x, p):
        return torch.linalg.vector_norm(p[:, None, :, :] - x[:, :, None, :], dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class AbsolutePositionND(BaseInvariant):
    """Non-equivariant ablation: the query's absolute coordinates, the same for every
    latent. The window still depends on x - p (planar log-domain)."""

    def __init__(self, num_dims: int):
        super().__init__(dim=num_dims, num_x_pos_dims=num_dims, num_x_ori_dims=0,
                         num_z_pos_dims=num_dims, num_z_ori_dims=0)

    def __call__(self, x, p):
        b, n, d = x.shape
        return x[:, :, None, :].expand(b, n, p.shape[1], d)


@dataclasses.dataclass(frozen=True)
class RelativePositionPeriodic(BaseInvariant):
    """Translation invariant on the torus T^n over [-1, 1]^n: [cos(pi*d), sin(pi*d)]."""

    def __init__(self, num_dims: int):
        super().__init__(
            dim=2 * num_dims,
            num_x_pos_dims=num_dims,
            num_x_ori_dims=0,
            num_z_pos_dims=num_dims,
            num_z_ori_dims=0,
            is_periodic=True,
        )

    def __call__(self, x, p):
        rel = p[:, None, :, :] - x[:, :, None, :]
        return torch.cat([torch.cos(math.pi * rel), torch.sin(math.pi * rel)], dim=-1)

    def gaussian_window(self, x, p, sigma):
        p_pos = p[:, :, : self.num_z_pos_dims]
        x_pos = x[:, :, : self.num_x_pos_dims]
        rel = p_pos[:, None, :, :] - x_pos[:, :, None, :]
        neg_cos_sq = -torch.sum(torch.cos(math.pi * rel) ** 2, dim=-1, keepdim=True)
        return -(1.0 / sigma[:, None, :] ** 2) * neg_cos_sq


def _rotate_into_frame(x_pos, p):
    """Relative position x - p rotated into the latent's frame: [b, n, z, 2].

    ``p`` is [b, z, 4] with the orientation embedded as (cos t, sin t)."""
    rel = x_pos[:, :, None, :] - p[:, None, :, :2]
    cos_t, sin_t = p[:, None, :, 2], p[:, None, :, 3]
    return torch.stack([rel[..., 0] * cos_t + rel[..., 1] * sin_t,
                        -rel[..., 0] * sin_t + rel[..., 1] * cos_t], dim=-1)


@dataclasses.dataclass(frozen=True)
class PonitaPos2D(BaseInvariant):
    """SE(2) position-only invariant: the relative position in the latent's frame.

    Latent poses are (x, y, cos t, sin t), queries positions only (cross attention).
    Planar log-domain window."""

    def __init__(self):
        super().__init__(dim=2, num_x_pos_dims=2, num_x_ori_dims=0, num_z_pos_dims=2,
                         num_z_ori_dims=1)

    def __call__(self, x, p):
        return _rotate_into_frame(x, p)


@dataclasses.dataclass(frozen=True)
class Ponita2D(BaseInvariant):
    """Full SE(2) bi-invariant when both sides carry an orientation (PONITA): the
    relative position in the latent's frame and the cosine of the relative angle.
    Used for the latent ODE's kernel."""

    def __init__(self):
        super().__init__(dim=3, num_x_pos_dims=2, num_x_ori_dims=1, num_z_pos_dims=2,
                         num_z_ori_dims=1)

    def __call__(self, x, p):
        rel = _rotate_into_frame(x[..., :2], p)
        cos_rel = torch.sum(x[:, :, None, 2:] * p[:, None, :, 2:], dim=-1, keepdim=True)
        return torch.cat([rel, cos_rel], dim=-1)


@dataclasses.dataclass(frozen=True)
class RelativePositionPolarPeriodic(BaseInvariant):
    """SO(3)-invariant scalar on S^2: the cosine of the great-circle angle between a
    query and a latent, both (phi, theta) spherical angles."""

    def __init__(self):
        super().__init__(dim=1, num_x_pos_dims=2, num_x_ori_dims=0, num_z_pos_dims=2,
                         num_z_ori_dims=0, is_periodic=True)

    def __call__(self, x, p):
        return _great_circle_cos(x[:, :, :2], p[:, :, :2])

    def gaussian_window(self, x, p, sigma):
        return _sphere_window(self(x, p), sigma)


@dataclasses.dataclass(frozen=True)
class RelativeLatitudePeriodic(BaseInvariant):
    """Longitude-rotation-only invariant on S^2, for dynamics that break full SO(3):
    ``[theta_x, theta_p, cos(dphi), sin(dphi)]`` with ``dphi = phi_x - phi_p``. Its window
    is the sphere's, of the great-circle angle."""

    def __init__(self):
        super().__init__(dim=4, num_x_pos_dims=2, num_x_ori_dims=0, num_z_pos_dims=2,
                         num_z_ori_dims=0, is_periodic=True)

    def __call__(self, x, p):
        shape = (x.shape[0], x.shape[1], p.shape[1])
        th_x = x[:, :, None, 1].expand(shape)
        th_p = p[:, None, :, 1].expand(shape)
        dphi = x[:, :, None, 0] - p[:, None, :, 0]
        return torch.stack([th_x, th_p, torch.cos(dphi), torch.sin(dphi)], dim=-1)

    def gaussian_window(self, x, p, sigma):
        return _sphere_window(_great_circle_cos(x[:, :, :2], p[:, :, :2]), sigma)


def euler_zyx_matrix(alpha, beta, gamma) -> torch.Tensor:
    """The Z-Y-X Euler rotation Rz(alpha) @ Ry(beta) @ Rx(gamma), rows on axis -2: [..., 3, 3]."""
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    cg, sg = torch.cos(gamma), torch.sin(gamma)
    return torch.stack(
        [
            torch.stack([ca * cb, ca * sb * sg - sa * cg, ca * sb * cg + sa * sg], dim=-1),
            torch.stack([sa * cb, sa * sb * sg + ca * cg, sa * sb * cg - ca * sg], dim=-1),
            torch.stack([-sb, cb * sg, cb * cg], dim=-1),
        ],
        dim=-2,
    )


def _radii(x, p):
    """The query's and the latent's radius, each broadcast to [b, n, z, 1]."""
    shape = (x.shape[0], x.shape[1], p.shape[1], 1)
    return x[:, :, None, 2:3].expand(shape), p[:, None, :, 3:4].expand(shape)


@dataclasses.dataclass(frozen=True)
class BallInvariant(BaseInvariant):
    """SO(3) bi-invariant on the solid ball B^3. Queries are spherical coordinates
    (phi, theta, r), latent poses Euler angles and a radius (alpha, beta, gamma, r): the
    query's direction rotated by the pose's Z-Y-X rotation, then both radii (I = 5). Its
    window reads (alpha, beta) as sphere angles (see the module docstring)."""

    def __init__(self):
        super().__init__(dim=5, num_x_pos_dims=3, num_x_ori_dims=0, num_z_pos_dims=4,
                         num_z_ori_dims=0)

    def __call__(self, x, p):
        xv = _sphere_unit_vec(x[:, :, 0], x[:, :, 1])  # [b, n, 3]
        rot = euler_zyx_matrix(p[:, :, 0], p[:, :, 1], p[:, :, 2])  # [b, z, 3, 3]
        rotated = torch.einsum("bzij,bnj->bnzi", rot, xv)
        return torch.cat([rotated, *_radii(x, p)], dim=-1)

    def gaussian_window(self, x, p, sigma):
        return _sphere_window(_great_circle_cos(x[:, :, :2], p[:, :, :2]), sigma)


@dataclasses.dataclass(frozen=True)
class BallLatInvariant(BaseInvariant):
    """Longitude-invariant ball variant: ``[theta_x, theta_p, cos dphi, sin dphi, r_x,
    r_p]`` (I = 6), poses (phi, theta, <unused>, r). The sphere window of (phi, theta)."""

    def __init__(self):
        super().__init__(dim=6, num_x_pos_dims=3, num_x_ori_dims=0, num_z_pos_dims=4,
                         num_z_ori_dims=0)

    def __call__(self, x, p):
        shape = (x.shape[0], x.shape[1], p.shape[1])
        th_x = x[:, :, None, 1].expand(shape)
        th_p = p[:, None, :, 1].expand(shape)
        dphi = x[:, :, None, 0] - p[:, None, :, 0]
        angular = torch.stack([th_x, th_p, torch.cos(dphi), torch.sin(dphi)], dim=-1)
        return torch.cat([angular, *_radii(x, p)], dim=-1)

    def gaussian_window(self, x, p, sigma):
        return _sphere_window(_great_circle_cos(x[:, :, :2], p[:, :, :2]), sigma)


def _build(name: str, num_dims: int, for_cross_attention: bool) -> BaseInvariant:
    if name == "norm_rel_pos":
        return NormRelativePositionND(num_dims)
    if name == "rel_pos":
        return RelativePositionND(num_dims)
    if name == "abs_pos":
        return AbsolutePositionND(num_dims)
    if name == "rel_pos_periodic":
        if num_dims != 2:
            raise ValueError("rel_pos_periodic currently supports 2D input only.")
        return RelativePositionPeriodic(num_dims)
    if name == "ponita":
        if num_dims != 2:
            raise ValueError("ponita currently supports 2D input only.")
        # Cross-attention queries carry no orientation: the position-only invariant.
        return PonitaPos2D() if for_cross_attention else Ponita2D()
    if name == "polar_periodic":
        return RelativePositionPolarPeriodic()
    if name == "latitude_periodic":
        return RelativeLatitudePeriodic()
    if name == "ball":
        return BallInvariant()
    if name == "ball_lat":
        return BallLatInvariant()
    raise ValueError(f"Unknown invariant type: {name!r}")


def get_sa_invariant(nef_cfg) -> BaseInvariant:
    """Invariant used for latent-latent self attention (and the PONITA ODE kernel)."""
    return _build(nef_cfg.invariant_type, int(nef_cfg.num_in), for_cross_attention=False)


def get_ca_invariant(nef_cfg) -> BaseInvariant:
    """Invariant used for coordinate->latent cross attention."""
    return _build(nef_cfg.invariant_type, int(nef_cfg.num_in), for_cross_attention=True)
