"""PONITA-style equivariant latent vector field (the dynamics model of all experiments).

Counterpart of ``enf_pde_tpu/dynamics/ponita.py``: a dense point-cloud convolution
over the latent set. A polynomial-MLP kernel basis over the pairwise invariants
``inv(p, p)`` drives separable group convolutions; scalars read out the context
derivatives, and an invariant-gated mean of relative positions reads out the pose
derivatives. Contexts are centred (``a - 1``) because they are initialised at ones;
the window derivative is zero. Submodule names follow the flax parameter tree.

Oriented poses (the ``ponita`` invariant, poses (x, y, angle)): the angle is embedded
as (cos, sin) before the invariants, a second gate (``Dense_5``) adds a mean of the
senders' embedded orientations to the vector readout, and one more scalar is read out
as the angle's derivative, so ``dp = [vector, d angle]``. The angle is integrated raw
and never wrapped, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Union

import torch
from torch import nn

from enf_pde_tpu_torch.geometry.invariants import BaseInvariant
from enf_pde_tpu_torch.models.decoder import embed_pose_angles
from enf_pde_tpu_torch.ops.embeddings import polynomial_features
from enf_pde_tpu_torch.ops.layers import Dense, LayerNorm, gelu, variance_scaling, zeros

__all__ = ["SepGconv", "ConvBlock", "PonitaGen", "PonitaLatentODE"]


def _chang_xavier_uniform(t: torch.Tensor, g: torch.Generator) -> None:
    """Kernel-net init of the reference: uniform(+-sqrt(2 fan_in / (fan_in + fan_out)))."""
    fan_in, fan_out = t.shape
    std = math.sqrt(2.0 / (fan_in + fan_out) * fan_in)
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).uniform_(-std, std, generator=g))


_small_init = variance_scaling(1e-6, "truncated_normal")


class SepGconv(nn.Module):
    """``a[b, senders, c] * kernel[b, receivers, senders, c] -> out[b, receivers, c]``."""

    def __init__(self, num_hidden: int, basis_dim: int):
        super().__init__()
        self.Dense_0 = Dense(basis_dim, num_hidden, use_bias=False, kernel_init=_chang_xavier_uniform)
        self.bias = nn.Parameter(torch.empty(num_hidden))

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        zeros(self.bias, generator)

    def forward(self, a, kernel_basis):
        kernel = self.Dense_0(kernel_basis)
        return torch.einsum("bsc,brsc->brc", a, kernel) + self.bias


class ConvBlock(nn.Module):
    """SepGconv -> LayerNorm -> Dense -> gelu -> Dense (no residual)."""

    def __init__(self, num_hidden: int, basis_dim: int, widening_factor: int):
        super().__init__()
        self.SepGconv_0 = SepGconv(num_hidden, basis_dim)
        self.LayerNorm_0 = LayerNorm(num_hidden)
        self.Dense_0 = Dense(num_hidden, widening_factor * num_hidden)
        self.Dense_1 = Dense(widening_factor * num_hidden, num_hidden)

    def forward(self, a, kernel_basis):
        a = self.LayerNorm_0(self.SepGconv_0(a, kernel_basis))
        return self.Dense_1(gelu(self.Dense_0(a)))


class PonitaGen(nn.Module):
    """Equivariant point-cloud network with scalar and vector readouts.

    Args:
        num_in: width of the latent contexts ``a``.
    """

    def __init__(self, num_in: int, num_hidden: int, num_layers: int, scalar_num_out: int,
                 vec_num_out: int, invariant: BaseInvariant, basis_dim: int, degree: int,
                 widening_factor: int, global_pool: bool,
                 kernel_size: Union[float, str] = "global"):
        super().__init__()
        self.invariant = invariant
        self.num_layers = num_layers
        self.vec_num_out = vec_num_out
        self.degree = degree
        self.global_pool = global_pool
        self.kernel_size = kernel_size
        poly_dim = sum(invariant.dim ** (i + 1) for i in range(degree + 1))
        self.Dense_0 = Dense(poly_dim, num_hidden)
        self.Dense_1 = Dense(num_hidden, basis_dim)
        self.Dense_2 = Dense(num_in, num_hidden, use_bias=False)
        for i in range(num_layers):
            self.add_module(f"ConvBlock_{i}", ConvBlock(num_hidden, basis_dim, widening_factor))
        self.Dense_3 = Dense(num_hidden, scalar_num_out, use_bias=False, kernel_init=_small_init)
        if vec_num_out > 0:
            self.Dense_4 = Dense(invariant.dim + num_hidden, vec_num_out, use_bias=False,
                                 kernel_init=_small_init)
            if invariant.num_z_ori_dims > 0:  # the orientation gate
                self.Dense_5 = Dense(invariant.dim + num_hidden, vec_num_out, use_bias=False,
                                     kernel_init=_small_init)

    def forward(self, latent):
        p, a, _ = latent
        p = embed_pose_angles(p, self.invariant)  # angles to (cos, sin), as the decoder does
        invariants = self.invariant(p, p)  # [b, z, z, inv_dim]

        # Kernel basis: polynomial features -> MLP -> basis coefficients.
        kb = gelu(self.Dense_0(polynomial_features(invariants, self.degree)))
        kernel_basis = gelu(self.Dense_1(kb))
        if self.kernel_size != "global":
            # Pairwise distance with a zero (not NaN) gradient on the self-pairs.
            d2 = torch.sum((p[:, :, None, :] - p[:, None, :, :]) ** 2, dim=-1)
            pos = d2 > 0
            dist = torch.where(pos, torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))),
                               torch.zeros_like(d2))
            kernel_basis = kernel_basis * torch.exp(-dist / self.kernel_size)[..., None]

        a = self.Dense_2(a)
        for i in range(self.num_layers):
            a = getattr(self, f"ConvBlock_{i}")(a, kernel_basis)

        scalar_out = self.Dense_3(a)
        vec_out = None
        if self.vec_num_out > 0:
            pos_dims = self.invariant.num_z_pos_dims
            rel_pos = p[:, :, None, :pos_dims] - p[:, None, :, :pos_dims]
            # Gate vectors by invariants + sender features.
            inv_feat = torch.cat(
                [invariants, a[:, None, :, :].expand(*invariants.shape[:-1], a.shape[-1])], dim=-1
            )
            vec_out = (self.Dense_4(inv_feat) * rel_pos).mean(dim=-2)
            if self.invariant.num_z_ori_dims > 0:
                p_ori = p[:, None, :, pos_dims:].expand(rel_pos.shape)  # senders' (cos, sin)
                vec_out = vec_out + (self.Dense_5(inv_feat) * p_ori).mean(dim=-2)

        if self.global_pool:
            scalar_out = scalar_out.mean(dim=1)
            if vec_out is not None:
                vec_out = vec_out.mean(dim=1)
        return scalar_out, vec_out


class PonitaLatentODE(nn.Module):
    """Wraps ``PonitaGen`` as a latent vector field ``(p, a, w) -> (dp, da, dw)``."""

    def __init__(self, num_hidden: int, num_layers: int, scalar_num_out: int, vec_num_out: int,
                 invariant: BaseInvariant, basis_dim: int, degree: int, widening_factor: int,
                 global_pool: bool = False, kernel_size: Union[float, str] = "global"):
        super().__init__()
        self.oriented = invariant.num_z_ori_dims > 0
        # Contexts a are [.., scalar_num_out] wide: the field maps them to their derivative,
        # and an oriented pose reads one scalar more, the angle's derivative.
        self.PonitaGen_0 = PonitaGen(
            num_in=scalar_num_out, num_hidden=num_hidden, num_layers=num_layers,
            scalar_num_out=scalar_num_out + self.oriented, vec_num_out=vec_num_out,
            invariant=invariant, basis_dim=basis_dim, degree=degree,
            widening_factor=widening_factor, global_pool=global_pool, kernel_size=kernel_size,
        )

    def forward(self, latents):
        p, a, window = latents
        scalar, vec = self.PonitaGen_0((p, a - 1, window))  # contexts start at ones: centre them
        if self.oriented:
            da, dp = scalar[..., :-1], torch.cat([vec, scalar[..., -1:]], dim=-1)
        else:
            da, dp = scalar, vec
        dw = torch.zeros_like(window) if window is not None else None
        return dp, da, dw
