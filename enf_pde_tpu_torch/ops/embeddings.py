"""Random Fourier feature embedding of invariants, and polynomial features.

Counterpart of ``enf_pde_tpu/ops/embeddings.py``: the RFF net projects with fixed
Gaussian coefficients (a buffer, never trained), concatenates ``[sin, cos]`` of
``2*pi * (x @ coeff)``, then applies ReLU hidden layers and a final linear layer.
Submodule names follow the flax parameter tree (``RFFEmbedding_0``, ``Dense_i``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from enf_pde_tpu_torch.ops.layers import Dense, normal, variance_scaling

__all__ = ["RFFEmbedding", "RFFNet", "polynomial_features"]


class RFFEmbedding(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, std: float):
        super().__init__()
        if hidden_dim % 2:
            raise ValueError("RFF hidden_dim must be even.")
        self.std = std
        self.register_buffer("coefficients", torch.empty(in_dim, hidden_dim // 2))

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        normal(self.std)(self.coefficients, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_proj = (2 * math.pi) * (x @ self.coefficients)
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class RFFNet(nn.Module):
    """RFF encoding -> (num_layers - 1) x [Dense + ReLU] -> Dense."""

    def __init__(self, in_dim: int, output_dim: int, hidden_dim: int, num_layers: int = 2,
                 std: float = 1.0, numerator: float = 2.0):
        super().__init__()
        if num_layers < 2:
            raise ValueError("RFFNet needs at least a hidden and an output layer.")
        self.num_layers = num_layers
        self.RFFEmbedding_0 = RFFEmbedding(in_dim, hidden_dim, std)
        for i in range(num_layers - 1):
            self.add_module(f"Dense_{i}", Dense(
                hidden_dim, hidden_dim,
                kernel_init=variance_scaling(numerator, "normal"), bias_init=normal(1e-6)))
        self.add_module(f"Dense_{num_layers - 1}", Dense(
            hidden_dim, output_dim,
            kernel_init=variance_scaling(numerator, "uniform"), bias_init=normal(1e-6)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.RFFEmbedding_0(x)
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.num_layers - 1}")(x)


def polynomial_features(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Concatenated outer-product power features up to ``degree`` + 1 factors."""
    feats = [x]
    for _ in range(degree):
        feats.append(torch.einsum("...i,...j->...ij", feats[-1], x).reshape(*x.shape[:-1], -1))
    return torch.cat(feats, dim=-1)
