"""Embeddings of invariants: random Fourier features, polynomial features, a plain MLP.

Counterpart of ``enf_pde_tpu/ops/embeddings.py``: the RFF net projects with fixed
Gaussian coefficients (a buffer, never trained), concatenates ``[sin, cos]`` of
``2*pi * (x @ coeff)``, then applies ReLU hidden layers and a final linear layer; the
polynomial embedding feeds outer-product power features to a gelu MLP; the FFN
embedding is a two-layer gelu MLP. Submodule names follow the flax parameter tree
(``RFFEmbedding_0``, ``Dense_i``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from enf_pde_tpu_torch.ops.layers import Dense, gelu, normal, variance_scaling

__all__ = ["RFFEmbedding", "RFFNet", "FFNEmbedding", "PolynomialEmbedding", "polynomial_features",
           "get_embedding"]


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


class PolynomialEmbedding(nn.Module):
    """``polynomial_features(x, degree)`` -> (num_layers - 1) x [Dense + gelu] -> Dense.

    The first dense reads ``in_dim * (1 + in_dim + ... + in_dim**degree)`` features (flax
    sizes it from its input)."""

    def __init__(self, in_dim: int, num_out: int, num_hidden: int, degree: int, num_layers: int = 2):
        super().__init__()
        self.degree, self.num_layers = degree, num_layers
        width = sum(in_dim ** (k + 1) for k in range(degree + 1))
        for i in range(num_layers - 1):
            self.add_module(f"Dense_{i}", Dense(width, num_hidden))
            width = num_hidden
        self.add_module(f"Dense_{num_layers - 1}", Dense(width, num_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = polynomial_features(x, self.degree)
        for i in range(self.num_layers - 1):
            x = gelu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.num_layers - 1}")(x)


class FFNEmbedding(nn.Module):
    """Dense -> gelu -> Dense."""

    def __init__(self, in_dim: int, num_hidden: int, num_out: int):
        super().__init__()
        self.Dense_0 = Dense(in_dim, num_hidden)
        self.Dense_1 = Dense(num_hidden, num_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(gelu(self.Dense_0(x)))


EMBEDDING_TYPES = ("rff", "ffn", "polynomial")


def get_embedding(embedding_type: str, num_in: int, num_hidden: int, num_emb_dim: int,
                  freq_multiplier: float) -> nn.Module:
    """The invariant embedding of ``embedding_type``: RFF with std ``freq_multiplier``, the
    FFN (which ignores it), or polynomial features of degree ``int(freq_multiplier)``."""
    if embedding_type == "rff":
        return RFFNet(num_in, num_emb_dim, num_hidden, num_layers=2, std=freq_multiplier)
    if embedding_type == "ffn":
        return FFNEmbedding(num_in, num_hidden, num_emb_dim)
    if embedding_type == "polynomial":
        return PolynomialEmbedding(num_in, num_emb_dim, num_hidden, degree=int(freq_multiplier))
    raise ValueError(f"Unknown embedding type: {embedding_type!r} (known: {EMBEDDING_TYPES})")
