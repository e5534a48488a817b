"""Dense and LayerNorm layers with flax's defaults, initialised from a torch.Generator.

The JAX package builds its layers with ``flax.linen``. The port keeps flax's
semantics where they differ from torch's habits:

- ``Dense`` holds its weight as ``[out, in]`` like ``nn.Linear`` (a flax kernel is
  ``[in, out]``; ``convert.py`` transposes), and draws its initial values from an
  explicit generator with flax's initializers (default: lecun-normal kernel, zero
  bias). Construction leaves the parameters uninitialised; ``reset_parameters``
  fills every ``Dense`` and ``LayerNorm`` of a module tree.
- ``LayerNorm`` uses flax's epsilon 1e-6 (torch's default is 1e-5).
- ``gelu`` is the tanh approximation, as ``jax.nn.gelu``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Dense",
    "LayerNorm",
    "gelu",
    "reset_parameters",
    "variance_scaling",
    "normal",
    "zeros",
    "LN_EPS",
]

LN_EPS = 1e-6  # flax.linen.LayerNorm default

# An initializer fills a tensor laid out as the flax kernel would be ([in, out] for a
# dense kernel), drawing from the generator.
Initializer = Callable[[torch.Tensor, torch.Generator], None]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def variance_scaling(scale: float, distribution: str) -> Initializer:
    """flax ``variance_scaling(scale, 'fan_in', distribution)`` for 2-D kernels."""

    def init(t: torch.Tensor, g: torch.Generator) -> None:
        std = math.sqrt(scale / t.shape[0])
        with torch.no_grad():
            if distribution == "normal":
                t.copy_(torch.randn(t.shape, generator=g) * std)
            elif distribution == "truncated_normal":
                # jax samples a standard normal truncated to [-2, 2], scaled so the
                # truncated distribution has the requested std.
                s = std / 0.87962566103423978
                t.copy_(nn.init.trunc_normal_(torch.empty(t.shape), 0.0, 1.0, -2.0, 2.0, generator=g) * s)
            elif distribution == "uniform":
                lim = math.sqrt(3.0) * std
                t.copy_(torch.empty(t.shape).uniform_(-lim, lim, generator=g))
            else:
                raise ValueError(f"Unknown distribution: {distribution!r}")

    return init


def normal(std: float) -> Initializer:
    def init(t: torch.Tensor, g: torch.Generator) -> None:
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=g) * std)

    return init


def zeros(t: torch.Tensor, g: torch.Generator) -> None:
    with torch.no_grad():
        t.zero_()


lecun_normal = variance_scaling(1.0, "truncated_normal")


class Dense(nn.Module):
    """``y = x @ weight.T + bias`` with a flax-style initializer."""

    def __init__(self, num_in: int, num_out: int, use_bias: bool = True,
                 kernel_init: Initializer = lecun_normal, bias_init: Initializer = zeros):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_out, num_in))
        self.bias = nn.Parameter(torch.empty(num_out)) if use_bias else None
        self.kernel_init = kernel_init
        self.bias_init = bias_init

    def reset_parameters(self, generator: torch.Generator) -> None:
        kernel = torch.empty(self.weight.shape[1], self.weight.shape[0])
        self.kernel_init(kernel, generator)
        with torch.no_grad():
            self.weight.copy_(kernel.t())
        if self.bias is not None:
            self.bias_init(self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def LayerNorm(num_features: int) -> nn.LayerNorm:
    return nn.LayerNorm(num_features, eps=LN_EPS)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every layer of ``module`` in registration order from ``generator``.

    Registration order is fixed by the module definitions, so one seed always gives
    the same weights; it does not reproduce the JAX package's draws (the two
    frameworks' generators differ), only their distributions.
    """
    for m in module.modules():
        if isinstance(m, Dense):
            m.reset_parameters(generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif hasattr(m, "reset_own_parameters"):
            m.reset_own_parameters(generator)
