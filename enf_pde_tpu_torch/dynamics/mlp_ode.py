"""Non-equivariant MLP latent vector field (the dynamics baseline, ``node.name: mlp``).

Counterpart of ``enf_pde_tpu/dynamics/mlp_ode.py``: two 3-hidden-layer gelu MLPs on
``concat(p, a - 1)`` give the pose and the context derivatives; the window derivative
is zero. The layers are named as flax names them (``Dense_0`` … ``Dense_3`` the pose
MLP, ``Dense_4`` … ``Dense_7`` the context MLP), so a converted flax tree loads strictly.
"""

from __future__ import annotations

import torch
from torch import nn

from enf_pde_tpu_torch.ops.layers import Dense, gelu

__all__ = ["MLPLatentODE"]


class MLPLatentODE(nn.Module):
    """Args:
        num_in: width of ``concat(p, a)``: the pose's and the context's dims together
            (flax infers it at init).
        num_hidden: hidden width of both MLPs.
        scalar_num_out: context derivative width (``latent_dim``).
        vec_num_out: pose vectors; the pose derivative has ``2 * vec_num_out`` entries.
    """

    def __init__(self, num_in: int, num_hidden: int, scalar_num_out: int, vec_num_out: int):
        super().__init__()
        widths = [(num_in, num_hidden), (num_hidden, num_hidden), (num_hidden, num_hidden)]
        for i, (n_in, n_out) in enumerate(widths + [(num_hidden, 2 * vec_num_out)]
                                          + widths + [(num_hidden, scalar_num_out)]):
            setattr(self, f"Dense_{i}", Dense(n_in, n_out))

    def _mlp(self, x: torch.Tensor, first: int) -> torch.Tensor:
        for i in range(first, first + 3):
            x = gelu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{first + 3}")(x)

    def forward(self, latents):
        p, a, window = latents
        h = torch.cat([p, a - 1], dim=-1)
        dw = torch.zeros_like(window) if window is not None else None
        return self._mlp(h, 0), self._mlp(h, 4), dw
