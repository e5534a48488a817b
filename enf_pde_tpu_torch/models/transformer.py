"""Latent-space equivariant transformer: self attention over the latent point set.

Counterpart of ``enf_pde_tpu/models/transformer.py`` (reference
``enf/models/equivariant_transformer.py``): a latent-set processor with an MLP head and
optional global max pooling. The PDE experiments evolve latents with the PONITA ODE
instead; this is the same capability on the port's side.

As in the JAX module: the attention's value-side invariant embedding is conditioned on
the latents' own normalised features (``x_h``), there is no Gaussian window, and an
oriented pose is read as two positions and its angles (``p[:, :, :2]``, whatever the
invariant's position count), mapped to the circle.
"""

from __future__ import annotations

import torch
from torch import nn

from enf_pde_tpu_torch.geometry.invariants import BaseInvariant
from enf_pde_tpu_torch.models.decoder import CrossAttentionBlock, MLPHead
from enf_pde_tpu_torch.ops.attention import EquivariantCrossAttention
from enf_pde_tpu_torch.ops.layers import Dense, gelu

__all__ = ["EquivariantTransformer", "SelfAttentionBlock"]


class SelfAttentionBlock(CrossAttentionBlock):
    """A ``CrossAttentionBlock`` of the latents over themselves, its value embedding
    conditioned on their normalised features."""

    def forward(self, p, a, window_size=None):
        return super().forward(p, p, a, window_size, condition=True)


class EquivariantTransformer(nn.Module):
    """Self attention over latents ``(p, a, window)`` -> per-latent (or pooled) outputs.

    Args:
        num_hidden / num_heads / num_layers: width, heads and self-attention blocks
            (``self_attention_blocks_<i>``).
        num_out: output channels of the MLP head.
        latent_dim: latent context width (the stem's input; flax sizes it lazily).
        self_attn_invariant: geometry invariant between latents.
        embedding_type / embedding_freq_multiplier / condition_value_transform: as in
            ``EquivariantCrossAttention``.
        global_pooling: max over the latents before the head.
    """

    def __init__(self, num_hidden: int, num_heads: int, num_layers: int, num_out: int,
                 latent_dim: int, self_attn_invariant: BaseInvariant, embedding_type: str,
                 embedding_freq_multiplier: tuple, condition_value_transform: bool,
                 global_pooling: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.self_attn_invariant = self_attn_invariant
        self.global_pooling = global_pooling
        self.latent_stem = Dense(latent_dim, num_hidden)
        for i in range(num_layers):
            attn = EquivariantCrossAttention(
                num_hidden=num_hidden,
                num_heads=num_heads,
                invariant=self_attn_invariant,
                embedding_freq_multiplier=tuple(embedding_freq_multiplier),
                condition_value_transform=condition_value_transform,
                project_heads=True,
                use_gaussian_window=False,
                embedding_type=embedding_type,
                condition_invariant_embedding=True,
            )
            self.add_module(f"self_attention_blocks_{i}", SelfAttentionBlock(
                num_hidden, num_heads, attn, residual=True, project_heads=True))
        self.out_proj = MLPHead(num_hidden, num_hidden, num_out)

    def forward(self, latents) -> torch.Tensor:
        """``latents`` (p, a, window) -> [batch, num_latents, num_out], or [batch, num_out]
        with global pooling."""
        p, a, _ = latents
        if self.self_attn_invariant.num_z_ori_dims > 0:
            p = torch.cat([p[:, :, :2], torch.cos(p[:, :, 2:]), torch.sin(p[:, :, 2:])], dim=-1)
        a = self.latent_stem(a)
        for i in range(self.num_layers):
            a = gelu(getattr(self, f"self_attention_blocks_{i}")(p, a))
        if self.global_pooling:
            a = a.amax(dim=1)
        return self.out_proj(a)
