"""Equivariant cross attention between coordinate queries and a latent point set.

Counterpart of the eager path of ``enf_pde_tpu/ops/attention.py``: a query is built
from an embedding (RFF, FFN or polynomial) of the bi-invariants ``inv(x, p)``;
keys/values come from the latent contexts ``a``; values are FiLM-conditioned per
(coordinate, latent) pair by a second invariant embedding (itself optionally
conditioned on per-coordinate features ``x_h``); a per-latent Gaussian window is added
to the logits; the softmax normalizes over the latent axis.

This composition is the eager backend, which autograd differentiates to any order.
The decoder's last cross attention can run on the fused kernels instead
(``EnfDecoder`` with ``backend='kernel'``, ``ops/fused_decode.py``) when it uses the RFF
embedding and the value conditioning.
"""

from __future__ import annotations

import torch
from torch import nn

from enf_pde_tpu_torch.geometry.invariants import BaseInvariant
from enf_pde_tpu_torch.ops.embeddings import get_embedding
from enf_pde_tpu_torch.ops.layers import Dense, LayerNorm, gelu

__all__ = ["PointwiseFFN", "EquivariantCrossAttention"]


class PointwiseFFN(nn.Module):
    """Dense -> gelu -> LayerNorm -> Dense."""

    def __init__(self, num_in: int, num_hidden: int, num_out: int):
        super().__init__()
        self.Dense_0 = Dense(num_in, num_hidden)
        self.LayerNorm_0 = LayerNorm(num_hidden)
        self.Dense_1 = Dense(num_hidden, num_out)

    def forward(self, x):
        return self.Dense_1(self.LayerNorm_0(gelu(self.Dense_0(x))))


class EquivariantCrossAttention(nn.Module):
    """Cross attention from coordinates ``x`` to latents ``(p, a)``.

    Args:
        num_hidden: per-head hidden width D (also the latent context width).
        num_heads: number of heads H.
        invariant: geometry invariant producing ``inv(x, p) [b, c, z, inv_dim]``.
        embedding_freq_multiplier: (query, value) frequency multipliers of the embeddings.
        condition_value_transform: FiLM-condition values on the invariant embedding.
        project_heads: project concatenated heads back to ``num_hidden``.
        use_gaussian_window: add the per-latent Gaussian window to the logits.
        embedding_type: ``'rff'``, ``'ffn'`` or ``'polynomial'`` (``ops/embeddings.py``).
        condition_invariant_embedding: FiLM-condition the value-side invariant embedding
            on per-coordinate features ``x_h`` (the latent transformer's self attention).
    """

    def __init__(self, num_hidden: int, num_heads: int, invariant: BaseInvariant,
                 embedding_freq_multiplier: tuple, condition_value_transform: bool,
                 project_heads: bool, use_gaussian_window: bool = True,
                 embedding_type: str = "rff", condition_invariant_embedding: bool = False):
        super().__init__()
        H, D = num_heads, num_hidden
        self.num_heads, self.num_hidden = H, D
        self.invariant = invariant
        self.embedding_type = embedding_type
        self.condition_value_transform = condition_value_transform
        self.condition_invariant_embedding = condition_invariant_embedding
        self.use_gaussian_window = use_gaussian_window
        freq_q, freq_v = embedding_freq_multiplier
        self.invariant_embedding_query = get_embedding(embedding_type, invariant.dim, D, D, freq_q)
        self.invariant_embedding_value = get_embedding(embedding_type, invariant.dim, D, D, freq_v)
        self.inv_emb_to_q = Dense(D, H * D)
        self.a_to_k = Dense(D, H * D)
        self.a_to_v = Dense(D, H * D)
        self.scale = 1.0 / (D**0.5)
        if condition_invariant_embedding:
            self.inv_emb_cond_to_inv_emb = PointwiseFFN(D, D, 2 * D)
        if condition_value_transform:
            self.inv_emb_to_v = PointwiseFFN(D, D, 2 * H * D)
            self.inv_emb_cond_mixer = PointwiseFFN(D, D, D)
        self.out_proj = Dense(H * D, D if project_heads else H * D)

    def forward(self, x, p, a, window_sigma=None, x_h=None):
        """x [b, c, coord_dim], p [b, z, pose_dim], a [b, z, D], window_sigma [b, z, 1],
        x_h [b, c, D] (only with ``condition_invariant_embedding``) -> [b, c, D] (or
        [b, c, H*D] when ``project_heads`` is False)."""
        H, D = self.num_heads, self.num_hidden
        inv = self.invariant(x, p)  # [b, c, z, inv_dim]
        q = self.inv_emb_to_q(self.invariant_embedding_query(inv))  # [b, c, z, H*D]
        k = self.a_to_k(a)  # [b, z, H*D]
        v = self.a_to_v(a)

        if self.condition_value_transform:
            inv_emb_v = self.invariant_embedding_value(inv)  # [b, c, z, D]
            if self.condition_invariant_embedding:
                if x_h is None:
                    raise ValueError("x_h is required when conditioning the invariant embedding.")
                g, b_ = torch.chunk(self.inv_emb_cond_to_inv_emb(x_h), 2, dim=-1)
                inv_emb_v = inv_emb_v * (1 + g[:, :, None, :]) + b_[:, :, None, :]
            v_gamma, v_beta = torch.chunk(self.inv_emb_to_v(inv_emb_v), 2, dim=-1)
            v = v[:, None, :, :] * (1 + v_gamma) + v_beta  # [b, c, z, H*D]
            v = v.reshape(v.shape[:-1] + (H, D))
            v = self.inv_emb_cond_mixer(v)  # per-head mixer over D
        else:
            v = v[:, None, :, :].reshape(v.shape[0], 1, v.shape[1], H, D)

        q = q.reshape(q.shape[:-1] + (H, D))
        k = k.reshape(k.shape[:-1] + (H, D))

        att = (q * k[:, None, ...]).sum(dim=-1) * self.scale  # [b, c, z, H]
        if self.use_gaussian_window:
            att = att + self.invariant.gaussian_window(x, p, sigma=window_sigma)
        att = torch.softmax(att, dim=-2)  # normalize over latents

        y = (att[..., None] * v).sum(dim=2)  # contract the latent axis
        return self.out_proj(y.reshape(*y.shape[:2], H * D))
