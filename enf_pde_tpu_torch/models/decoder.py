"""The ENF field decoder: latent stem -> cross attention block -> gelu MLP head.

Counterpart of ``enf_pde_tpu/models/decoder.py`` with ``num_layers: 0`` (every
experiment config): stem -> one cross-attention block -> 3-layer gelu head.

Two backends share the parameters:

- ``'eager'``: the PyTorch composition (``ops/attention.py``), which autograd
  differentiates; the inner-loop latent fit runs on it.
- ``'kernel'``: the fused decode (``ops/fused_decode.py``): geometry, the stem and
  the weight folds in PyTorch, then ``FusedDecode`` for cross attention, out
  projection, block FFN and head: kernel K1 forward, kernel K2 backward, with the
  fold's einsums carrying the gradients on to the latents and the weights. First
  order only. On CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from enf_pde_tpu_torch.geometry.invariants import BaseInvariant
from enf_pde_tpu_torch.ops.attention import EquivariantCrossAttention, PointwiseFFN
from enf_pde_tpu_torch.ops.fused_decode import (
    extract_attention_weights,
    extract_tail_weights,
    fold_decode_weights,
    fused_decode_fwd,
    FusedDecode,
    split_weights,
)
from enf_pde_tpu_torch.ops.layers import Dense, LayerNorm, gelu

__all__ = ["EnfDecoder", "CrossAttentionBlock", "decode_chunked", "decode_trajectories",
           "embed_pose_angles", "BACKENDS"]

BACKENDS = ("eager", "kernel")


def embed_pose_angles(p: torch.Tensor, invariant: BaseInvariant) -> torch.Tensor:
    """Map angular pose components to the circle: (pos, theta) -> (pos, cos, sin)."""
    if invariant.num_z_ori_dims > 0:
        p_pos = p[:, :, : invariant.num_z_pos_dims]
        p_ang = p[:, :, invariant.num_z_pos_dims:]
        return torch.cat([p_pos, torch.cos(p_ang), torch.sin(p_ang)], dim=-1)
    return p


class CrossAttentionBlock(nn.Module):
    """LayerNorm(a) -> attention -> [residual] -> PointwiseFFN."""

    def __init__(self, num_hidden: int, num_heads: int, attn: EquivariantCrossAttention,
                 residual: bool, project_heads: bool):
        super().__init__()
        self.residual = residual
        self.layer_norm_attn = LayerNorm(num_hidden)
        self.attn = attn
        width = num_hidden if project_heads else num_heads * num_hidden
        self.pointwise_ffn = PointwiseFFN(width, width, width)

    def forward(self, x, p, a, window_size):
        a_attn = self.attn(x, p, self.layer_norm_attn(a), window_sigma=window_size)
        return self.pointwise_ffn(a + a_attn if self.residual else a_attn)


class MLPHead(nn.Module):
    """Dense -> gelu -> Dense -> gelu -> Dense (flax ``nn.Sequential`` layer names)."""

    def __init__(self, num_in: int, num_hidden: int, num_out: int):
        super().__init__()
        self.layers_0 = Dense(num_in, num_hidden)
        self.layers_2 = Dense(num_hidden, num_hidden)
        self.layers_4 = Dense(num_hidden, num_out)

    def forward(self, x):
        return self.layers_4(gelu(self.layers_2(gelu(self.layers_0(x)))))


class EnfDecoder(nn.Module):
    """Equivariant neural field decoder ``f(x; p, a, sigma) -> field value``.

    Args:
        num_hidden: hidden width (also the per-head attention width).
        num_heads: attention heads.
        num_layers: latent self-attention blocks; only 0 is ported.
        num_out: output field channels.
        latent_dim: latent context width (before the stem).
        cross_attn_invariant: geometry invariant of the cross attention.
        embedding_type: only ``'rff'`` is ported.
    """

    def __init__(self, num_hidden: int, num_heads: int, num_layers: int, num_out: int,
                 latent_dim: int, cross_attn_invariant: BaseInvariant, embedding_type: str,
                 embedding_freq_multiplier: tuple, condition_value_transform: bool,
                 use_gaussian_window: bool = True):
        super().__init__()
        if num_layers != 0:
            raise NotImplementedError("Latent self attention (num_layers > 0) is not ported yet; see ROADMAP.md.")
        if embedding_type != "rff":
            raise NotImplementedError(f"Embedding {embedding_type!r} is not ported yet; see ROADMAP.md.")
        self.num_hidden, self.num_heads, self.num_out = num_hidden, num_heads, num_out
        self.cross_attn_invariant = cross_attn_invariant
        self.condition_value_transform = condition_value_transform
        self.use_gaussian_window = use_gaussian_window
        self.latent_stem = Dense(latent_dim, num_hidden)
        attn = EquivariantCrossAttention(
            num_hidden=num_hidden,
            num_heads=num_heads,
            invariant=cross_attn_invariant,
            embedding_freq_multiplier=tuple(embedding_freq_multiplier),
            condition_value_transform=condition_value_transform,
            project_heads=False,
            use_gaussian_window=use_gaussian_window,
        )
        self.cross_attention_block = CrossAttentionBlock(
            num_hidden, num_heads, attn, residual=False, project_heads=False
        )
        self.out_proj = MLPHead(num_heads * num_hidden, num_hidden, num_out)

    def forward(self, x, p, a, gaussian_window, backend: str = "eager"):
        """Decode field values at coordinates ``x`` from latents ``(p, a, sigma)``.

        Args:
            x: [batch, num_coords, coord_dim].
            p: [batch, num_latents, pose_dim].
            a: [batch, num_latents, latent_dim].
            gaussian_window: [batch, num_latents, 1] per-latent window size.
            backend: ``'eager'`` (differentiable to any order) or ``'kernel'``
                (first order).

        Returns:
            [batch, num_coords, num_out].
        """
        if backend == "kernel":
            inv, wb, A, ab, G, c, ws, tws = self.kernel_inputs(x, p, a, gaussian_window)
            return FusedDecode.apply(self.num_heads, self.num_hidden, len(tws),
                                     inv, wb, A, ab, G, c, *ws, *tws)
        if backend != "eager":
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        p = embed_pose_angles(p, self.cross_attn_invariant)
        a = self.latent_stem(a)
        out = self.cross_attention_block(x, p, a, window_size=gaussian_window)
        return self.out_proj(gelu(out))

    def kernel_inputs(self, x, p, a, gaussian_window):
        """All of ``fused_decode_fwd``'s inputs: ``kernel_geometry`` then ``fold``."""
        return (*self.kernel_geometry(x, p, gaussian_window), *self.fold(p, a))

    def kernel_geometry(self, x, p, gaussian_window):
        """The fused decode's per-coordinate inputs: inv [b, z, c, I], wb [b, z, c]."""
        p = embed_pose_angles(p, self.cross_attn_invariant)
        invariant = self.cross_attn_invariant
        inv = invariant(x, p)  # [b, c, z, i]
        if self.use_gaussian_window:
            wb = invariant.gaussian_window(x, p, sigma=gaussian_window)[..., 0]
        else:
            wb = torch.zeros(inv.shape[:3], dtype=inv.dtype, device=inv.device)
        return inv.transpose(1, 2).float().contiguous(), wb.transpose(1, 2).float().contiguous()

    def fold(self, p, a):
        """The fused decode's coordinate-independent inputs (``fold_decode_weights``).

        The stem, the block LayerNorm, the key/value projections and the weight folds
        run here in PyTorch; K1 takes over from the invariants.
        """
        if not self.condition_value_transform:
            raise NotImplementedError("The fused decode needs condition_value_transform.")
        a = self.latent_stem(a)
        block = self.cross_attention_block
        attn = block.attn
        a_norm = block.layer_norm_attn(a)
        k, v = attn.a_to_k(a_norm), attn.a_to_v(a_norm)
        tail = extract_tail_weights(attn.out_proj, block.pointwise_ffn, self.out_proj)
        return fold_decode_weights(k, v, extract_attention_weights(attn),
                                   self.num_heads, self.num_hidden, tail_weights=tail)


def decode_chunked(apply_fn: Callable[..., torch.Tensor], coords: torch.Tensor, p, a, window,
                   chunk_size: int) -> torch.Tensor:
    """Decode a large coordinate set in fixed-size tiles.

    Coordinates are zero-padded to a multiple of ``chunk_size`` (padded rows decode
    to finite values that are sliced off) and decoded tile by tile; the softmax is
    over latents, so tiles are independent.

    Args:
        apply_fn: ``apply_fn(x, p, a, window) -> [b, chunk, num_out]``.
        coords: [batch, num_coords, coord_dim].

    Returns:
        [batch, num_coords, num_out]
    """
    b, n, d = coords.shape
    num_chunks = -(-n // chunk_size)
    pad = num_chunks * chunk_size - n
    if pad:
        coords = torch.cat([coords, coords.new_zeros(b, pad, d)], dim=1)
    outs = [apply_fn(coords[:, i * chunk_size:(i + 1) * chunk_size], p, a, window)
            for i in range(num_chunks)]
    return torch.cat(outs, dim=1)[:, :n]


@torch.no_grad()
def decode_trajectories(decoder: EnfDecoder, backend: str, coords: torch.Tensor, latent_traj,
                        chunk_size: int) -> torch.Tensor:
    """Decode latent trajectories (p, a, window), each [batch, T, ...], at ``coords``
    [points, coord_dim] in chunks of ``chunk_size`` points on ``backend``; returns
    [batch, T, points, out]. The validation and forecast decode of both trainers.

    On the kernel backend the weight folds, which depend on the latents only, and K1's
    split of the shared weights run once for all chunks.
    """
    p, a, w = latent_traj
    b, t = p.shape[0], p.shape[1]
    p_fl, a_fl, w_fl = (x.reshape(b * t, *x.shape[2:]) for x in (p, a, w))
    xs = coords[None].expand(b * t, *coords.shape)
    if backend == "kernel":
        folded = decoder.fold(p_fl, a_fl)
        _, split = split_weights(folded[4])

        def apply_fn(x, pp, aa, ww):
            return fused_decode_fwd(*decoder.kernel_geometry(x, pp, ww), *folded,
                                    num_heads=decoder.num_heads, head_dim=decoder.num_hidden,
                                    split=split)
    else:
        apply_fn = decoder
    out = decode_chunked(apply_fn, xs, p_fl, a_fl, w_fl, chunk_size=chunk_size)
    return out.reshape(b, t, coords.shape[0], -1)
