"""The ENF field decoder: latent stem -> latent self attention -> cross attention -> MLP.

Counterpart of ``enf_pde_tpu/models/decoder.py``: stem -> ``num_layers`` latent
self-attention blocks (0 in every experiment config) -> one cross-attention block ->
3-layer gelu head. Each self-attention block computes
``a <- gelu(a + ffn(a + attn(LN(a))))`` over the latents, with the poses' angles already
on the circle, as the JAX decoder does.

Two backends share the parameters:

- ``'eager'``: the PyTorch composition (``ops/attention.py``), which autograd
  differentiates to any order.
- ``'kernel'``: the fused decode (``ops/fused_decode.py``): geometry, the stem, the
  self-attention blocks and the weight folds in PyTorch, then ``FusedDecode`` for cross
  attention, out projection, block FFN and head: kernel K1 forward, kernel K2 backward,
  with autograd carrying K2's gradients of the folded inputs back through the folds and
  the blocks to the latents and the weights. A double backward takes K2's values and the
  plain composition's second derivatives (``FusedDecode``). On CUDA tensors it launches
  the kernels' bf16 programs (bf16 operands, f32 sums: JAX's ``compute_dtype=bfloat16``,
  what its ``pallas`` backend runs on the chip) or raises; on CPU tensors it runs the plain
  version in f32, as JAX's interpreter does (``kernel_compute_dtype``). It computes only
  decoders with the RFF embedding and the value conditioning (``kernel_eligible``), as
  JAX's ``_use_pallas_full``; the trainers resolve a ``pallas`` backend of any other decoder
  to ``'eager'`` at construction (``builders.resolve_backend``).
- ``'kernel_f32'``: the same on the kernels' strict-f32 programs (3xTF32) on CUDA tensors,
  the counterpart of JAX's ``pallas_interpret`` (``compute_dtype=float32``).
"""

from __future__ import annotations

from typing import Callable, Optional

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
    k1_operands,
)
from enf_pde_tpu_torch.ops.layers import Dense, LayerNorm, gelu

__all__ = ["EnfDecoder", "CrossAttentionBlock", "decode_chunked", "decode_trajectories",
           "embed_pose_angles", "kernel_compute_dtype", "BACKENDS", "KERNEL_BACKENDS"]

KERNEL_BACKENDS = ("kernel", "kernel_f32")
BACKENDS = ("eager", *KERNEL_BACKENDS)


def kernel_compute_dtype(backend: str, device) -> torch.dtype:
    """The fused kernels' compute dtype for a kernel backend on ``device``, as the JAX decoder
    picks ``compute_dtype``: ``'kernel'`` (the config's ``pallas``) is bf16 on the card and f32
    on the CPU (JAX's interpreter runs f32); ``'kernel_f32'`` (``pallas_interpret``) is f32."""
    if backend not in KERNEL_BACKENDS:
        raise ValueError(f"{backend!r} is not a kernel backend ({KERNEL_BACKENDS})")
    if backend == "kernel" and torch.device(device).type == "cuda":
        return torch.bfloat16
    return torch.float32


def embed_pose_angles(p: torch.Tensor, invariant: BaseInvariant) -> torch.Tensor:
    """Map angular pose components to the circle: (pos, theta) -> (pos, cos, sin)."""
    if invariant.num_z_ori_dims > 0:
        p_pos = p[:, :, : invariant.num_z_pos_dims]
        p_ang = p[:, :, invariant.num_z_pos_dims:]
        return torch.cat([p_pos, torch.cos(p_ang), torch.sin(p_ang)], dim=-1)
    return p


class CrossAttentionBlock(nn.Module):
    """LayerNorm(a) -> attention -> [residual] -> PointwiseFFN. ``condition`` hands LN(a)
    to the attention as its ``x_h`` (the transformer's self attention)."""

    def __init__(self, num_hidden: int, num_heads: int, attn: EquivariantCrossAttention,
                 residual: bool, project_heads: bool):
        super().__init__()
        self.residual = residual
        self.layer_norm_attn = LayerNorm(num_hidden)
        self.attn = attn
        width = num_hidden if project_heads else num_heads * num_hidden
        self.pointwise_ffn = PointwiseFFN(width, width, width)

    def forward(self, x, p, a, window_size, condition: bool = False):
        a_norm = self.layer_norm_attn(a)
        a_attn = self.attn(x, p, a_norm, window_sigma=window_size, x_h=a_norm if condition else None)
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
        num_layers: latent self-attention blocks (``self_attention_blocks_<i>``).
        num_out: output field channels.
        latent_dim: latent context width (before the stem).
        cross_attn_invariant: geometry invariant of the cross attention.
        embedding_type: ``'rff'``, ``'ffn'`` or ``'polynomial'``.
        self_attn_invariant: geometry invariant of the self attention (needed when
            ``num_layers`` > 0; ``geometry.invariants.get_sa_invariant``).
    """

    def __init__(self, num_hidden: int, num_heads: int, num_layers: int, num_out: int,
                 latent_dim: int, cross_attn_invariant: BaseInvariant, embedding_type: str,
                 embedding_freq_multiplier: tuple, condition_value_transform: bool,
                 use_gaussian_window: bool = True,
                 self_attn_invariant: Optional[BaseInvariant] = None):
        super().__init__()
        if num_layers and self_attn_invariant is None:
            raise ValueError("num_layers > 0 needs a self_attn_invariant")
        self.num_hidden, self.num_heads, self.num_out = num_hidden, num_heads, num_out
        self.num_layers = num_layers
        self.cross_attn_invariant = cross_attn_invariant
        self.embedding_type = embedding_type
        self.condition_value_transform = condition_value_transform
        self.use_gaussian_window = use_gaussian_window
        self.latent_stem = Dense(latent_dim, num_hidden)

        def attention(invariant, project_heads):
            return EquivariantCrossAttention(
                num_hidden=num_hidden,
                num_heads=num_heads,
                invariant=invariant,
                embedding_freq_multiplier=tuple(embedding_freq_multiplier),
                condition_value_transform=condition_value_transform,
                project_heads=project_heads,
                use_gaussian_window=use_gaussian_window,
                embedding_type=embedding_type,
            )

        for i in range(num_layers):  # flax names a list of submodules <name>_<i>
            self.add_module(f"self_attention_blocks_{i}", CrossAttentionBlock(
                num_hidden, num_heads, attention(self_attn_invariant, True), residual=True,
                project_heads=True))
        self.cross_attention_block = CrossAttentionBlock(
            num_hidden, num_heads, attention(cross_attn_invariant, False), residual=False,
            project_heads=False)
        self.out_proj = MLPHead(num_heads * num_hidden, num_hidden, num_out)

    @property
    def kernel_eligible(self) -> bool:
        """Whether the fused kernels compute this decoder: the RFF embedding with the
        value conditioning (JAX's ``_use_pallas_full``)."""
        return self.condition_value_transform and self.embedding_type == "rff"

    def forward(self, x, p, a, gaussian_window, backend: str = "eager"):
        """Decode field values at coordinates ``x`` from latents ``(p, a, sigma)``.

        Args:
            x: [batch, num_coords, coord_dim].
            p: [batch, num_latents, pose_dim].
            a: [batch, num_latents, latent_dim].
            gaussian_window: [batch, num_latents, 1] per-latent window size.
            backend: ``'eager'``, ``'kernel'`` or ``'kernel_f32'`` (the last two only where
                ``kernel_eligible``; ``kernel_compute_dtype`` gives their programs).

        Returns:
            [batch, num_coords, num_out].
        """
        if backend in KERNEL_BACKENDS:
            inv, wb, A, ab, G, c, ws, tws = self.kernel_inputs(x, p, a, gaussian_window)
            return FusedDecode.apply(self.num_heads, self.num_hidden, len(tws),
                                     kernel_compute_dtype(backend, inv.device),
                                     inv, wb, A, ab, G, c, *ws, *tws)
        if backend != "eager":
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        p, a = self.latent_features(p, a, gaussian_window)
        out = self.cross_attention_block(x, p, a, window_size=gaussian_window)
        return self.out_proj(gelu(out))

    def latent_features(self, p, a, gaussian_window):
        """The cross attention's latents: poses with their angles on the circle, and the
        contexts after the stem and the self-attention blocks, each
        ``a <- gelu(a + block(p, p, a))`` with the poses as the blocks' queries."""
        p = embed_pose_angles(p, self.cross_attn_invariant)
        a = self.latent_stem(a)
        for i in range(self.num_layers):
            block = getattr(self, f"self_attention_blocks_{i}")
            a = gelu(a + block(p, p, a, window_size=gaussian_window))
        return p, a

    def kernel_inputs(self, x, p, a, gaussian_window):
        """All of ``fused_decode_fwd``'s inputs: ``kernel_geometry`` then ``fold``."""
        return (*self.kernel_geometry(x, p, gaussian_window), *self.fold(p, a, gaussian_window))

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

    def fold(self, p, a, gaussian_window):
        """The fused decode's coordinate-independent inputs (``fold_decode_weights``).

        The stem, the self-attention blocks, the block LayerNorm, the key/value
        projections and the weight folds run here in PyTorch; K1 takes over from the
        invariants.
        """
        if not self.kernel_eligible:
            raise ValueError(
                f"The fused decode computes the RFF embedding with condition_value_transform, "
                f"not embedding_type={self.embedding_type!r}, condition_value_transform="
                f"{self.condition_value_transform}: decode this decoder on backend='eager'.")
        _, a = self.latent_features(p, a, gaussian_window)
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

    On a kernel backend the weight folds (with the stem and the self-attention blocks),
    which depend on the latents only, and K1's layout of what its program reads (``k1_operands``:
    the shared weights as ``split_weights``' tf32 parts or ``bf16_weights``, and at the bf16
    program's class 128 G and the tail's weights in bf16 blocks) run once for all chunks.
    """
    p, a, w = latent_traj
    b, t = p.shape[0], p.shape[1]
    p_fl, a_fl, w_fl = (x.reshape(b * t, *x.shape[2:]) for x in (p, a, w))
    xs = coords[None].expand(b * t, *coords.shape)
    if backend in KERNEL_BACKENDS:
        folded = decoder.fold(p_fl, a_fl, w_fl)
        dtype = kernel_compute_dtype(backend, coords.device)
        split = k1_operands(folded[2], folded[4], folded[5], decoder.num_heads, dtype)

        def apply_fn(x, pp, aa, ww):
            return fused_decode_fwd(*decoder.kernel_geometry(x, pp, ww), *folded,
                                    num_heads=decoder.num_heads, head_dim=decoder.num_hidden,
                                    split=split, compute_dtype=dtype)
    else:
        apply_fn = decoder
    out = decode_chunked(apply_fn, xs, p_fl, a_fl, w_fl, chunk_size=chunk_size)
    return out.reshape(b, t, coords.shape[0], -1)
