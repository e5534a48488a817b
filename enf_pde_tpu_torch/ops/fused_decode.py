"""Fused ENF decode: weight folding, the plain PyTorch versions, the CUDA kernels K1 and K2.

Counterpart of ``enf_pde_tpu/ops/pallas_decode.py``. The decode
cross-attention, its output projection, the block FFN and the decoder's MLP head run
as one kernel per (batch row, coordinate tile) that keeps every per-coordinate
activation on chip; only the invariants, the window bias and the folded per-latent
matrices come in, and only the field values go out.

Layers, as in the JAX package:

- ``extract_attention_weights`` / ``extract_tail_weights`` pull the raw weights out
  of the modules, as ``[in, out]`` matrices.
- ``fold_weights`` / ``fold_tail_weights`` pre-multiply linear chains and build the
  per-latent logit matrices ``A [b, z, hid, H]`` / ``ab [b, z, H]`` and FiLM+mixer
  matrices ``G [b, z, hid, H*hidm]`` / ``c [b, z, H*hidm]`` (see the JAX module's
  notes for the algebra). These are f32 einsums outside the kernel.
- ``fused_decode_plain`` is ``_tile_decode``'s math on whole tensors: the plain
  version the CPU tests run and the kernel is held against.
- ``fused_decode_fwd`` is the kernel's wrapper. On a CPU tensor it runs the plain
  version; on a CUDA tensor it launches ``csrc/fused_decode_fwd.cu`` (built with
  plain ``nvcc``, bound with ``ctypes``) or raises. It hands the kernel the four
  weights that its products over a latent group's rows share, ``SPLIT_WEIGHT_NAMES``,
  split into tf32 (big, small) parts in the blocked layout ``wgmma`` reads at the shape's
  width class (``split_weights``, ``k1_width_class``): once per fold when the caller
  passes ``split``, as a decode of many chunks does, else once per launch.
- ``fused_decode_bwd_plain`` is the VJP of ``fused_decode_plain`` by autograd, and
  ``fused_decode_bwd`` the wrapper of kernel K2 (``csrc/fused_decode_bwd.cu``), with
  the same CPU / CUDA dispatch.
- ``FusedDecode`` pairs the two wrappers in a ``torch.autograd.Function`` (K1
  forward, K2 backward). A backward that builds a graph (``create_graph=True``, the
  meta-SGD inner loop) goes through ``FusedDecodeVJP``: K2 gives the gradients' values,
  the plain composition their derivatives, as JAX's ``custom_jvp`` shields around its
  kernels do.

Numerics: the reference paths run in strict f32. ``strict_fp32`` turns TF32 off for
both cuBLAS matmuls and cuDNN (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``); the fold and the plain version call it.

Each kernel has two programs, as the JAX kernel has two modes (``_Spec.compute_dtype``):
``compute_dtype=torch.float32`` (3xTF32, ``fused_decode_fwd.cu`` / ``fused_decode_bwd.cu``) and
``torch.bfloat16`` (bf16 operands with f32 sums, ``fused_decode_fwd_bf16.cu`` /
``fused_decode_bwd_bf16.cu``, their shared weights laid out by ``bf16_weights``), each held
against ``fused_decode_plain`` at the same ``compute_dtype``. Which one a decoder backend runs is
``models.decoder.kernel_compute_dtype``'s choice.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import math
import re
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from enf_pde_tpu_torch.ops import cuda_lib
from enf_pde_tpu_torch.ops.layers import LN_EPS, gelu

__all__ = [
    "WEIGHT_NAMES",
    "TAIL_WEIGHT_NAMES",
    "strict_fp32",
    "extract_attention_weights",
    "extract_tail_weights",
    "fold_weights",
    "fold_tail_weights",
    "fold_decode_weights",
    "fast_sincos",
    "fused_decode_plain",
    "fused_decode_fwd",
    "split_weights",
    "bf16_weights",
    "bf16_blocks",
    "bf16_g_blocks",
    "K1Operands",
    "k1_operands",
    "shared_weights",
    "kernel_sources",
    "k1_width_class",
    "k1_constants",
    "k1_smem_bytes",
    "k1_logits_floats",
    "k1_plan",
    "k1_library_smem_bytes",
    "k1_occupancy",
    "k1_library_plan",
    "fused_decode_bwd_plain",
    "fused_decode_bwd",
    "k2_width_class",
    "k2_constants",
    "k2_smem_bytes",
    "k2_scratch_bytes",
    "k2_occupancy",
    "k2_w128_design",
    "a16_index",
    "split3_bf16",
    "FusedDecode",
    "decode_flops_per_point",
    "decode_bwd_flops_per_point",
]

# Order of the folded weights handed to the kernel (``_WEIGHT_NAMES`` in JAX).
WEIGHT_NAMES = (
    "q_coeff", "q_w1", "q_b1",
    "v_coeff", "v_w1", "v_b1",
    "fw", "fb",
    "m_w2", "m_b2",
)
TAIL_WEIGHT_NAMES = (
    "o_w", "o_b",
    "p_w1", "p_b1",
    "p_w2", "p_b2",
    "h_w1", "h_b1",
    "h_w2", "h_b2",
    "h_w3", "h_b3",
)

# Handed to K1 split into tf32 (big, small) parts too, in this order (after ``out``), in
# the blocked layout of ``split_weights``; WG_N is the width of one slab of the widest class.
SPLIT_WEIGHT_NAMES = ("q_w1", "v_w1", "fw", "m_w2")
# The bf16 program also takes G and these tail weights in bf16, blocked as its wgmma reads them at the
# width class (``k1_operands``); h_w3 (a few columns, on the CUDA cores) stays f32.
BLOCKED_TAIL_NAMES = ("o_w", "p_w1", "p_w2", "h_w1", "h_w2")
WG_N = 128
# K1's narrow width classes: a shape whose hid, hidm and D fit one takes it, else WG_N.
NARROW_CLASSES = (16, 32, 64)
# The SMs of the card a K1 plan is made for where no card says (an H100's).
SMS = 132

KERNEL_SOURCE = "fused_decode_fwd.cu"
BWD_KERNEL_SOURCE = "fused_decode_bwd.cu"
# The bf16 programs (JAX's compute_dtype=bfloat16): the same C interfaces.
KERNEL_SOURCE_BF16 = "fused_decode_fwd_bf16.cu"
BWD_KERNEL_SOURCE_BF16 = "fused_decode_bwd_bf16.cu"
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# The RFF coefficients (fixed buffers, ``stop_gradient`` in JAX) get no gradient.
COEFF_INDICES = (WEIGHT_NAMES.index("q_coeff"), WEIGHT_NAMES.index("v_coeff"))


def _check_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, got {compute_dtype}")
    return compute_dtype


def kernel_sources(compute_dtype: torch.dtype = torch.float32) -> Tuple[str, str]:
    """The sources of K1 and K2 for a compute dtype: the f32 programs (3xTF32) or the bf16 ones."""
    bf = _check_dtype(compute_dtype) == torch.bfloat16
    return (KERNEL_SOURCE_BF16, BWD_KERNEL_SOURCE_BF16) if bf else (KERNEL_SOURCE, BWD_KERNEL_SOURCE)


def strict_fp32() -> None:
    """Full-f32 matmuls and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _kernel(dense) -> torch.Tensor:
    """A ``Dense`` weight as the flax kernel layout ``[in, out]``."""
    return dense.weight.t()


def extract_attention_weights(attn) -> Dict[str, torch.Tensor]:
    """Raw weights of an ``EquivariantCrossAttention`` (with value conditioning)."""
    q = attn.invariant_embedding_query
    v = attn.invariant_embedding_value
    film = attn.inv_emb_to_v
    mixer = attn.inv_emb_cond_mixer
    return {
        "q_coeff": q.RFFEmbedding_0.coefficients,
        "q_w1": _kernel(q.Dense_0), "q_b1": q.Dense_0.bias,
        "q_w2": _kernel(q.Dense_1), "q_b2": q.Dense_1.bias,
        "wq": _kernel(attn.inv_emb_to_q), "bq": attn.inv_emb_to_q.bias,
        "v_coeff": v.RFFEmbedding_0.coefficients,
        "v_w1": _kernel(v.Dense_0), "v_b1": v.Dense_0.bias,
        "v_w2": _kernel(v.Dense_1), "v_b2": v.Dense_1.bias,
        "f_w1": _kernel(film.Dense_0), "f_b1": film.Dense_0.bias,
        "f_ln_s": film.LayerNorm_0.weight, "f_ln_b": film.LayerNorm_0.bias,
        "f_w2": _kernel(film.Dense_1), "f_b2": film.Dense_1.bias,
        "m_w1": _kernel(mixer.Dense_0), "m_b1": mixer.Dense_0.bias,
        "m_ln_s": mixer.LayerNorm_0.weight, "m_ln_b": mixer.LayerNorm_0.bias,
        "m_w2": _kernel(mixer.Dense_1), "m_b2": mixer.Dense_1.bias,
    }


def extract_tail_weights(attn_out_proj, block_ffn, head_mlp) -> Dict[str, torch.Tensor]:
    """Attention out-projection + block FFN + decoder head MLP."""
    return {
        "o_w": _kernel(attn_out_proj), "o_b": attn_out_proj.bias,
        "p_w1": _kernel(block_ffn.Dense_0), "p_b1": block_ffn.Dense_0.bias,
        "p_ln_s": block_ffn.LayerNorm_0.weight, "p_ln_b": block_ffn.LayerNorm_0.bias,
        "p_w2": _kernel(block_ffn.Dense_1), "p_b2": block_ffn.Dense_1.bias,
        "h_w1": _kernel(head_mlp.layers_0), "h_b1": head_mlp.layers_0.bias,
        "h_w2": _kernel(head_mlp.layers_2), "h_b2": head_mlp.layers_2.bias,
        "h_w3": _kernel(head_mlp.layers_4), "h_b3": head_mlp.layers_4.bias,
    }


def fold_weights(weights: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
                 num_heads: int, head_dim: int):
    """Pre-multiply linear chains and build the per-latent logit / FiLM matrices.

    Args:
        weights: raw arrays from ``extract_attention_weights``.
        k / v: latent keys / values [b, z, H*D].

    Returns:
        (folded weight dict, A [b, z, hid, H], ab [b, z, H], G [b, z, hid, H*hidm],
        c [b, z, H*hidm]).
    """
    strict_fp32()
    H, D = num_heads, head_dim
    m_w1 = weights["m_w1"]  # [D, hidm]
    hid = weights["f_w1"].shape[0]
    hidm = m_w1.shape[1]
    b, z, _ = v.shape

    # Linear-chain folds (no nonlinearity between the factors).
    qw = weights["q_w2"] @ weights["wq"]
    qb = weights["q_b2"] @ weights["wq"] + weights["bq"]
    fw = weights["v_w2"] @ weights["f_w1"]
    fb = weights["v_b2"] @ weights["f_w1"] + weights["f_b1"]

    # Query-logit fold: the q projection contracted with the latent key over D,
    # with the 1/sqrt(D) softmax scale.
    scale = 1.0 / math.sqrt(D)
    k4 = k.reshape(b, z, H, D)
    A = scale * torch.einsum("xhd,bzhd->bzxh", qw.reshape(-1, H, D), k4)
    ab = scale * torch.einsum("hd,bzhd->bzh", qb.reshape(H, D), k4)

    # FiLM + mixer-dense-1 fold. f_w2 [hid, 2*H*D]: gamma half then beta half.
    f_w2, f_b2 = weights["f_w2"], weights["f_b2"]
    Wg = f_w2[:, : H * D].reshape(hid, H, D)
    Wb = f_w2[:, H * D:].reshape(hid, H, D)
    bg = f_b2[: H * D].reshape(H, D)
    bb = f_b2[H * D:].reshape(H, D)
    v4 = v.reshape(b, z, H, D)

    # G[b,z,h] = Wg_h diag(v[b,z,h]) m_w1 + Wb_h m_w1, per head [hid, hidm].
    G_beta = torch.einsum("xhd,dm->hxm", Wb, m_w1)
    G = torch.einsum("bzxhd,dm->bzhxm", Wg * v4[:, :, None], m_w1) + G_beta
    G = G.permute(0, 1, 3, 2, 4).reshape(b, z, hid, H * hidm)
    # c[b,z,h] = (v (1+bg) + bb) m_w1 + m_b1.
    c = torch.einsum("bzhd,dm->bzhm", v4 * (1.0 + bg) + bb, m_w1) + weights["m_b1"]
    c = c.reshape(b, z, H * hidm)

    # The FiLM LayerNorm's scale/bias go into G/c; the mixer's into its dense 2.
    c = c + torch.einsum("x,bzxm->bzm", weights["f_ln_b"], G)
    G = G * weights["f_ln_s"][:, None]
    m_w2 = weights["m_ln_s"][:, None] * weights["m_w2"]
    m_b2 = weights["m_b2"] + weights["m_ln_b"] @ weights["m_w2"]

    folded = {
        "q_coeff": weights["q_coeff"], "q_w1": weights["q_w1"], "q_b1": weights["q_b1"],
        "v_coeff": weights["v_coeff"], "v_w1": weights["v_w1"], "v_b1": weights["v_b1"],
        "fw": fw, "fb": fb, "m_w2": m_w2, "m_b2": m_b2,
    }
    return folded, A, ab, G, c


def fold_tail_weights(tw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold the block-FFN LayerNorm scale/bias into its dense 2."""
    out = {n: tw[n] for n in TAIL_WEIGHT_NAMES}
    out["p_w2"] = tw["p_ln_s"][:, None] * tw["p_w2"]
    out["p_b2"] = tw["p_b2"] + tw["p_ln_b"] @ tw["p_w2"]
    return out


def fold_decode_weights(k, v, weights, num_heads: int, head_dim: int,
                        tail_weights: Optional[Dict[str, torch.Tensor]] = None):
    """The coordinate-independent part of ``fused_decode_fwd``'s inputs, contiguous f32.

    Args:
        k / v: latent keys / values [b, z, H*D].
        weights / tail_weights: from ``extract_attention_weights`` /
            ``extract_tail_weights``; without the tail the output is [b, c, H*D].

    Returns:
        (A, ab, G, c, ws, tws) with ``ws`` / ``tws`` the folded weights in
        ``WEIGHT_NAMES`` / ``TAIL_WEIGHT_NAMES`` order. They depend on the latents
        only, so one fold serves every coordinate chunk of a decode.
    """
    f32 = {n: w.float() for n, w in weights.items()}
    folded, A, ab, G, c = fold_weights(f32, k.float(), v.float(), num_heads, head_dim)
    ws = tuple(folded[n].contiguous() for n in WEIGHT_NAMES)
    tws: Tuple[torch.Tensor, ...] = ()
    if tail_weights is not None:
        ft = fold_tail_weights({n: w.float() for n, w in tail_weights.items()})
        tws = tuple(ft[n].contiguous() for n in TAIL_WEIGHT_NAMES)
    return A.contiguous(), ab.contiguous(), G.contiguous(), c.contiguous(), ws, tws


# --------------------------------------------------------------------- plain version


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without scale and bias, var = E[x^2] - E[x]^2 as in the JAX kernel."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True) - mean * mean
    return (x - mean) * torch.rsqrt(var + LN_EPS)


def _b16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even) and back to its type (f32; float64 sums
    the same roundings exactly). Products of such values are exact in f32, so a matmul of them is
    JAX's bf16 ``dot`` with ``preferred_element_type=f32``; autograd through the casts rounds the
    cotangent of the bf16 value, as JAX's transpose of ``convert_element_type`` does."""
    return x.to(torch.bfloat16).to(x.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``_mm`` of the JAX kernel: both operands rounded to bf16 in the bf16 mode, f32 sums."""
    return _b16(x) @ _b16(w) if bf16 else x @ w


def fast_sincos(proj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_fast_sincos``: sin and cos of ``2 pi proj`` by polynomials after an exact range
    reduction, t = pi (proj - round(proj)), sin = 2 s(t) c(t), cos = 1 - 2 s(t)^2 (the bf16
    mode's; f32 throughout, each operation as the JAX kernel orders it)."""
    t = math.pi * (proj - torch.round(proj))
    t2 = t * t
    s = t * (0.9999999995 + t2 * (-0.1666666279 + t2 * (8.333288177e-3 + t2 * (-1.980741872e-4
                                                                            + t2 * 2.601885479e-6))))
    c = 1.0 + t2 * (-0.4999999963 + t2 * (4.166657362e-2 + t2 * (-1.388544180e-3 + t2 * 2.423340843e-5)))
    return 2.0 * s * c, 1.0 - 2.0 * s * s


def _rff_hidden(x, coeff, w1, b1, bf16: bool = False):
    """RFF sin/cos features -> ReLU dense (RFFNet dense 1); the projection stays f32, the bf16
    mode takes the polynomial sin/cos and rounds the dense's operands."""
    proj = x @ coeff
    if bf16:
        h = torch.cat(fast_sincos(proj), dim=-1)
    else:
        h = torch.cat([torch.sin(2 * math.pi * proj), torch.cos(2 * math.pi * proj)], dim=-1)
    return torch.relu(_mm(h, w1, bf16) + b1)


def fused_decode_plain(inv, wb, A, ab, G, c, ws: Sequence[torch.Tensor],
                       tws: Sequence[torch.Tensor], num_heads: int, head_dim: int,
                       compute_dtype: torch.dtype = torch.float32):
    """``_tile_decode`` on whole tensors: inv [b, z, c, I], wb [b, z, c] -> [b, c, out].

    ``compute_dtype`` is ``_Spec.compute_dtype``: ``torch.float32`` (strict f32, the
    ``pallas_interpret`` mode) or ``torch.bfloat16`` (the TPU kernel's default): every product
    operand rounded to bf16 with f32 sums (A, G and every weight included; one rounding of
    ``m_w2`` per head, as JAX casts it in each head's ``_mm``), the polynomial sin/cos, and the
    softmax weights rounded to bf16 before they weight the values; the RFF projection, the biases,
    gelu, the LayerNorm statistics and the softmax stay f32.
    """
    strict_fp32()
    bf = _check_dtype(compute_dtype) == torch.bfloat16
    H, D = num_heads, head_dim
    q_coeff, q_w1, q_b1, v_coeff, v_w1, v_b1, fw, fb, m_w2, m_b2 = ws
    b, Z, C, _ = inv.shape
    hidm = m_w2.shape[0]

    # Per-head logits straight from the query RFF hidden (A holds the key and scale).
    hq = _rff_hidden(inv, q_coeff, q_w1, q_b1, bf)  # [b, z, c, hid]
    att = _mm(hq, A, bf) + ab[:, :, None, :] + wb[..., None]  # [b, z, c, H]

    # Value chain: FiLM and mixer dense 1 are one per-latent matmul with G / c.
    t = _normalize(gelu(_mm(_rff_hidden(inv, v_coeff, v_w1, v_b1, bf), fw, bf) + fb))
    pre = (_mm(t, G, bf) + c[:, :, None, :]).reshape(b, Z, C, H, hidm)
    if bf:
        nn = _normalize(gelu(pre))
        v_mix = torch.cat([_mm(nn[..., h, :], m_w2, bf) + m_b2 for h in range(H)], dim=-1)
    else:
        v_mix = (_normalize(gelu(pre)) @ m_w2 + m_b2).reshape(b, Z, C, H * D)

    # Softmax over latents on the narrow logits, then the weighted sum.
    m = att.amax(dim=1, keepdim=True)
    pr = torch.exp(att - m)
    pr = pr / pr.sum(dim=1, keepdim=True)
    if bf:
        pr = _b16(pr)
    y = (pr.repeat_interleave(D, dim=-1) * v_mix).sum(dim=1)  # [b, c, H*D]
    if not tws:
        return y

    o_w, o_b, p_w1, p_b1, p_w2, p_b2, h_w1, h_b1, h_w2, h_b2, h_w3, h_b3 = tws
    y = _mm(y, o_w, bf) + o_b
    t = _normalize(gelu(_mm(y, p_w1, bf) + p_b1))
    y = gelu(_mm(t, p_w2, bf) + p_b2)
    h = gelu(_mm(y, h_w1, bf) + h_b1)
    h = gelu(_mm(h, h_w2, bf) + h_b2)
    return _mm(h, h_w3, bf) + h_b3


# --------------------------------------------------------------------- kernel K1


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).removeprefix('torch.')}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(inv, wb, A, ab, G, c, ws, tws, num_heads: int, head_dim: int):
    """Validate the kernels' inputs; return (B, Z, C, I, hid, hidm, out_dim, with_tail)."""
    H, D = num_heads, head_dim
    dev = inv.device
    if inv.dim() != 4:
        raise ValueError(f"inv must be [b, z, c, I], got shape {tuple(inv.shape)}")
    B, Z, C, I = inv.shape
    if len(ws) != len(WEIGHT_NAMES):
        raise ValueError(f"expected {len(WEIGHT_NAMES)} folded weights, got {len(ws)}")
    hid = ws[1].shape[0]
    hidm = ws[8].shape[0]
    with_tail = len(tws) > 0
    if with_tail and len(tws) != len(TAIL_WEIGHT_NAMES):
        raise ValueError(f"expected {len(TAIL_WEIGHT_NAMES)} tail weights, got {len(tws)}")
    out_dim = tws[10].shape[1] if with_tail else H * D
    HD, HH = H * D, H * hidm
    expected = {
        "inv": (inv, (B, Z, C, I)), "wb": (wb, (B, Z, C)),
        "A": (A, (B, Z, hid, H)), "ab": (ab, (B, Z, H)),
        "G": (G, (B, Z, hid, HH)), "c": (c, (B, Z, HH)),
    }
    w_shapes = ((I, hid // 2), (hid, hid), (hid,), (I, hid // 2), (hid, hid), (hid,),
                (hid, hid), (hid,), (hidm, D), (D,))
    t_shapes = ((HD, HD), (HD,), (HD, HD), (HD,), (HD, HD), (HD,),
                (HD, hid), (hid,), (hid, hid), (hid,), (hid, out_dim), (out_dim,))
    for n, w, s in zip(WEIGHT_NAMES, ws, w_shapes):
        expected[n] = (w, s)
    for n, w, s in zip(TAIL_WEIGHT_NAMES, tws, t_shapes):
        expected[n] = (w, s)
    for n, (t, s) in expected.items():
        _check(n, t, s, dev)
    if hid % 4 or hidm % 4 or D % 4:
        raise ValueError(f"the kernel needs hid, hidm and D divisible by 4 (got {hid}, {hidm}, {D})")
    return B, Z, C, I, hid, hidm, out_dim, with_tail


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 (10 mantissa bits), to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: add half of the dropped 13 bits' unit, clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def k1_width_class(hid: int, hidm: int, D: int) -> int:
    """K1's width class for a decode shape, as ``width_class`` in its source: the narrowest
    of ``NARROW_CLASSES`` that holds hid, hidm and D, else ``WG_N``. It picks the kernel's
    instantiation and the slab width of ``split_weights``."""
    widest = max(hid, hidm, D)
    return next((c for c in NARROW_CLASSES if widest <= c), WG_N)


def _ws_class(ws: Sequence[torch.Tensor]) -> int:
    hidm, D = ws[WEIGHT_NAMES.index("m_w2")].shape
    return k1_width_class(ws[WEIGHT_NAMES.index("q_w1")].shape[0], hidm, D)


def split_weights(ws: Sequence[torch.Tensor], width: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``SPLIT_WEIGHT_NAMES`` of the folded weights as K1's products over a latent group's
    rows read them, at the width class ``wn`` of ``ws`` (``k1_width_class``), or at
    ``width`` (a build from before the narrow classes reads ``WG_N`` at every width).

    Each weight W [K, N] (K a multiple of 16; N padded with zeros to a multiple of ``wn``)
    is split into tf32 parts, big = tf32(W) and small = tf32(W - big), so big + small is
    within 2^-22 |W| of W, and laid out in the K-major blocks that ``wgmma`` reads from
    shared memory: one block of 32 ``wn`` floats (16 KB at ``WG_N``) per 16-deep chunk kc of
    k and ``wn``-wide slab s of n, holding in order part (big, small), k step q (2), n group
    ng (``wn`` / 8 of 8), k group kg (2 of 4), row r (8), k i (4), i.e. the element
    W[16 kc + 8 q + 4 kg + i, wn s + 8 ng + r]. The narrow classes (N <= wn: one slab) keep
    a weight's blocks resident in shared memory; ``WG_N`` streams them through a ring.

    Returns one contiguous buffer and, per weight, its view
    [K / 16, N / wn, 2, 2, wn / 8, 2, 8, 4], whose pointers K1 takes after ``out``.
    """
    wn = width or _ws_class(ws)
    blocks = []
    for name in SPLIT_WEIGHT_NAMES:
        w = ws[WEIGHT_NAMES.index(name)]
        K, N = w.shape
        if K % 16:
            raise ValueError(f"{name}: K1 needs the rows of {name} in chunks of 16, got {K}")
        w = torch.nn.functional.pad(w, (0, -N % wn))
        big = _tf32(w)
        parts = torch.stack([big, _tf32(w - big)])  # [part, K, N]
        blk = parts.reshape(2, K // 16, 2, 2, 4, w.shape[1] // wn, wn // 8, 8)  # part kc q kg i s ng r
        blocks.append(blk.permute(1, 5, 0, 2, 6, 3, 7, 4).contiguous())  # kc s part q ng kg r i
    buf = torch.cat([b.reshape(-1) for b in blocks])
    views, off = [], 0
    for b in blocks:
        views.append(buf[off:off + b.numel()].view(b.shape))
        off += b.numel()
    return buf, tuple(views)


def bf16_weights(ws: Sequence[torch.Tensor], width: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``split_weights``' counterpart for K1's bf16 program: ``SPLIT_WEIGHT_NAMES`` of the folded
    weights rounded to bf16 (to nearest, ties to even) in the K-major blocks that its bf16
    ``wgmma`` reads, at the width class ``wn`` of ``ws`` (or ``width``).

    Each weight W [K, N] (K a multiple of 16; N padded with zeros to a multiple of ``wn``) is laid
    out as one block of 16 ``wn`` bf16 per 16-deep chunk kc and ``wn``-wide slab s, holding in
    order n group ng (``wn`` / 8), k group kg (2), row r (8), k i (8): the element
    W[16 kc + 8 kg + i, wn s + 8 ng + r] (core matrices of 8 n x 16 bytes, the two k groups 128
    bytes apart, the n groups 256). Returns one contiguous bf16 buffer and, per weight, its view
    [K / 16, N / wn, wn / 8, 2, 8, 8], whose pointers the bf16 K1 takes after ``out``.
    """
    wn = width or _ws_class(ws)
    blocks = [bf16_blocks(ws[WEIGHT_NAMES.index(name)], wn, name) for name in SPLIT_WEIGHT_NAMES]
    buf = torch.cat([b.reshape(-1) for b in blocks])
    views, off = [], 0
    for b in blocks:
        views.append(buf[off:off + b.numel()].view(b.shape))
        off += b.numel()
    return buf, tuple(views)


def bf16_blocks(w: torch.Tensor, wn: int = WG_N, name: str = "weight") -> torch.Tensor:
    """One weight W [K, N] (K a multiple of 16; N padded with zeros to a multiple of ``wn``) rounded to bf16
    in the K-major blocks of ``bf16_weights``: [K / 16, N / wn, wn / 8, 2, 8, 8], element W[16 kc + 8 kg + i,
    wn s + 8 ng + r] at [kc, s, ng, kg, r, i]. Leading dimensions of ``w`` before the last two are kept."""
    K, N = w.shape[-2:]
    if K % 16:
        raise ValueError(f"{name}: K1 needs the rows of {name} in chunks of 16, got {K}")
    w = torch.nn.functional.pad(w, (0, -N % wn)).to(torch.bfloat16)
    lead = w.shape[:-2]
    blk = w.reshape(*lead, K // 16, 2, 8, w.shape[-1] // wn, wn // 8, 8)  # kc kg i s ng r
    d = len(lead)
    return blk.permute(*range(d), d, d + 3, d + 4, d + 1, d + 5, d + 2).contiguous()  # kc s ng kg r i


def bf16_g_blocks(G: torch.Tensor, num_heads: int, wn: int = WG_N) -> torch.Tensor:
    """G [b, z, hid, H hidm] as the bf16 program reads it at the width class ``wn`` (``k1_width_class``):
    each head's hidm columns padded to ``wn`` and blocked as ``bf16_blocks`` blocks a weight,
    [b, z, H, hid / 16, wn / 8, 2, 8, 8] (element G[b, z, 16 kc + 8 kg + i, h hidm + 8 ng + r] at
    [b, z, h, kc, ng, kg, r, i]): a head's chunks of 16 rows, 32 ``wn`` bytes each (4 KB at ``WG_N``), one
    after the other, and a latent's heads one after the other (a narrow class copies a latent's whole). A
    head wider than ``WG_N`` (hidm up to 2 ``WG_N``, the class 128's wide instantiation) is padded to two
    slabs, [b, z, H, hid / 16, 2, WG_N / 8, 2, 8, 8]: a chunk of 16 rows holds both slabs' blocks. JAX
    rounds G to bf16 at its product anyway."""
    b, z, hid, hh = G.shape
    heads = G.reshape(b, z, hid, num_heads, hh // num_heads).transpose(2, 3)  # [b, z, H, hid, hidm]
    if heads.shape[-1] > (2 if wn == WG_N else 1) * wn:
        raise ValueError(f"the bf16 K1 takes a head of G at most {2 * WG_N if wn == WG_N else wn} wide at the width "
                         f"class {wn}, got {heads.shape[-1]}")
    blocks = bf16_blocks(heads, wn, "G")
    return blocks[:, :, :, :, 0] if blocks.shape[4] == 1 else blocks


class K1Operands(NamedTuple):
    """What K1 reads laid out for its program, made once for every launch with the same fold
    (``k1_operands``): the shared weights' blocks (``shared_weights``) and, for the bf16 program, G
    (``bf16_g_blocks``) and the tail's ``BLOCKED_TAIL_NAMES`` (``bf16_blocks``) in bf16 blocks at the
    width class; else None and () (the f32 program reads them as the fold gives them)."""
    shared: Tuple[torch.Tensor, ...]
    G: Optional[torch.Tensor]
    tail: Tuple[torch.Tensor, ...]


def k1_operands(G: torch.Tensor, ws: Sequence[torch.Tensor], tws: Sequence[torch.Tensor], num_heads: int,
                compute_dtype: torch.dtype = torch.float32) -> K1Operands:
    """``K1Operands`` of a fold: once a decode (``models.decoder.decode_trajectories``), or once a launch
    where the wrapper is given none (``FusedDecode``: once a training step)."""
    shared = shared_weights(ws, compute_dtype)
    if compute_dtype != torch.bfloat16:
        return K1Operands(shared, None, ())
    wn = _ws_class(ws)
    return K1Operands(shared, bf16_g_blocks(G, num_heads, wn), _tail_blocks(tws, wn))


def _tail_blocks(tws: Sequence[torch.Tensor], wn: int = WG_N) -> Tuple[torch.Tensor, ...]:
    return tuple(bf16_blocks(tws[TAIL_WEIGHT_NAMES.index(n)], wn, n) for n in BLOCKED_TAIL_NAMES) if tws else ()


def shared_weights(ws: Sequence[torch.Tensor], compute_dtype: torch.dtype = torch.float32,
                   width: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """The views K1 takes as ``split`` for ``compute_dtype``: ``split_weights(ws)[1]`` (f32) or
    ``bf16_weights(ws)[1]`` (bf16). Made once per fold, they serve every chunk of a decode."""
    bf = _check_dtype(compute_dtype) == torch.bfloat16
    return (bf16_weights if bf else split_weights)(ws, width)[1]


def _check_split(split: Sequence[torch.Tensor], ws: Sequence[torch.Tensor], device: torch.device,
                 width: Optional[int] = None, compute_dtype: torch.dtype = torch.float32) -> None:
    """``split`` is ``shared_weights(ws, compute_dtype, width)`` in shape and type: the blocks K1
    reads for each weight."""
    if len(split) != len(SPLIT_WEIGHT_NAMES):
        raise ValueError(f"expected {len(SPLIT_WEIGHT_NAMES)} split weights, got {len(split)}")
    wn = width or _ws_class(ws)
    bf = compute_dtype == torch.bfloat16
    for name, blk in zip(SPLIT_WEIGHT_NAMES, split):
        K, N = ws[WEIGHT_NAMES.index(name)].shape
        shape = (K // 16, -(-N // wn), wn // 8, 2, 8, 8) if bf else (K // 16, -(-N // wn), 2, 2, wn // 8, 2, 8, 4)
        _check(f"split {name}", blk, shape, device, compute_dtype)


def _check_aligned16(named: Dict[str, torch.Tensor], nbytes: int = 16) -> None:
    """K1 stages these by 16-byte ``cp.async``, K2 reads some a float4 at a time: each must
    start on 16 bytes (a contiguous view at a storage offset that is not a multiple of 4 floats
    does not); the bf16 K1's class 128 reads its f32 operands two at a time (``nbytes`` 8)."""
    for name, t in named.items():
        if t.data_ptr() % nbytes:
            raise ValueError(f"{name} must start on {nbytes} bytes for the kernels (storage offset {t.storage_offset()})")


@functools.lru_cache(maxsize=None)
def _source_constants(source: str) -> Dict[str, int]:
    """The ``constexpr int NAME = expr;`` lines of a kernel source and of the headers it
    includes, in the order the compiler reads them, each an integer expression of the ones
    before (read once a process: a launch's host-side layout check reads them)."""
    env: Dict[str, int] = {}
    text = cuda_lib.expanded_source(cuda_lib.CSRC_DIR / source)
    for name, expr in re.findall(r"^constexpr int (\w+) = ([\w\s*+/()-]+);", text, re.M):
        # C's integer division; the expression holds only integers and earlier names.
        env[name] = int(eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(env)))
    return env


def k1_constants(compute_dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """K1's layout constants (TILE, ZG, RING_FLOATS, MAXW, SMEM_CAP, the narrow classes'
    ZG16 / RES16 / MINB16, ...), read from the
    ``constexpr int NAME = expr;`` lines of its source (the f32 or the bf16 program's), each an
    integer expression of the ones before: the kernel and ``k1_smem_bytes`` share one set of
    constants."""
    return _source_constants(kernel_sources(compute_dtype)[0])


def _k1_layout(Z: int, I: int, hid: int, H: int, D: int, hidm: int,
               compute_dtype: torch.dtype = torch.float32) -> Tuple[int, bool, int]:
    """``k1_smem_bytes``, whether the bf16 program keeps the logits in global memory, and the blocks an
    SM its narrow classes plan for (``narrow_slots``; 0 elsewhere)."""
    bf = _check_dtype(compute_dtype) == torch.bfloat16
    k = k1_constants(compute_dtype)
    tile, zg, kc = k["TILE"], k["ZG"], k["KC"]
    if Z <= 0 or I <= 0 or H <= 0:
        raise ValueError(f"K1 needs Z, I and H positive, got {Z}, {I}, {H}")
    if hid % kc or hidm % kc or D % kc or hid > zg * tile:
        raise ValueError(f"K1 needs hid, hidm and D in multiples of {kc} and hid <= {zg * tile}, "
                         f"got {hid}, {hidm}, {D}")
    if hidm > k["MAXW"] or H * D > k["MAXW"]:
        raise ValueError(f"K1 needs hidm and H*D <= {k['MAXW']}, got {hidm}, {H * D}")
    if I > hid + 4:
        raise ValueError(f"K1 stages a latent group's invariants in Y: it needs I <= hid + 4, got {I}")

    def stride(w: int) -> int:  # row_stride: 4 mod 32 words
        return (w + 31) // 32 * 32 + 4

    ld_p, ld_w = stride(H * hidm), stride(max(H * D, hid))
    wn = k1_width_class(hid, hidm, D)
    # The softmax's shared floats: the f32 program's group logits, running max, sum and factor;
    # the bf16 program's every latent's logits, where they fit (`place_logits`) in `cap` bytes.
    lg_rows, cap, slots = tile, k["SMEM_CAP"], 0  # rows of a latent's logits
    if bf and wn == k["WG_N"]:  # hidm or D past WG_N: the wide instantiation, the same layout
        smem, lg_rows = k["SMEM128"], k["TILE128"]
    elif bf:  # narrow_layout: the shared weights, xs, r1 (X, Y, G a warpgroup; the tail's operands), r2
        T, HD = k["TILE128"], H * D
        ld, hdp = (HD + 23) // 32 * 32 + 8, -(-HD // wn) * wn
        pw = 2 * T * (hid + max(hid, hidm)) + 2 * hid * H * wn
        r2 = (3 * hid + hidm) * wn * 2 + k["XS_BYTES"] + max(2 * pw, 4 * T * max(HD, hid))
        smem, lg_rows = r2 + max(8 * T * ld, 4 * T * ld + 2 * max(HD * hdp, hid * wn)), T
        room = k["SM_SHARED"] // k[f"BLOCKS{wn}"] - k["SM_KEPT"]
        cap = room if smem <= room else cap
    elif wn == k["WG_N"]:
        ld_x = stride(hid)
        n_y = max(zg * tile * ld_x, 2 * tile * ld_p, tile * ld_w)
        smem = 4 * (zg * tile * ld_x + n_y + tile * ld_w + k["RING_FLOATS"] + (zg + 3) * tile * H)
    else:
        zg = k[f"ZG{wn}"]
        rows, ld_x = zg * tile, wn + 4
        n_y = max(rows * ld_x, 2 * tile * ld_p, tile * ld_w)
        n_w = (3 * hid + hidm) // kc * 32 * wn if k[f"RES{wn}"] else k["STAGES"] * 32 * wn
        smem = 4 * (rows * ld_x + n_y + tile * ld_w + n_w + (zg + 3) * tile * H + zg * hid * H)
    logits_global = bf and smem + 4 * Z * lg_rows * H > cap
    if bf and not logits_global:
        smem += 4 * Z * lg_rows * H
    if smem > k["SMEM_CAP"]:
        raise ValueError(f"K1 would need {smem} B of shared memory, more than {k['SMEM_CAP']}")
    if bf and wn < k["WG_N"]:
        slots = k[f"BLOCKS{wn}"] if smem <= room else 1
    return smem, logits_global, slots


def k1_smem_bytes(Z: int, I: int, hid: int, H: int, D: int, hidm: int,
                  compute_dtype: torch.dtype = torch.float32) -> int:
    """K1's dynamic shared memory in bytes for a decode shape, as ``layout`` in
    ``csrc/fused_decode_fwd.cu`` computes it for the shape's width class
    (``k1_width_class``). At ``WG_N``: X, Y (which also stages a latent group's
    invariants), acc, the ``cp.async`` ring and two split A chunks, then one latent group's
    logits and the online softmax's running max, sum and factor. Narrow (class ``wn``): X
    and Y of ``ZG<wn>`` latents' rows at a stride of ``wn`` + 4, acc, the four shared
    weights resident (``RES<wn>``) or a ring of ``STAGES`` of their blocks, the softmax's
    state and the group's A. The f32 program's does not depend on ``Z``. The bf16 program
    (``compute_dtype=torch.bfloat16``, ``fused_decode_fwd_bf16.cu``) keeps every latent's logits
    ([Z][64][H]) where they fit beside the rest, else in a workspace in global memory
    (``k1_logits_floats``), so that its layout too takes every ``Z``. Its class 128 (``SMEM128``: two
    bf16 operand buffers of 64 x 256, the attention output, m_w2 resident, two warpgroups' rings, the row
    sums' exchange) holds them up to z = 62 at NS width; hidm or D past 128 (up to 256) take its wide
    instantiation in the same layout. Its narrow classes (``narrow_layout``: the shared weights resident,
    each warpgroup's operands, G and share of the attention output, the tail's operands, stage and a
    layer's weights in their place) hold them where ``BLOCKS<wn>`` blocks still fit an SM (else where
    one does). Raises ``ValueError`` for a shape that ``layout`` refuses: widths it does not take, or
    more than ``SMEM_CAP`` bytes."""
    return _k1_layout(Z, I, hid, H, D, hidm, compute_dtype)[0]


def k1_plan(B: int, Z: int, C: int, I: int, hid: int, H: int, D: int, hidm: int,
            compute_dtype: torch.dtype = torch.float32, sms: int = SMS) -> Tuple[int, int, int]:
    """(tile, items, grid) of a K1 launch, as its launcher plans it on a card of ``sms`` SMs: the bf16
    program walks items of 64 coordinates of a batch row (32 where items of 64 would leave half of the
    grid's slots idle, ``item_tile``) with persistent blocks, one an SM at the class 128 and
    ``narrow_slots`` (``BLOCKS<wn>`` where they fit) at the narrow classes; the f32 program takes tiles of
    ``TILE``, a block each (its narrow classes' grid also depends on their blocks an SM,
    ``k1_occupancy``: here one a tile)."""
    k = k1_constants(compute_dtype)
    tile = k["TILE"]
    if compute_dtype == torch.bfloat16:
        per_sm = _k1_layout(Z, I, hid, H, D, hidm, compute_dtype)[2] or 1
        slots = per_sm * sms
        tile = tile if 2 * B * -(-C // k["TILE128"]) <= slots else k["TILE128"]
        items = B * -(-C // tile)
        return tile, items, min(items, slots)
    items = B * -(-C // tile)
    return tile, items, items


def k1_logits_floats(B: int, Z: int, C: int, I: int, hid: int, H: int, D: int, hidm: int,
                     compute_dtype: torch.dtype = torch.float32, sms: int = SMS) -> int:
    """Floats of the global-memory logits workspace a K1 launch needs: 0 for the f32 program and
    for a bf16 launch whose logits fit shared memory, else a slot of ``[Z][64][H]`` for each block of
    its persistent grid on a card of ``sms`` SMs (``k1_plan``)."""
    if not _k1_layout(Z, I, hid, H, D, hidm, compute_dtype)[1]:
        return 0
    return k1_plan(B, Z, C, I, hid, H, D, hidm, compute_dtype, sms)[2] * Z * k1_constants(compute_dtype)["TILE128"] * H


def k1_library_smem_bytes(dims: Sequence[int], compute_dtype: torch.dtype = torch.float32) -> int:
    """The shared memory that the built K1 library's ``layout`` gives a launch with these
    dims (the launcher's ``B, Z, C, I, hid, H, D, hidm, out_dim, with_tail``), -1 for a
    shape it refuses; on the card, held against ``k1_smem_bytes``."""
    fn = cuda_lib.load(kernel_sources(compute_dtype)[0]).fused_decode_fwd_smem_bytes
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn((ctypes.c_int * len(dims))(*dims), len(dims)))


def k1_occupancy(dims: Sequence[int], source: str = KERNEL_SOURCE) -> Tuple[int, int]:
    """The built K1 library's width class for a launch with these dims (the launcher's) and
    the blocks of that instantiation an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    at its shared memory); raises for a shape it refuses. On the card; ``source`` may name
    another build of the same C interface."""
    fn = cuda_lib.load(source).fused_decode_fwd_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    rc = fn((ctypes.c_int * len(dims))(*dims), len(dims), out)
    if rc != 0:
        raise RuntimeError(f"fused_decode_fwd_occupancy failed for dims {list(dims)} (cudaError {rc})")
    return int(out[0]), int(out[1])


def k1_library_plan(dims: Sequence[int], source: str = KERNEL_SOURCE) -> Dict[str, int]:
    """The built K1 library's plan of a launch with these dims (the launcher's) on this card
    (``fused_decode_fwd_plan``): its width class, blocks an SM, coordinates a work item and grid;
    raises for a shape it refuses. On the card; ``source`` may name another build."""
    fn = cuda_lib.load(source).fused_decode_fwd_plan
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    rc = fn((ctypes.c_int * len(dims))(*dims), len(dims), out)
    if rc != 0:
        raise RuntimeError(f"fused_decode_fwd_plan failed for dims {list(dims)} (cudaError {rc})")
    return dict(cls=int(out[0]), per_sm=int(out[1]), tile=int(out[2]), grid=int(out[3]))


def _fwd_lib(source: str = KERNEL_SOURCE):
    """K1's library, bound; ``source`` may name another build of the same C interface."""
    lib = cuda_lib.load(source)
    launch = lib.fused_decode_fwd_launch
    launch.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    lib.fused_decode_fwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_decode_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_blocked(ops: K1Operands, G: torch.Tensor, tws, num_heads: int, device: torch.device, wn: int) -> None:
    """``ops.G`` and ``ops.tail`` are ``bf16_g_blocks(G, num_heads, wn)`` and the tail's ``bf16_blocks`` at the
    width class ``wn`` in shape and type (the bf16 program reads nothing else in their place)."""
    b, z, hid, hh = G.shape
    slabs = -(-hh // num_heads // wn)
    _check("blocked G", ops.G, (b, z, num_heads, hid // 16, *((slabs,) if slabs > 1 else ()), wn // 8, 2, 8, 8), device,
           torch.bfloat16)
    if len(ops.tail) != (len(BLOCKED_TAIL_NAMES) if tws else 0):
        raise ValueError(f"expected {len(BLOCKED_TAIL_NAMES) if tws else 0} blocked tail weights, got {len(ops.tail)}")
    for name, blk in zip(BLOCKED_TAIL_NAMES, ops.tail):
        K, N = tws[TAIL_WEIGHT_NAMES.index(name)].shape
        _check(f"blocked {name}", blk, (K // 16, -(-N // wn), wn // 8, 2, 8, 8), device, torch.bfloat16)


def _launch(inv, wb, A, ab, G, c, ws, tws, num_heads: int, head_dim: int, split=None,
            lib=None, width: Optional[int] = None, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    H, D = num_heads, head_dim
    dev = inv.device
    bf = _check_dtype(compute_dtype) == torch.bfloat16
    B, Z, C, I, hid, hidm, out_dim, with_tail = _check_inputs(inv, wb, A, ab, G, c, ws, tws, H, D)
    # The bf16 program's logits workspace, where they do not fit shared memory.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else SMS
    n_lg = k1_logits_floats(B, Z, C, I, hid, H, D, hidm, compute_dtype, sms) if bf else 0
    # What the program reads laid out for it: `split` (``k1_operands``, or the shared weights alone,
    # ``shared_weights``), else laid out here for this launch.
    wn = width or _ws_class(ws)
    if split is None:
        split = k1_operands(G, ws, tws, H, compute_dtype) if width is None else K1Operands(
            shared_weights(ws, compute_dtype, width), None, ())
    elif not isinstance(split, K1Operands):
        split = K1Operands(tuple(split), None, ())
    if bf and split.G is None:
        split = split._replace(G=bf16_g_blocks(G, H, wn), tail=_tail_blocks(tws, wn))
    _check_split(split.shared, ws, dev, width, compute_dtype)
    G_in, tail_in = G, {n: tws[TAIL_WEIGHT_NAMES.index(n)] for n in BLOCKED_TAIL_NAMES} if with_tail else {}
    if bf:
        _check_blocked(split, G, tws, H, dev, wn)
        G_in, tail_in = split.G, dict(zip(BLOCKED_TAIL_NAMES, split.tail))
        _check_aligned16({"A": A, "c": c, **{n: w for n, w in zip(WEIGHT_NAMES, ws) if w.dim() == 1 or "coeff" in n},
                          **{n: w for n, w in zip(TAIL_WEIGHT_NAMES, tws) if w.dim() == 1}}, 8)
    staged = {"G": G_in, **{f"split {n}": w for n, w in zip(SPLIT_WEIGHT_NAMES, split.shared)}, **tail_in}
    _check_aligned16(staged)
    lib = lib or _fwd_lib(kernel_sources(compute_dtype)[0])

    out = torch.empty(B, C, out_dim, device=dev, dtype=torch.float32)
    tail_ptrs = [tail_in.get(n, t).data_ptr() for n, t in zip(TAIL_WEIGHT_NAMES, tws)] if with_tail \
        else [None] * len(TAIL_WEIGHT_NAMES)
    ptrs = [inv.data_ptr(), wb.data_ptr(), A.data_ptr(), ab.data_ptr(), G_in.data_ptr(),
            c.data_ptr(), *[w.data_ptr() for w in ws], *tail_ptrs, out.data_ptr(),
            *[w.data_ptr() for w in split.shared]]
    if n_lg:
        logits = torch.empty(n_lg, device=dev, dtype=torch.float32)
        ptrs.append(logits.data_ptr())
    dims = [B, Z, C, I, hid, H, D, hidm, out_dim, int(with_tail)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_decode_fwd_launch((ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
                                         (ctypes.c_int * len(dims))(*dims), len(dims),
                                         ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.fused_decode_fwd_error_string(rc).decode()
        raise RuntimeError(f"fused_decode_fwd launch failed for dims {dims}: {msg} (cudaError {rc})")
    fused_decode_fwd.launches += 1
    fused_decode_fwd.launches_by_program[(compute_dtype, B, Z, C, I)] += 1
    return out


def fused_decode_fwd(inv, wb, A, ab, G, c, ws: Sequence[torch.Tensor],
                     tws: Sequence[torch.Tensor], num_heads: int, head_dim: int,
                     split: Optional[Sequence[torch.Tensor]] = None,
                     compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel K1: the fused forward decode.

    ``inv`` [b, z, c, I] and ``wb`` [b, z, c] are the latent-major invariants and
    window bias; the rest is what ``fold_decode_weights`` returns. ``compute_dtype`` picks
    the program: ``torch.float32`` (3xTF32, ``fused_decode_fwd.cu``) or ``torch.bfloat16``
    (bf16 operands, f32 sums: ``fused_decode_fwd_bf16.cu``), as ``fused_decode_plain``
    defines them. ``split`` may be ``k1_operands(G, ws, tws, num_heads, compute_dtype)`` (or
    ``shared_weights(ws, compute_dtype)`` alone), made once for every launch with the same fold;
    without it each launch lays out what its program reads anew: the shared weights and, for the
    bf16 program's class 128, G and the tail's weights in bf16 blocks.

    On CPU tensors this is ``fused_decode_plain`` at ``compute_dtype`` (``split`` is not
    read); on CUDA tensors it launches that program on the current stream (counted in
    ``fused_decode_fwd.launches`` and by ``(compute_dtype, b, z, c, I)`` in
    ``launches_by_program``) or raises. Returns
    [b, c, num_out] with tail weights, else [b, c, H*D].
    """
    if inv.device.type == "cpu":
        return fused_decode_plain(inv, wb, A, ab, G, c, ws, tws, num_heads, head_dim, compute_dtype)
    if inv.device.type != "cuda":
        raise ValueError(f"fused_decode_fwd runs on CPU or CUDA tensors, got {inv.device}")
    return _launch(inv, wb, A, ab, G, c, ws, tws, num_heads, head_dim, split, compute_dtype=compute_dtype)


fused_decode_fwd.launches = 0
fused_decode_fwd.launches_by_program = collections.Counter()


# --------------------------------------------------------------------- kernel K2


def fused_decode_bwd_plain(inv, wb, A, ab, G, c, ws: Sequence[torch.Tensor],
                           tws: Sequence[torch.Tensor], g: torch.Tensor, num_heads: int,
                           head_dim: int, weight_grads: bool = True,
                           compute_dtype: torch.dtype = torch.float32):
    """The VJP of ``fused_decode_plain`` (at ``compute_dtype``) at cotangent ``g`` [b, c, out],
    by autograd: in bf16 its casts round the cotangents as JAX's transposes do.

    Returns ``(dinv, dwb, dA, dab, dG, dc, dws, dtws)``: the first six have their
    inputs' shapes; ``dws`` / ``dtws`` follow ``ws`` / ``tws``, with ``None`` for the
    RFF coefficients (never trained) and everywhere when ``weight_grads`` is False.
    """
    with torch.enable_grad():
        lat = [x.detach().requires_grad_(True) for x in (inv, wb, A, ab, G, c)]
        wts = [w.detach().requires_grad_(weight_grads and i not in COEFF_INDICES)
               for i, w in enumerate((*ws, *tws))]
        out = fused_decode_plain(*lat, wts[:len(ws)], wts[len(ws):], num_heads, head_dim, compute_dtype)
        targets = lat + [w for w in wts if w.requires_grad]
        grads = list(torch.autograd.grad(out, targets, g))
    dlat, dw_iter = grads[:6], iter(grads[6:])
    dwts = [next(dw_iter) if w.requires_grad else None for w in wts]
    return (*dlat, tuple(dwts[:len(ws)]), tuple(dwts[len(ws):]))


def _bwd_lib(source: str = BWD_KERNEL_SOURCE):
    """K2's library, bound; ``source`` may name another build of the same C interface."""
    lib = cuda_lib.load(source)
    lib.fused_decode_bwd_sizes.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_decode_bwd_sizes.restype = ctypes.c_int
    lib.fused_decode_bwd_launch.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                            ctypes.c_void_p]
    lib.fused_decode_bwd_launch.restype = ctypes.c_int
    lib.fused_decode_bwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_decode_bwd_error_string.restype = ctypes.c_char_p
    return lib


def k2_width_class(hid: int, hidm: int, D: int) -> int:
    """K2's width class, as ``width_class`` in its source: the columns of a product each
    warpgroup takes (its wgmma's N), 64 when the narrowest of hid, hidm and D is at least 128,
    32 from 64, 16 from 32, else 8."""
    w = min(hid, hidm, D)
    return 64 if w >= 128 else 32 if w >= 64 else 16 if w >= 32 else 8


def k2_constants(compute_dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """K2's layout constants (TILE, THREADS, KC, MINB64 ... MINB8, MIN_IPB, MAX_I,
    MAX_SEG, SMEM_CAP),
    read from the ``constexpr int`` lines of its source (the f32 or the bf16 program's), as
    ``k1_constants`` reads K1's."""
    return _source_constants(kernel_sources(compute_dtype)[1])


def _k2_layout(Z: int, I: int, hid: int, H: int, D: int, hidm: int,
               compute_dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """``shape`` in ``csrc/fused_decode_bwd.cu`` (or its bf16 program's) without the grid: the
    width class, the shared row strides and the dynamic shared memory; raises ``ValueError`` for
    what it refuses."""
    bf = _check_dtype(compute_dtype) == torch.bfloat16
    k = k2_constants(compute_dtype)
    tile = k["TILE"]
    if Z <= 0 or H <= 0 or not 0 < I <= k["MAX_I"]:
        raise ValueError(f"K2 needs Z and H positive and 0 < I <= {k['MAX_I']}, got {Z}, {H}, {I}")
    if any(w < 16 or w % 16 for w in (hid, hidm, D)):
        raise ValueError(f"K2 needs hid, hidm and D in multiples of 16, got {hid}, {hidm}, {D}")
    if max(hid, hidm, H * D) > k["MAX_SEG"]:
        raise ValueError(f"K2 needs hid, hidm and H*D <= {k['MAX_SEG']}, got {hid}, {hidm}, {H * D}")
    wn = k2_width_class(hid, hidm, D)
    if bf and wn < 64:  # the bf16 program's narrow design (`narrow_shape`)
        return dict(wn=wn, narrow=True, w128=False, **k2_narrow_layout(hid, H, D, hidm))
    if hid % wn or hidm % wn or D % wn:
        raise ValueError(f"K2's width class {wn} must divide hid, hidm and D, got {hid}, {hidm}, {D}")

    def stride(w: int) -> int:  # row_stride: 4 mod 32 words
        return (w + 31) // 32 * 32 + 4

    ldh, ldw = stride(hid), stride(max(H * hidm, H * D, hid))
    n_w2 = tile * max(ldw, 2 * ldh)
    if bf and k2_w128_design(Z, hid, H, D, hidm):  # the bf16 program's W128 design (`fused_decode_bwd_w128`)
        return dict(wn=wn, ldh=ldh, ldw=ldw, smem=k["W128_SMEM"] + 4 * 2 * Z * tile * 2, stages=k["W128_STAGES"], w128=True,
                    narrow=False)
    # The B staging ring: chunk buffers of two slabs of 16 x wn, two tf32 parts (32 wn floats a
    # slab) or three bf16 ones (24 wn); the bf16 program also keeps two [TILE][H] rows (the sums
    # of the rounded softmax weights and <dy, m_b2>).
    slab, extra = (24 * wn, 2 * tile * H) if bf else (32 * wn, 0)
    for stages in ((3, 2) if wn == 64 else (2,)):
        smem = 4 * (stages * 2 * slab + tile * ldw + tile * ldh + n_w2 + 2 * Z * tile * H + extra + tile * I)
        if smem <= k["SMEM_CAP"]:
            return dict(wn=wn, ldh=ldh, ldw=ldw, smem=smem, stages=stages, w128=False, narrow=False)
    raise ValueError(f"K2 would need {smem} B of shared memory for {Z} latents, more than {k['SMEM_CAP']}")


def k2_w128_design(Z: int, hid: int, H: int, D: int, hidm: int) -> bool:
    """Whether a bf16 K2 launch of these widths takes the bf16 program's W128 design
    (``fused_decode_bwd_w128``, ``Dims::w128``): hid = hidm = D = ``W128_HID`` with two heads (every decoder at
    Navier-Stokes width: NS, shallow water, ``abs_pos``, behind self-attention blocks), where its shared
    memory (``W128_SMEM`` and every latent's softmax weights and dp, 1,024 B a latent) fits ``SMEM_CAP``.
    The other shapes of the width class 64 take the class's design of the f32 program's kind; the narrower
    classes the narrow design (``k2_narrow_design``)."""
    k = k2_constants(torch.bfloat16)
    return (hid == hidm == D == k["W128_HID"] and H == 2 and k2_width_class(hid, hidm, D) == 64
            and k["W128_SMEM"] + 4 * 2 * Z * k["TILE"] * 2 <= k["SMEM_CAP"])


def k2_narrow_design(hid: int, hidm: int, D: int) -> bool:
    """Whether a bf16 K2 launch of these widths takes the bf16 program's narrow design (``Dims::narrow``: the
    kernels ``narrow_logits`` ... ``narrow_query_vjp``, a (batch row, latent, tile) item a block of one
    warpgroup): every launch below the width class 64 (8, 16, 32: diff_sphere, ihc, the planar configs). It
    takes hid = hidm = D = 16, 32 or 64 with at most ``NH_MAX`` heads and ``NHD_MAX`` columns H D and refuses
    the rest of those classes (``k2_narrow_layout`` raises)."""
    return k2_width_class(hid, hidm, D) < 64


def k2_narrow_layout(hid: int, H: int, D: int, hidm: int) -> Dict[str, int]:
    """The narrow design's shared memory in bytes, as ``nl_layout`` and ``nt_layout`` in
    ``csrc/fused_decode_bwd_bf16.cu`` lay it out: ``smem``, the per-latent kernels' (the weights q_w1 or v_w1 and
    fw, a latent's G, three [64][hid] bf16 operands, dpre's three planes or du's, dhv and dF, the invariants, the
    softmax weights, the column sums' and the row sums' exchanges), and ``smem_t``, the tail kernel's (two weight
    buffers, two buffers of three bf16 planes, two activations, the dt1 stage, psum, the exchanges); ``pc`` and ``xc``, the
    columns of its planes and activations. Raises ``ValueError`` for a shape the design refuses."""
    k = k2_constants(torch.bfloat16)
    W, tile = hid, k["TILE"]
    if not (hidm == D == W and W in (16, 32, 64)):
        raise ValueError(f"K2's narrow design takes hid = hidm = D = 16, 32 or 64, got {hid}, {hidm}, {D}")
    if H > k["NH_MAX"] or H * D > k["NHD_MAX"]:
        raise ValueError(f"K2's narrow design takes at most {k['NH_MAX']} heads and H*D <= {k['NHD_MAX']}, got {H}, {H * D}")
    HH = HD = H * W

    def r(x: int, m: int) -> int:
        return -(-x // m) * m

    smem = (2 * W * W * 2 + W * HH * 2 + 3 * tile * W * 2 + max(3 * tile * HH * 2, 3 * tile * W * 2 + tile * W * 2 + tile * W * 4)
            + tile * k["MAX_I"] * 4 + r(tile * H * 4, 16) + 4 * max(HH, W) * 4 + k["NXS"])
    pc, xc = HD, r(HD, 64)
    smem_t = (2 * max(HD * HD, HD * W, W * W) * 2 + 2 * 3 * tile * pc * 2 + 2 * tile * xc * 2 + tile * HD * 2
              + r(tile * H * 4, 16) + 4 * max(HD, W) * 4 + k["NXS"])
    if max(smem, smem_t) > k["SMEM_CAP"]:
        raise ValueError(f"K2's narrow design would need {max(smem, smem_t)} B of shared memory, more than {k['SMEM_CAP']}")
    return dict(smem=smem, smem_t=smem_t, pc=pc, xc=xc)


def k2_narrow_plan(B: int, Z: int, C: int, I: int, hid: int, H: int, D: int, hidm: int, out: int, tail: bool,
                   weight_grads: bool, per_sm: Optional[int] = None, sms: int = 132) -> Dict[str, int]:
    """The narrow design's plan and scratch, as ``narrow_plan`` lays them out for ``per_sm`` blocks of the
    per-latent kernels on each of ``sms`` SMs (by default the most their shared memory and threads allow: blocks of
    two warpgroups from hid 32, of one below): ``grid`` and ``ipb`` (persistent blocks, a contiguous run of (b, z,
    tile) items each), ``slots`` (the (b, z) rows a run touches), ``grid_t`` (the tail's blocks over its (b, tile)
    items, as many an SM as its shared memory allows; at least two items a block with weight gradients), and
    ``scratch`` in bytes: the workspace (the weight images and G's in bf16; every latent's logits, later its dp, and
    softmax weights [b z][C padded][H] and nn in bf16; e and <dy, m_b2> a batch row; a tail block's q1, gelu'(q2),
    gelu'(q3) and, with weight gradients, its activations' and nbar's images) and the partials (a per-latent block's
    row slots and q_w1 ... fb, a tail block's m_w2 a head ... h_b3)."""
    k = k2_constants(torch.bfloat16)
    lay = k2_narrow_layout(hid, H, D, hidm)
    W, tile = hid, k["TILE"]
    nt_ = 256 if W >= k["NWIDE"] else 128  # a block's threads: two warpgroups from NWIDE (``nthreads``)
    HD = HH = H * W

    def r4(x: int) -> int:
        return -(-x // 4) * 4

    def run(items: int, most: int) -> Tuple[int, int]:
        most = max(1, min(most, items))
        ipb = -(-items // most)
        return -(-items // ipb), ipb

    if per_sm is None:
        per_sm = min(2048 // nt_, k["SM_BYTES"] // (lay["smem"] + 1024))
    per_sm_t = min(2048 // nt_, k["SM_BYTES"] // (lay["smem_t"] + 1024))
    nt = -(-C // tile)
    cp = nt * tile
    grid, ipb = run(B * Z * nt, per_sm * sms)
    # with weight gradients a tail block takes at least two items (its weights' partials stored once for both)
    grid_t, _ = run(B * nt, min(per_sm_t * sms, -(-B * nt // 2)) if weight_grads else per_sm_t * sms)
    slots = min(B * Z, ipb // nt if ipb % nt == 0 else 1 if nt % ipb == 0 else (ipb + nt - 2) // nt + 1)
    lengths = [W * W, W, W * W, W, W * W, W, W * W * H, W, HD * HD, HD, HD * HD, HD, HD * HD, HD, HD * W, W, W * W, W,
               W * out, out]
    n_w = (20 if tail else 8) if weight_grads else 0
    part_l = slots * (r4(W * H) + r4(H) + W * HH + r4(HH)) + sum(r4(n) for n in lengths[:min(n_w, 6)])
    part_t = sum(r4(n) for n in lengths[6:n_w])
    images = [W * W] * 4 + ([HD * HD] * 3 + [HD * W, W * W] if tail else [])
    lat_rows, b_rows = B * Z * cp, B * cp
    t_ws = (tile * (2 * HD + W) if tail else 0) + (4 * tile * lay["xc"] // 2 if tail and weight_grads else 0) \
        + (3 * tile * lay["pc"] // 2 if weight_grads else 0)
    work = (sum(r4(n // 2) for n in images) + r4(B * Z * W * HH // 2) + 2 * r4(lat_rows * H) + r4(lat_rows * HH // 2)
            + r4(b_rows * HH) + r4(b_rows * H) + grid_t * t_ws)
    return dict(grid=grid, ipb=ipb, slots=slots, grid_t=grid_t,
                scratch=4 * (work + grid * part_l + grid_t * part_t))


def a16_index(r, k):
    """Element (r, k) of a 64-row bf16 operand in the layout the programs' ``wgmma`` read from shared
    memory without swizzle (``a16_index`` of ``fused_decode_fwd_bf16.cu`` and ``fused_decode_bwd_bf16.cu``):
    core matrices of 8 rows x 8 k (128 bytes), the row groups of a k group 128 bytes apart, the k groups
    1,024 bytes apart. Read K-major (a product's A, its k the columns) with LBO 1,024 B and SBO 128 B;
    read MN-major (a row contraction's operand, its k the 64 rows) with LBO 128 B and SBO 1,024 B.
    Works on ints and on integer arrays or tensors."""
    return ((k >> 3) * 8 + (r >> 3)) * 64 + (r & 7) * 8 + (k & 7)


def split3_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 terms of an f32 operand, as ``split3_bf16`` in ``csrc/bf16_mma.cuh`` takes them:
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (each rounded to nearest, ties to even; the
    subtractions exact in f32). (hi + mid) + lo in f32 is x."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def k2_smem_bytes(Z: int, I: int, hid: int, H: int, D: int, hidm: int,
                  compute_dtype: torch.dtype = torch.float32) -> int:
    """K2's dynamic shared memory in bytes for a decode shape, as ``shape`` in
    ``csrc/fused_decode_bwd.cu`` computes it: the B staging (a ring of chunk buffers, each of
    two slabs of the width class ``k2_width_class``, big and small tf32 parts (three bf16 parts in
    the bf16 program): three at the class
    64 where they fit, else two), the wide buffer P, X1, W2 (X2 and X3, or one wide), the
    softmax weights and dp / dlogit of every latent, the tile's invariants. It grows with
    ``Z`` (1,024 B a latent at two heads; the ring drops to two buffers before the shape is
    refused). Raises ``ValueError`` for a shape it refuses:
    widths it does not take, or more than ``SMEM_CAP`` bytes. ``compute_dtype=torch.bfloat16``:
    the bf16 program's (``fused_decode_bwd_bf16.cu``); at hid = hidm = D = 128, two heads (``k2_w128_design``)
    its W128 design's: two warpgroups' rings of ``W128_STAGES`` 4 KB chunks, the union ``W128_U`` of the phases'
    bf16 operand planes (and nbar, dF in f32), the row sums' and column sums' exchanges, psum, <dy, m_b2>
    and the invariants, then every latent's softmax weights and dp (1,024 B a latent); below the width class 64
    (``k2_narrow_design``) the narrow design's per-latent kernels' (``k2_narrow_layout``: Z does not enter)."""
    return _k2_layout(Z, I, hid, H, D, hidm, compute_dtype)["smem"]


def k2_scratch_bytes(B: int, Z: int, C: int, I: int, hid: int, H: int, D: int, hidm: int, out: int,
                     tail: bool, weight_grads: bool, per_sm: Optional[int] = None, sms: int = 132,
                     compute_dtype: torch.dtype = torch.float32) -> int:
    """Bytes of K2's scratch for one launch (its workspace and its partials: the second and
    third of ``fused_decode_bwd_sizes``), as ``shape`` and ``plan`` in its source lay them out
    for a grid of ``per_sm`` blocks on each of ``sms`` SMs (or one block per work item when
    there are fewer): the shared weights pre-split once, then per block its workspace slice,
    its batch-row slots and its weight gradients. ``per_sm`` defaults to the most blocks of that shared memory an SM can
    hold (233,472 B an SM, 1,024 B of it kept back per block; 8 blocks of 256 threads), an
    upper bound of the launch's occupancy: the scratch grows with the grid. A block takes at
    least ``MIN_IPB`` items. The bf16 program (``compute_dtype=torch.bfloat16``) keeps the shared
    weights in bf16 (one part, 2 bytes an element) and ``m_w2``'s gradient a head (each head's
    sum is rounded to bf16 on its own, as JAX casts ``m_w2`` in each head's product); below the width
    class 64 its narrow design's (``k2_narrow_plan``)."""
    bf = _check_dtype(compute_dtype) == torch.bfloat16
    k = k2_constants(compute_dtype)
    lay = _k2_layout(Z, I, hid, H, D, hidm, compute_dtype)
    if lay["narrow"]:
        return k2_narrow_plan(B, Z, C, I, hid, H, D, hidm, out, tail, weight_grads, per_sm, sms)["scratch"]
    tile = k["TILE"]
    w128 = lay["w128"]
    if per_sm is None:
        per_sm = min(2048 // k["THREADS"], 233_472 // (lay["smem"] + 1024))
    HD, HH = H * D, H * hidm
    nt = -(-C // tile)
    items = B * nt
    most = min(per_sm * sms, -(-items // k["MIN_IPB"]))  # a block takes at least MIN_IPB items
    grid0 = min(items, max(1, most))
    ipb = -(-items // grid0)
    grid = -(-items // ipb)
    slots = min(B, (ipb + nt - 2) // nt + 1)
    work = tile * HH * (1 + weight_grads)
    if tail:
        work += tile * (2 * HD + 2 * hid)
        if weight_grads:
            work += tile * 2 * HD
    if w128:  # the tail's q1, gelu'(q2), gelu'(q3), later e and u in their room (else their own); nbar; the
        # tail's four bf16 planes
        work = (tile * (2 * HD + hid) if tail else tile * (HH + hid)) + weight_grads * tile * HH \
            + (tail and weight_grads) * 2 * tile * HD
    l_row = Z * (hid * H + H + hid * HH + HH)
    l_w = 0
    if weight_grads:
        l_w = 3 * (hid * hid + hid) + (H if bf else 1) * hidm * D + D
        if tail:
            l_w += 3 * (HD * HD + HD) + HD * hid + hid + hid * hid + hid + hid * out + out
    # The shared weights laid out once a launch (both orientations; two tf32 parts, or bf16).
    split = 3 * hid * hid + hidm * D + (3 * HD * HD + HD * hid + hid * hid if tail else 0)
    g_blocks = B * Z * hid * HH if w128 else 0  # G in bf16 blocks, both ways (``W128_GBLK`` floats a latent)
    part = slots * l_row + l_w
    if w128:  # each block's partials on 16 bytes
        part = -(-part // 4) * 4
    return 4 * ((1 if bf else 4) * split + g_blocks + grid * (work + part))


def k2_occupancy(dims: Sequence[int], source: str = BWD_KERNEL_SOURCE) -> Dict[str, int]:
    """The built K2 library's layout of a launch with these dims (the launcher's): ``smem``, its
    dynamic shared memory in bytes; ``per_sm``, the blocks an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); ``grid``; ``slots``, the batch-row slots
    a block; ``scratch``, the bytes of its workspace and partials. Raises for a shape it refuses.
    On the card; ``source`` may name another build of the same C interface."""
    fn = cuda_lib.load(source).fused_decode_bwd_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    rc = fn((ctypes.c_int * len(dims))(*dims), len(dims), out)
    if rc != 0:
        raise RuntimeError(f"fused_decode_bwd_occupancy failed for dims {list(dims)} (cudaError {rc})")
    return dict(smem=int(out[0]), per_sm=int(out[1]), grid=int(out[2]), slots=int(out[3]), scratch=4 * int(out[4]))


def _launch_bwd(inv, wb, A, ab, G, c, ws, tws, g, num_heads: int, head_dim: int,
                weight_grads: bool, lib=None, compute_dtype: torch.dtype = torch.float32):
    H, D = num_heads, head_dim
    dev = inv.device
    B, Z, C, I, hid, hidm, out_dim, with_tail = _check_inputs(inv, wb, A, ab, G, c, ws, tws, H, D)
    _check("g", g, (B, C, out_dim), dev)
    # Refuses, before any launch, a shape the kernel does not take.
    k2_smem_bytes(Z, I, hid, H, D, hidm, compute_dtype)
    _check_aligned16({"G": G})  # read a float4 at a time (the B of dpre G^T)
    if compute_dtype == torch.bfloat16 and k2_w128_design(Z, hid, H, D, hidm):
        # The bf16 program's W128 design reads its f32 operands two at a time.
        _check_aligned16({"A": A, "c": c, "g": g, **{n: w for n, w in zip(WEIGHT_NAMES, ws) if w.dim() == 1 or "coeff" in n},
                          **{n: w for n, w in zip(TAIL_WEIGHT_NAMES, tws) if w.dim() == 1}}, 8)
    lib = lib or _bwd_lib(kernel_sources(compute_dtype)[1])
    dims = [B, Z, C, I, hid, H, D, hidm, out_dim, int(with_tail), int(weight_grads)]
    c_dims = (ctypes.c_int * len(dims))(*dims)
    sizes = (ctypes.c_longlong * 3)()
    rc = lib.fused_decode_bwd_sizes(c_dims, len(dims), sizes)
    if rc != 0:
        raise RuntimeError(f"fused_decode_bwd: unsupported shapes {dims} "
                           f"({lib.fused_decode_bwd_error_string(rc).decode()})")
    n_out, n_work, n_part = sizes
    f32 = dict(device=dev, dtype=torch.float32)
    dinv, dwb = torch.empty(B, Z, C, I, **f32), torch.empty(B, Z, C, **f32)
    # The reduced gradients in one buffer; the per-block partials and workspace slices are
    # the kernel's scratch (each block's first contribution stores its partials).
    flat, work, part = torch.empty(n_out, **f32), torch.empty(n_work, **f32), torch.empty(n_part, **f32)
    tail_ptrs = [t.data_ptr() for t in tws] if with_tail else [None] * len(TAIL_WEIGHT_NAMES)
    ptrs = [inv.data_ptr(), wb.data_ptr(), A.data_ptr(), ab.data_ptr(), G.data_ptr(),
            c.data_ptr(), *[w.data_ptr() for w in ws], *tail_ptrs, g.data_ptr(),
            dinv.data_ptr(), dwb.data_ptr(), flat.data_ptr(), work.data_ptr(), part.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_decode_bwd_launch((ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
                                         c_dims, len(dims), ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.fused_decode_bwd_error_string(rc).decode()
        raise RuntimeError(f"fused_decode_bwd launch failed: {msg} (cudaError {rc})")
    fused_decode_bwd.launches += 1
    fused_decode_bwd.launches_by_program[(compute_dtype, B, Z, C, I, bool(weight_grads))] += 1

    # Split the flat buffer: dA, dab, dG, dc, then the trained weights in order.
    shapes = [A.shape, ab.shape, G.shape, c.shape]
    if weight_grads:
        shapes += [w.shape for i, w in enumerate(ws) if i not in COEFF_INDICES]
        shapes += [w.shape for w in tws]
    pieces, off = [], 0
    for s in shapes:
        n = math.prod(s)
        pieces.append(flat[off:off + n].view(s))
        off += n
    dA, dab, dG, dc = pieces[:4]
    rest = iter(pieces[4:])
    dws = tuple(None if (not weight_grads or i in COEFF_INDICES) else next(rest)
                for i in range(len(ws)))
    dtws = tuple(next(rest) if weight_grads else None for _ in tws)
    return dinv, dwb, dA, dab, dG, dc, dws, dtws


def fused_decode_bwd(inv, wb, A, ab, G, c, ws: Sequence[torch.Tensor],
                     tws: Sequence[torch.Tensor], g: torch.Tensor, num_heads: int, head_dim: int,
                     weight_grads: bool = True, compute_dtype: torch.dtype = torch.float32):
    """Kernel K2: the fused backward decode, the VJP of ``fused_decode_fwd`` at ``g``.

    Same inputs as ``fused_decode_fwd`` plus the cotangent ``g`` [b, c, out]; returns
    what ``fused_decode_bwd_plain`` returns. ``weight_grads=False`` computes only the
    gradients of inv, wb, A, ab, G and c (the ode step's need). ``compute_dtype`` picks the
    program (``fused_decode_bwd.cu``, or ``fused_decode_bwd_bf16.cu`` for bf16).

    On CPU tensors this is ``fused_decode_bwd_plain``; on CUDA tensors it launches
    the kernel on the current stream (counted in ``fused_decode_bwd.launches`` and by
    ``(compute_dtype, b, z, c, I, weight_grads)`` in ``launches_by_program``) or raises.
    """
    if inv.device.type == "cpu":
        return fused_decode_bwd_plain(inv, wb, A, ab, G, c, ws, tws, g, num_heads, head_dim,
                                      weight_grads, compute_dtype)
    if inv.device.type != "cuda":
        raise ValueError(f"fused_decode_bwd runs on CPU or CUDA tensors, got {inv.device}")
    return _launch_bwd(inv, wb, A, ab, G, c, ws, tws, g, num_heads, head_dim, weight_grads,
                       compute_dtype=compute_dtype)


fused_decode_bwd.launches = 0
fused_decode_bwd.launches_by_program = collections.Counter()


_LATENT_ONLY = threading.local()


@contextlib.contextmanager
def latent_grads_only():
    """Within it, each ``FusedDecode`` forward records on its node that its graph-building backward
    (``create_graph=True``: the meta-SGD inner steps, whose gradients are taken of the latents alone) asks
    K2 for the latents' gradients only, not the weights'. The record is made at forward time, on the
    calling thread (the autograd engine may run a backward on another). A first-order backward through the
    same node (the outer loss's, through the inner steps' cotangents) still takes every gradient its inputs
    need; the outer loss reaches the weights through ``FusedDecodeVJP``'s plain recomputation."""
    before = getattr(_LATENT_ONLY, "on", False)
    _LATENT_ONLY.on = True
    try:
        yield
    finally:
        _LATENT_ONLY.on = before


class FusedDecode(torch.autograd.Function):
    """K1 forward, K2 backward: the differentiable fused decode.

    ``FusedDecode.apply(num_heads, head_dim, num_tail, compute_dtype, inv, wb, A, ab, G, c, *ws,
    *tws)`` with ``num_tail`` = ``len(tws)`` (0 or 12) and ``compute_dtype`` the programs'
    (``torch.float32`` or ``torch.bfloat16``). The backward computes only what
    ``ctx.needs_input_grad`` asks for: the weight gradients only when some weight
    needs one. A backward that builds a graph for a double backward
    (``create_graph=True``) returns ``FusedDecodeVJP``'s gradients, whose values are
    K2's and whose derivatives are the plain composition's at the same compute dtype;
    under ``latent_grads_only`` at forward time, the latents' alone.
    """

    @staticmethod
    def forward(ctx, num_heads: int, head_dim: int, num_tail: int, compute_dtype: torch.dtype,
                inv, wb, A, ab, G, c, *weights):
        ctx.num_heads, ctx.head_dim, ctx.num_tail = num_heads, head_dim, num_tail
        ctx.latent_only = getattr(_LATENT_ONLY, "on", False)
        ctx.compute_dtype = _check_dtype(compute_dtype)
        ctx.save_for_backward(inv, wb, A, ab, G, c, *weights)
        n_ws = len(weights) - num_tail
        return fused_decode_fwd(inv, wb, A, ab, G, c, weights[:n_ws], weights[n_ws:],
                                num_heads, head_dim, compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[4:]
        if torch.is_grad_enabled():  # create_graph: the gradients must be differentiable
            if ctx.latent_only:  # the weights' gradients are not asked for (``latent_grads_only``)
                needs = needs[:6] + (False,) * (len(needs) - 6)
            got = iter(FusedDecodeVJP.apply(ctx.num_heads, ctx.head_dim, ctx.num_tail, ctx.compute_dtype,
                                            needs, g.contiguous(), *saved))
            return (None, None, None, None, *(next(got) if need else None for need in needs))
        grads = _k2_grads(ctx.num_heads, ctx.head_dim, ctx.num_tail, ctx.compute_dtype, needs,
                          g.contiguous(), saved)
        return (None, None, None, None, *(d if need else None for d, need in zip(grads, needs)))


def _k2_grads(num_heads: int, head_dim: int, num_tail: int, compute_dtype: torch.dtype, needs, g, saved):
    """K2's gradients of every input of ``FusedDecode`` (in its order), with the weights'
    only when ``needs`` asks for one of them."""
    inv, wb, A, ab, G, c, *weights = saved
    n_ws = len(weights) - num_tail
    dinv, dwb, dA, dab, dG, dc, dws, dtws = fused_decode_bwd(
        inv, wb, A, ab, G, c, weights[:n_ws], weights[n_ws:], g, num_heads, head_dim,
        any(needs[6:]), compute_dtype=compute_dtype)
    return (dinv, dwb, dA, dab, dG, dc, *dws, *dtws)


class FusedDecodeVJP(torch.autograd.Function):
    """The VJP of the fused decode as a differentiable function of its inputs and of the
    cotangent (JAX's ``_bwd_op`` with its ``custom_jvp``).

    ``FusedDecodeVJP.apply(num_heads, head_dim, num_tail, compute_dtype, needs, g, inv, wb, A,
    ab, G, c, *weights)`` returns the gradients of the inputs that ``needs`` marks (in order),
    with K2's values. Its backward recomputes ``fused_decode_plain`` at the same
    ``compute_dtype`` from the same inputs (JAX's shields run ``_reference_decode`` with the
    spec's dtype), takes the plain VJP at ``g`` with a graph, and differentiates that against
    the incoming cotangents, so a double backward sees the plain composition's second
    derivatives. Every tensor it reads, ``g`` included, is an input: the outer gradient
    reaches the weights, the latents and, through ``g``, the loss.
    """

    @staticmethod
    def forward(ctx, num_heads: int, head_dim: int, num_tail: int, compute_dtype: torch.dtype, needs, g,
                *saved):
        ctx.num_heads, ctx.head_dim, ctx.num_tail, ctx.needs = num_heads, head_dim, num_tail, needs
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(g, *saved)
        ctx.set_materialize_grads(False)
        grads = _k2_grads(num_heads, head_dim, num_tail, compute_dtype, needs, g, saved)
        return tuple(d for d, need in zip(grads, needs) if need)

    @staticmethod
    def backward(ctx, *cotangents):
        g, *saved = ctx.saved_tensors
        higher = torch.is_grad_enabled()
        n_ws = len(saved) - 6 - ctx.num_tail
        with torch.enable_grad():
            # A tensor with a graph enters through an alias (a view: a node of its own),
            # so that the derivatives are partial ones (one input may be computed from
            # another, as A is from the weights) and a third derivative still reaches it;
            # the others become leaves here.
            xs = [x.view_as(x) if x.requires_grad else x.detach().requires_grad_(need)
                  for x, need in zip((g, *saved), (True, *ctx.needs))]
            g_, inv, wb, A, ab, G, c, *weights = xs
            out = fused_decode_plain(inv, wb, A, ab, G, c, weights[:n_ws], weights[n_ws:],
                                     ctx.num_heads, ctx.head_dim, ctx.compute_dtype)
            targets = [x for x, need in zip(xs[1:], ctx.needs) if need]
            first = torch.autograd.grad(out, targets, g_, create_graph=True)
            pairs = [(f, ct) for f, ct in zip(first, cotangents) if ct is not None and f.requires_grad]
            wrt = [i for i, need in enumerate(ctx.needs_input_grad[5:]) if need]
            got = torch.autograd.grad([f for f, _ in pairs], [xs[i] for i in wrt],
                                      [ct for _, ct in pairs], allow_unused=True,
                                      create_graph=higher) if pairs and wrt else [None] * len(wrt)
        grads = [None] * len(xs)
        for i, d in zip(wrt, got):
            grads[i] = d
        return (None, None, None, None, None, *grads)


def decode_flops_per_point(num_heads: int, head_dim: int, hidden: int, hidden_mixer: int,
                           num_latents: int, inv_dim: int, num_out: int) -> int:
    """Matmul FLOPs per decoded coordinate of the folded decode (2 per multiply-add).

    Counts what the kernel computes, after folding: the two RFF projections, the
    three hidden denses, the logit matmul with A, the G matmul and the per-head
    mixer dense 2 per latent, plus the fused tail. Elementwise work is not counted.
    """
    hd = num_heads * head_dim
    per_z = 2 * (
        2 * inv_dim * (hidden // 2)
        + 3 * hidden * hidden
        + hidden * num_heads
        + hidden * num_heads * hidden_mixer
        + num_heads * hidden_mixer * head_dim
    )
    tail = 2 * (3 * hd * hd + hd * hidden + hidden * hidden + hidden * num_out)
    return num_latents * per_z + tail


def decode_bwd_flops_per_point(num_heads: int, head_dim: int, hidden: int, hidden_mixer: int,
                               num_latents: int, inv_dim: int, num_out: int,
                               weight_grads: bool) -> int:
    """Matmul FLOPs per decoded coordinate of K2 (2 per multiply-add).

    The backward recomputes the forward (``decode_flops_per_point``), then computes
    every activation gradient (one more product of each dense layer's size) and the
    per-latent gradients of A and G (one more for those two); ``weight_grads`` adds
    one more for each shared weight.
    """
    hd = num_heads * head_dim
    fwd = decode_flops_per_point(num_heads, head_dim, hidden, hidden_mixer, num_latents,
                                 inv_dim, num_out)
    latent = 2 * (hidden * num_heads + hidden * num_heads * hidden_mixer)  # A, G per latent
    shared_z = 2 * (2 * inv_dim * (hidden // 2) + 3 * hidden * hidden
                    + num_heads * hidden_mixer * head_dim)
    tail = 2 * (3 * hd * hd + hd * hidden + hidden * hidden + hidden * num_out)
    # Input gradients of the RFF projections are counted; the coefficients get none.
    wgrad = num_latents * (shared_z - 2 * 2 * inv_dim * (hidden // 2)) + tail
    return 2 * fwd + num_latents * latent + (wgrad if weight_grads else 0)
