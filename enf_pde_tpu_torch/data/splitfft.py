"""Split-complex 2D DFT as real matmuls.

Counterpart of ``enf_pde_tpu/data/splitfft.py``, which the JAX package wrote for a TPU
without complex dtypes: a spectral state is a pair of real planes ``(re, im)`` and each
axis of the DFT is a product with the dense ``[N, N]`` cosine and sine matrices. The
port has complex FFTs on the card (``torch.fft``); this path is kept so that
``generate_ns_trajectories(split_fft=True)`` computes what the JAX package's does.

Convention as ``torch.fft``: forward ``F_jk = exp(-2i pi jk / N)`` (no normalization),
inverse ``(1/N) exp(+2i pi jk / N)``. The products need full f32, as JAX's
``precision=HIGHEST``: every transform puts ``ops.fused_decode.strict_fp32`` in force
(no TF32 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from enf_pde_tpu_torch.ops.fused_decode import strict_fp32

__all__ = [
    "dft_matrices",
    "fft2_split",
    "ifft2_split",
    "fft2_real_input",
    "ifft2_real_output",
]


def dft_matrices(n: int, dtype=torch.float32, device="cpu"):
    """``(C, S)`` with ``C_jk = cos(2 pi jk / n)``, ``S_jk = sin(2 pi jk / n)``, computed
    in float64 and then cast. Both are symmetric, so either tensor axis takes the same
    matrix."""
    jk = np.outer(np.arange(n), np.arange(n)).astype(np.float64)
    ang = 2.0 * np.pi * jk / n
    return (torch.as_tensor(np.cos(ang), dtype=dtype, device=device),
            torch.as_tensor(np.sin(ang), dtype=dtype, device=device))


def _apply_last(m, x):
    return torch.matmul(x, m)  # "...j,jk->...k"


def _apply_secondlast(m, x):
    return torch.matmul(m.T, x)  # "jk,...jl->...kl"


def _fft1(a, b, C, S, apply):
    """One forward-DFT axis of ``a + i b``: multiply by ``F = C - i S``."""
    return apply(C, a) + apply(S, b), apply(C, b) - apply(S, a)


def _ifft1(a, b, C, S, apply, n):
    """One inverse-DFT axis: multiply by ``(C + i S) / n``."""
    return (apply(C, a) - apply(S, b)) / n, (apply(C, b) + apply(S, a)) / n


def fft2_split(a, b, C, S):
    """2D forward DFT of ``a + i b`` over the last two axes -> ``(re, im)``."""
    strict_fp32()
    a, b = _fft1(a, b, C, S, _apply_last)
    return _fft1(a, b, C, S, _apply_secondlast)


def ifft2_split(a, b, C, S):
    """2D inverse DFT of ``a + i b`` over the last two axes -> ``(re, im)``."""
    strict_fp32()
    n = C.shape[0]
    a, b = _ifft1(a, b, C, S, _apply_last, n)
    return _ifft1(a, b, C, S, _apply_secondlast, n)


def fft2_real_input(x, C, S):
    """2D forward DFT of a real field -> ``(re, im)``; skips the zero plane on axis -1."""
    strict_fp32()
    re = _apply_last(C, x)
    im = -_apply_last(S, x)
    return _fft1(re, im, C, S, _apply_secondlast)


def ifft2_real_output(a, b, C, S):
    """Real part of the 2D inverse DFT of ``a + i b``; skips the imag plane on axis -2."""
    strict_fp32()
    n = C.shape[0]
    a, b = _ifft1(a, b, C, S, _apply_last, n)
    return (_apply_secondlast(C, a) - _apply_secondlast(S, b)) / n
