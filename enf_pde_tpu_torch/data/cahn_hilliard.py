"""Cahn-Hilliard data: spinodal decomposition on a 64^2 grid, integrated on the card.

Counterpart of ``enf_pde_tpu/data/cahn_hilliard.py`` (reference ``pdes.py:365-399``):
``dt(c) = lap(c^3 - c - gamma lap(c))`` with gamma = 1 on a unit-spacing 64x64 grid with
no-flux boundaries, from a uniform random initial field in [-1, 1], recorded every 20
time units, the first 10 records dropped. The same linearly stabilised semi-implicit
(IMEX) scheme in the cosine basis: the fourth-order term and a stabiliser ``S lap(c)``
implicit (diagonal in the DCT-II basis), the nonlinear term explicit, dt 1e-2, so a
trajectory is 30 x 2,000 solver steps.

``torch.fft`` has no DCT: the orthonormal DCT-II is applied as a 64x64 matrix on both
sides (``dct_matrix``), in f32 (TF32 off, ``strict_fp32``), four matrix products a step.

The initial field comes from a CPU ``torch.Generator`` seeded by the trajectory's seed
(uniform in [-1, 1]), so one seed gives one field on the CPU and on the card. The JAX
package draws it with ``jax.random``, so a seed gives a different trajectory here than
in the JAX package's cache: both are equally valid draws of the same distribution.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from enf_pde_tpu_torch.ops.fused_decode import strict_fp32

__all__ = ["dct_matrix", "initial_fields", "cahn_hilliard_rollout", "generate_ch_trajectories"]

_GAMMA = 1.0
_STAB = 2.0  # linear stabilisation constant (standard for IMEX Cahn-Hilliard)


def dct_matrix(n: int, device="cpu") -> torch.Tensor:
    """The orthonormal DCT-II matrix M [n, n]: ``M @ x`` is ``scipy.fft.dct(x, type=2,
    norm="ortho")`` along the first axis, ``M.T`` its inverse."""
    k = torch.arange(n, dtype=torch.float64)[:, None]
    j = torch.arange(n, dtype=torch.float64)[None, :]
    m = torch.cos(math.pi * (2 * j + 1) * k / (2 * n)) * math.sqrt(2.0 / n)
    m[0] /= math.sqrt(2.0)
    return m.float().to(device)


def initial_fields(seeds: Sequence[int], size: int = 64, device="cuda") -> torch.Tensor:
    """One uniform [-1, 1] field per seed, drawn on the CPU: [len(seeds), size, size]."""
    fields = [torch.rand(size, size, generator=torch.Generator().manual_seed(int(s))) * 2 - 1
              for s in seeds]
    return torch.stack(fields).to(device)


@torch.no_grad()
def cahn_hilliard_rollout(c0: torch.Tensor, dt: float, record_steps: int,
                          steps_per_record: int) -> torch.Tensor:
    """Integrate batched fields c0 [batch, N, N] on their device; each snapshot is taken
    before its stretch of ``steps_per_record`` steps. Returns [batch, record_steps, N, N]."""
    strict_fp32()
    N, dev = c0.shape[-1], c0.device
    M = dct_matrix(N, dev)
    Mt = M.T.contiguous()
    dctn = lambda x: M @ x @ Mt  # noqa: E731  (DCT-II along both axes)
    idctn = lambda x: Mt @ x @ M  # noqa: E731
    # Neumann Laplacian eigenvalues on a unit-spacing grid in the DCT-II basis.
    lam1d = 2.0 * (torch.cos(math.pi * torch.arange(N, device=dev, dtype=torch.float32) / N) - 1.0)
    lam = lam1d[:, None] + lam1d[None, :]
    denom = 1.0 + dt * _GAMMA * lam**2 - dt * _STAB * lam
    dt_lam = dt * lam

    c_hat = dctn(c0)
    snaps = []
    for _ in range(record_steps):
        snaps.append(idctn(c_hat))
        for _ in range(steps_per_record):
            c = idctn(c_hat)
            c_hat = (c_hat + dt_lam * (dctn(c**3 - c) - _STAB * c_hat)) / denom
    return torch.stack(snaps, dim=1)


def generate_ch_trajectories(seeds: Sequence[int], size: int = 64, dt: float = 1e-2,
                             frame_dt: float = 20.0, num_frames: int = 20, skip_frames: int = 10,
                             device="cuda") -> np.ndarray:
    """Trajectories [len(seeds), num_frames, size, size, 1] float32, integrated on
    ``device``; the first ``skip_frames`` records are dropped (reference ``pdes.py:397``)."""
    c0 = initial_fields(seeds, size, device)
    traj = cahn_hilliard_rollout(c0, dt, record_steps=num_frames + skip_frames,
                                 steps_per_record=int(frame_dt / dt))
    return traj[:, skip_frames:].cpu().numpy().astype(np.float32)[..., None]
