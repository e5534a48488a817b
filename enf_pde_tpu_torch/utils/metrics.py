"""Evaluation metrics: MSE, PSNR, IoU.

Counterpart of ``enf_pde_tpu/utils/metrics.py`` (the trainers inline their MSE; these
are for users of the package).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mse", "psnr", "iou"]


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return torch.mean(torch.square(a - b))


def psnr(image: torch.Tensor, ground_truth: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, the peak taken from the ground truth.

    Accepts [batch, *spatial, channels]; reduces over everything but batch.
    """
    maxval = torch.max(ground_truth)
    img, gt = image / maxval, ground_truth / maxval
    err = torch.clamp(torch.mean((img - gt) ** 2, dim=tuple(range(1, img.ndim))), min=0.0)
    return -10.0 * torch.log10(err + eps)


def iou(occ1, occ2) -> np.ndarray:
    """Intersection-over-union of occupancy fields thresholded at 0, per batch entry."""
    occ1, occ2 = (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x) for x in (occ1, occ2))
    occ1 = occ1.reshape(occ1.shape[0], -1) >= 0.0
    occ2 = occ2.reshape(occ2.shape[0], -1) >= 0.0
    union = (occ1 | occ2).sum(axis=-1).astype(np.float64)
    inter = (occ1 & occ2).sum(axis=-1).astype(np.float64)
    return inter / np.maximum(union, 1.0)
