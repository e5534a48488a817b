"""Rollout visualizations: planar image grids, sphere surfaces, ball slices.

Counterpart of ``enf_pde_tpu/utils/visualization.py`` (reference
``_base_pde_trainer.py:432-729``): ground truth vs prediction vs absolute error per
timestep, with latent pose overlays (scatter + orientation quiver) for planar
geometries, written to disk as PNGs. Inputs are numpy arrays. matplotlib is imported
only when a figure is drawn (``_mpl``): the package does not depend on it otherwise.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["plot_planar_rollout", "plot_sphere_rollout", "plot_ball_rollout"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_planar_rollout(
    gt: np.ndarray,
    pred: np.ndarray,
    out_path: str,
    p_traj: Optional[np.ndarray] = None,
    max_frames: int = 10,
) -> str:
    """GT / prediction / |error| rows for one planar trajectory.

    Args:
        gt / pred: [T, H, W, C] (first channel plotted).
        p_traj: optional latent poses [T, z, pose_dim] in [-1, 1]^2 coords, overlaid
            on the error row (orientation quiver when pose_dim > 2).
    """
    plt = _mpl()
    T = min(gt.shape[0], max_frames)
    H, W = gt.shape[1], gt.shape[2]
    rows = 3
    fig, ax = plt.subplots(rows, T, figsize=(2.2 * T, 2.2 * rows), squeeze=False)
    vmin, vmax = float(gt.min()), float(gt.max())
    for t in range(T):
        ax[0, t].imshow(gt[t, :, :, 0], cmap="coolwarm", vmin=vmin, vmax=vmax)
        ax[0, t].set_title(f"T={t} mse={np.mean((gt[t] - pred[t]) ** 2):.2e}", fontsize=7)
        ax[1, t].imshow(pred[t, :, :, 0], cmap="coolwarm", vmin=vmin, vmax=vmax)
        ax[2, t].imshow(np.abs(pred[t, :, :, 0] - gt[t, :, :, 0]), cmap="Reds")
        if p_traj is not None:
            ys = (p_traj[t, :, 0] + 1) * H / 2
            xs = (p_traj[t, :, 1] + 1) * W / 2
            ax[2, t].scatter(xs, ys, c="b", s=8)
            if p_traj.shape[-1] > 2:
                ax[2, t].quiver(
                    xs, ys, np.sin(p_traj[t, :, 2]), np.cos(p_traj[t, :, 2]),
                    angles="uv", scale_units="xy", color="b",
                )
        for r in range(rows):
            ax[r, t].axis("off")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_sphere_rollout(
    gt: np.ndarray, pred: np.ndarray, out_path: str, max_frames: int = 5
) -> str:
    """3D sphere-surface GT vs prediction (fields are [T, nphi, ntheta, C])."""
    plt = _mpl()
    T = min(gt.shape[0], max_frames)
    nphi, ntheta = gt.shape[1], gt.shape[2]
    theta = np.linspace(0, np.pi, ntheta)
    phi = np.linspace(0, 2 * np.pi, nphi)
    P, Th = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(Th) * np.cos(P)
    y = np.sin(Th) * np.sin(P)
    z = np.cos(Th)

    fig = plt.figure(figsize=(2.6 * T, 5.4))
    for t in range(T):
        for row, field in ((0, gt), (1, pred)):
            axp = fig.add_subplot(2, T, 1 + t + row * T, projection="3d")
            f = field[t, :, :, 0]
            fn = (f - f.min()) / (f.max() - f.min() + 1e-12)
            axp.plot_surface(
                x, y, z, facecolors=plt.cm.magma(fn), rstride=2, cstride=2, shade=False
            )
            axp.axis("off")
            if row == 0:
                axp.set_title(f"T={t} mse={np.mean((gt[t] - pred[t]) ** 2):.2e}", fontsize=7)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_ball_rollout(
    gt: np.ndarray, pred: np.ndarray, out_path: str, max_frames: int = 5
) -> str:
    """Equatorial / meridional / radial mid-slices, GT vs prediction.

    Fields are [T, nphi, ntheta, nr, C].
    """
    plt = _mpl()
    T = min(gt.shape[0], max_frames)
    fig, ax = plt.subplots(6, T, figsize=(2.2 * T, 11), squeeze=False)
    slices = (
        ("phi", lambda f: f[f.shape[0] // 2, :, :, 0]),
        ("theta", lambda f: f[:, f.shape[1] // 2, :, 0]),
        ("r", lambda f: f[:, :, f.shape[2] // 2, 0]),
    )
    for t in range(T):
        for i, (name, cut) in enumerate(slices):
            g, pr = cut(gt[t]), cut(pred[t])
            ax[i, t].imshow(g, cmap="coolwarm")
            ax[i, t].set_title(f"{name} T={t} {np.mean((g - pr) ** 2):.1e}", fontsize=6)
            ax[i + 3, t].imshow(pr, cmap="coolwarm")
            ax[i, t].axis("off")
            ax[i + 3, t].axis("off")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
