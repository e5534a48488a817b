"""Meta-SGD inner loop: K latent SGD steps with learned per-leaf learning rates.

Counterpart of ``enf_pde_tpu/train/inner_loop.py``: shared init latents are tiled
over the batch, each step fits them to a random coordinate subset of the target frame
with gradients scaled by the batch size and the learned learning rates. Two forms:

- serving (``make_inner_loop``): first order, returns the fitted latents only
  (detached);
- training (``make_train_inner_loop``): returns ``(query_loss, fitted)`` with the
  query loss on a held-out (K+1)-th subset, and keeps the graph of every inner
  gradient (``create_graph=True``) so that the outer gradient reaches the decoder,
  the learning rates and the init latents through the loop (second order, MAML).

The coordinate subsets come from a ``torch.Generator``, or are passed in as
``masks`` (the parity tests hand in the ones the JAX package drew). Under a data mesh
(``parallel/mesh.py``) the frames are the rank's rows of the global batch: the masks are
shared across the batch, and the position noise is drawn at the global batch's shape and
sliced to the rank's rows, so every rank draws what one process draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from enf_pde_tpu_torch.models.latents import LatentParams, latents_to_pose, tile_latents
from enf_pde_tpu_torch.ops.fused_decode import latent_grads_only
from enf_pde_tpu_torch.parallel.mesh import Mesh, data_sharding

__all__ = [
    "InnerLoopConfig",
    "make_inner_loop",
    "make_train_inner_loop",
    "init_meta_sgd_lrs",
    "sample_coordinate_masks",
]


class InnerLoopConfig(NamedTuple):
    num_inner_steps: int
    max_num_sampled_points: int
    optimize_gaussian_window: bool
    noise_pos_inner_loop: float


def sample_coordinate_masks(generator: Optional[torch.Generator], num_coords: int,
                            num_masks: int, num_sampled: int) -> torch.Tensor:
    """Independent random coordinate subsets: [num_masks, min(num_sampled, num_coords)]."""
    take = min(num_sampled, num_coords)
    return torch.stack(
        [torch.randperm(num_coords, generator=generator)[:take] for _ in range(num_masks)]
    )


def make_inner_loop(decoder_apply: Callable, coords: torch.Tensor, cfg: InnerLoopConfig):
    """Build the serving inner-loop function (first order).

    Args:
        decoder_apply: ``decoder_apply(x, p, a, window) -> values``, differentiable in
            the latents.
        coords: full coordinate set [num_coords, coord_dim].
        cfg: inner-loop hyperparameters.

    Returns:
        ``inner_loop(meta_lrs, latent_init, frames, generator=None, masks=None, dp=0.0,
        keep=None, mesh=None) -> fitted_latents``. ``latent_init`` is a shared (num_signals=1)
        latent dict, ``frames`` is [batch, *spatial, channels], ``masks``
        [>= K, num_sampled] indexes the coordinates of step k in row k (drawn from
        ``generator`` when not given; the JAX package draws K+1 rows, the last for
        its query loss), and ``dp`` > 0 restricts fitting to a random
        ``dp``-fraction of the coordinates (``keep``, drawn when not given; masks
        then index into it). ``mesh``: the data mesh whose rank's rows ``frames`` are.
    """

    def inner_loop(meta_lrs, latent_init: LatentParams, frames: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   masks: Optional[torch.Tensor] = None,
                   dp: float = 0.0, keep: Optional[torch.Tensor] = None,
                   mesh: Optional[Mesh] = None) -> LatentParams:
        fitted = _fit(decoder_apply, coords, cfg, meta_lrs, latent_init, frames, generator,
                      masks, dp, keep, num_masks=cfg.num_inner_steps, create_graph=False,
                      mesh=mesh)[1]
        return {n: v.detach() for n, v in fitted.items()}

    return inner_loop


def make_train_inner_loop(decoder_apply: Callable, coords: torch.Tensor, cfg: InnerLoopConfig):
    """Build the training inner-loop function.

    Returns:
        ``inner_loop(meta_lrs, latent_init, frames, generator=None, masks=None,
        query=True, mesh=None) -> (query_loss, fitted_latents)``: ``masks`` [K + 1,
        num_sampled] (drawn when not given), ``mesh`` as in ``make_inner_loop``, the query loss is the fitted latents' MSE on row K (None
        with ``query=False``, which skips its decode: the dual step uses the fitted
        latents only). Both are differentiable to second order in the decoder's
        parameters, ``meta_lrs`` and ``latent_init``.
    """

    def inner_loop(meta_lrs, latent_init: LatentParams, frames: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   masks: Optional[torch.Tensor] = None, query: bool = True,
                   mesh: Optional[Mesh] = None):
        recon_loss, fitted, masks = _fit(
            decoder_apply, coords, cfg, meta_lrs, latent_init, frames, generator, masks,
            0.0, None, num_masks=cfg.num_inner_steps + 1, create_graph=True, mesh=mesh)
        return (recon_loss(fitted, masks[cfg.num_inner_steps]) if query else None), fitted

    return inner_loop


def _fit(decoder_apply, coords, cfg: InnerLoopConfig, meta_lrs, latent_init, frames, generator,
         masks, dp, keep, num_masks: int, create_graph: bool, mesh: Optional[Mesh] = None):
    """The K SGD steps; returns (recon_loss, fitted latents, masks)."""
    img = frames.reshape(frames.shape[0], -1, frames.shape[-1])  # [b, N, C]
    batch_size = img.shape[0]
    local_coords = coords

    if dp > 0:
        if keep is None:
            n_keep = int(coords.shape[0] * dp)
            keep = torch.randperm(coords.shape[0], generator=generator)[:n_keep]
        keep = torch.as_tensor(keep, dtype=torch.long).to(coords.device)
        local_coords = coords[keep]
        img = img[:, keep]

    if masks is None:
        masks = sample_coordinate_masks(generator, local_coords.shape[0], num_masks,
                                        cfg.max_num_sampled_points)
    masks = torch.as_tensor(masks, dtype=torch.long).to(coords.device)

    latents = tile_latents(latent_init, batch_size)
    if cfg.noise_pos_inner_loop > 0:
        b, *rest = latents["p_pos"].shape
        world = 1 if mesh is None else mesh.size
        noise = torch.randn((b * world, *rest), generator=generator)
        if mesh is not None:
            noise = noise[data_sharding(mesh, b * world)]
        latents["p_pos"] = latents["p_pos"] + cfg.noise_pos_inner_loop * noise.to(coords.device)

    def recon_loss(latent_params: LatentParams, mask) -> torch.Tensor:
        xs = local_coords[mask].expand(batch_size, -1, -1)  # [b, M, d]
        ys = img[:, mask]  # [b, M, C]
        p, a, window = latents_to_pose(latent_params)
        return torch.mean((decoder_apply(xs, p, a, window) - ys) ** 2)

    names = list(latents)
    for step in range(cfg.num_inner_steps):
        if create_graph:
            # Keep the graph to the init latents; a leaf that has none starts one here.
            leaves = {n: v if v.requires_grad else v.detach().requires_grad_(True)
                      for n, v in latents.items()}
        else:
            leaves = {n: latents[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad(), latent_grads_only():  # the fused decode's K2: the latents' gradients alone
            grads = torch.autograd.grad(recon_loss(leaves, masks[step]), [leaves[n] for n in names],
                                        create_graph=create_graph, allow_unused=True)
        # A latent the decode does not read (the window, with use_gaussian_window off) has a
        # zero gradient, as jax.grad gives. The loss means over the batch; rescale so each
        # signal's latents see their own full gradient.
        grads = {n: torch.zeros_like(leaves[n]) if g is None else g * batch_size
                 for n, g in zip(names, grads)}
        if not cfg.optimize_gaussian_window and "gaussian_window" in grads:
            grads["gaussian_window"] = torch.zeros_like(grads["gaussian_window"])
        base = leaves if create_graph else {n: leaves[n].detach() for n in names}
        latents = {n: base[n] - meta_lrs[n] * grads[n] for n in names}
    return recon_loss, latents, masks


def init_meta_sgd_lrs(latent_dim: int, lr_pos: float, lr_a: float, lr_window: float,
                      with_orientation: bool) -> dict:
    """Learned per-parameter inner learning rates."""
    lrs = {
        "p_pos": torch.ones(1) * lr_pos,
        "a": torch.ones(latent_dim) * lr_a,
        "gaussian_window": torch.ones(1) * lr_window,
    }
    if with_orientation:
        lrs["p_ori"] = torch.ones(1) * lr_pos
    return lrs
