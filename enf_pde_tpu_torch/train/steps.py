"""Pieces shared by the meta-SGD and the autodecoding trainers: gradient leaves and
per-group gradients, a module's optimizer group, the latent rollout, the rollout loss,
the epoch's phase window and a frozen decoder."""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from enf_pde_tpu_torch.dynamics.solvers import solve_latent_ode

__all__ = ["frozen", "grad_leaves", "group_grads", "latent_rollout", "module_group",
           "phase_window", "rollout_loss"]


def grad_leaves(group: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fresh leaves of a state group to differentiate with respect to."""
    return {k: v.detach().requires_grad_(True) for k, v in group.items()}


def module_group(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A module's optimizer group: its parameters and its buffers (the RFF coefficients,
    JAX's stop-gradient params, which AdamW decays)."""
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def group_grads(loss: torch.Tensor, **groups) -> Dict[str, Dict[str, torch.Tensor]]:
    """Gradients of ``loss`` for every tensor of the groups that requires grad; zeros for
    the rest (buffers) and for the unused ones."""
    flat = [(g, k, v) for g, leaves in groups.items() for k, v in leaves.items() if v.requires_grad]
    got = torch.autograd.grad(loss, [v for _, _, v in flat], allow_unused=True)
    out = {g: {k: torch.zeros_like(v) for k, v in leaves.items()} for g, leaves in groups.items()}
    for (g, k, _), d in zip(flat, got):
        if d is not None:
            out[g][k] = d
    return out


def latent_rollout(ode_model: torch.nn.Module, cfg, latents, num_frames: int):
    """Roll latents (p, a, window) forward ``num_frames`` frames (the first included) with
    the latent ODE under ``node.method``, ``node.dt`` a frame; each [batch, T, ...].

    JAX's defaults: each step rematerialized in the backward pass, where one is recorded
    (the ODE's parameters or the latents require grad), and ``node.ode_unroll`` read."""
    records = (any(p.requires_grad for p in ode_model.parameters())
               or any(x.requires_grad for x in latents))
    return solve_latent_ode(
        f=lambda z, t: ode_model(z),
        latents=latents,
        t0=0,
        tf=(num_frames - 1) * cfg.node.dt,
        h=cfg.node.dt,
        method=cfg.node.method,
        remat=records,
        unroll=int(cfg.node.get("ode_unroll", 1)),
    )


def rollout_loss(decoder: torch.nn.Module, backend: str, coords: torch.Tensor, sol,
                 trajectory: torch.Tensor, num_points: int, generator: torch.Generator,
                 ode_masks=None) -> torch.Tensor:
    """MSE of the latent rollout ``sol`` (each [b, T, ...]) decoded on ``backend`` against
    ``trajectory`` [b, T, *grid, C] on ``coords``: at one subset of ``num_points``
    coordinates per frame, ``ode_masks`` [T, num_points] shared across the batch (drawn from
    ``generator`` when not given), or at every coordinate when there are no more."""
    b, T = trajectory.shape[:2]
    p_fl, a_fl, w_fl = (x.reshape(b * T, *x.shape[2:]) for x in sol)
    num_coords, M, channels = coords.shape[0], num_points, trajectory.shape[-1]
    traj_fl = trajectory.reshape(b, T, -1, channels)  # [b, T, N, C]
    if M < num_coords:
        if ode_masks is None:
            ode_masks = torch.stack([torch.randperm(num_coords, generator=generator)[:M] for _ in range(T)])
        ode_masks = torch.as_tensor(ode_masks, dtype=torch.long).to(coords.device)
        xs = coords[ode_masks]  # [T, M, d]
        xs = xs[None].expand(b, T, M, xs.shape[-1]).reshape(b * T, M, -1)
        ys = traj_fl[:, torch.arange(T, device=coords.device)[:, None], ode_masks]
        ys = ys.reshape(b * T, M, channels)
    else:
        xs = coords[None, None].expand(b, T, num_coords, -1).reshape(b * T, num_coords, -1)
        ys = traj_fl.reshape(b * T, num_coords, channels)
    recon = decoder(xs, p_fl, a_fl, w_fl, backend=backend)
    return torch.mean((recon - ys) ** 2)


def phase_window(training_cfg, epoch: int) -> Tuple[bool, bool]:
    """(train_nef, train_ode) flags for this epoch (ref ``_base_pde_trainer.py:279-288``)."""
    t = training_cfg
    return (t.nef.train_from_epoch < epoch <= t.nef.train_until_epoch,
            t.ode.train_from_epoch < epoch <= t.ode.train_until_epoch)


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """Run with ``module``'s parameters out of autograd (restored after)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)
