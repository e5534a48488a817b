"""Per-signal autodecoding trainer: the paper's non-meta-learning baseline.

Counterpart of ``enf_pde_tpu/train/autodecode.py`` (reference
``nonmaml_pde_trainer.py``): every training signal owns a row of a latent table.

- **nef phase**: decoder and table rows fit frame 0 jointly (first order: no inner
  loop), at one random subset of ``max_num_sampled_points`` coordinates;
- **ode phase**: the stored latents are rolled out over ``traj_len_train`` frames with
  the latent ODE, decoded at one random subset per frame, and the rollout MSE updates
  the ODE;
- **validation**: a rollout from stored latents over ``test.val_rollout_frames``
  frames (default twice the train horizon), the whole grid decoded on
  ``nef.eval_backend`` (K1), MSE in and out of the train horizon; a split that has no
  stored latents first gets a fresh table fitted with the decoder frozen
  (``refit_latents``), optionally on a kept share of the coordinates.

The training decodes run on ``nef.backend`` (``xla``: the eager decoder; ``pallas``:
K1 forward, K2 backward; ``builders.resolve_backend``). The decoder's and the ODE's parameters live in their
modules; the state is ``{'autodecoder': the table, 'opt': optimizer states}``, and
the steps update it (and the modules) in place and return ``(loss, state)``. Random
draws come from the trainer's ``generator`` (or a generator handed in), and any draw
may be passed in instead: the parity tests hand in the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from enf_pde_tpu_torch.builders import coordinate_system_for, resolve_backend
from enf_pde_tpu_torch.models.decoder import decode_trajectories
from enf_pde_tpu_torch.models.latents import gather_latents, init_latents, latents_to_pose
from enf_pde_tpu_torch.ops.layers import reset_parameters
from enf_pde_tpu_torch.train.state import make_optimizers, restore_opt_states
from enf_pde_tpu_torch.train.steps import (
    frozen,
    grad_leaves,
    group_grads,
    latent_rollout,
    module_group,
    rollout_loss,
)

__all__ = ["AutodecodingTrainer"]


def _long(idx, device) -> torch.Tensor:
    if not torch.is_tensor(idx):
        idx = np.array(idx, dtype=np.int64)  # a copy: the caller's array may be read-only
    return torch.as_tensor(idx, dtype=torch.long).to(device)


class AutodecodingTrainer:
    """Owns the decoder and ODE modules, the optimizers and the steps of an autodecoding run.

    Args:
        cfg: experiment config (``meta.meta_sgd: false``).
        decoder / ode_model: from ``build_models``; moved to ``device``.
        coords: the training grid [num_coords, coord_dim].
        seed: seed of the weights' draw in ``init_state`` and of ``generator``.
        device: where the modules and the table live (default the card).
    """

    def __init__(self, cfg, decoder, ode_model, coords, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.decoder = decoder.to(self.device)
        self.ode_model = ode_model.to(self.device)
        self.coords = torch.as_tensor(coords, dtype=torch.float32, device=self.device)
        self.seed = seed
        self.coordinate_system = coordinate_system_for(cfg.dataset.name)
        inv = decoder.cross_attn_invariant
        self.num_pos_dims = inv.num_z_pos_dims
        self.num_ori_dims = inv.num_z_ori_dims
        train_backend = cfg.nef.get("backend", "xla")
        self.train_backend = resolve_backend(train_backend, decoder)
        self.eval_backend = resolve_backend(cfg.nef.get("eval_backend", train_backend), decoder,
                                            "nef.eval_backend")
        self.opts = make_optimizers(cfg)
        self.generator = torch.Generator().manual_seed(seed)

    # ------------------------------------------------------------------ state

    def make_table(self, num_signals: int) -> Dict[str, torch.Tensor]:
        """A fresh latent table of ``num_signals`` rows on the trainer's device."""
        cfg = self.cfg
        table = init_latents(
            num_signals=num_signals,
            num_latents=cfg.nef.num_latents,
            latent_dim=cfg.nef.latent_dim,
            num_pos_dims=self.num_pos_dims,
            num_ori_dims=self.num_ori_dims,
            coordinate_system=self.coordinate_system,
            gaussian_window_size=cfg.nef.gaussian_window,
        )
        return {k: v.to(self.device) for k, v in table.items()}

    def init_state(self, num_signals: Optional[int] = None) -> dict:
        """Draw the decoder's and the ODE's weights from ``seed``; a table of
        ``num_signals`` (default ``dataset.num_signals_train``) rows; fresh optimizer states."""
        generator = torch.Generator().manual_seed(self.seed)
        reset_parameters(self.decoder, generator)
        reset_parameters(self.ode_model, generator)
        return self._new_state(self.make_table(num_signals or self.cfg.dataset.num_signals_train))

    def load_state(self, params: dict, opt: Optional[dict] = None) -> dict:
        """Load converted JAX parameters (``convert.convert_params`` of an autodecoding
        state) with the optimizer states ``opt`` (``convert.load_opt_state``'s: checked against
        each group's tensors and copied to the trainer's device), or fresh ones."""
        self.decoder.load_state_dict(params["nef"])
        self.ode_model.load_state_dict(params["ode"])
        state = self._new_state({k: torch.as_tensor(v, dtype=torch.float32).to(self.device, copy=True)
                                 for k, v in params["autodecoder"].items()})
        if opt is not None:
            state["opt"] = restore_opt_states(opt, {"nef": module_group(self.decoder), "autodecoder": state["autodecoder"],
                                                    "ode": module_group(self.ode_model)}, self.device)
        return state

    def _new_state(self, table) -> dict:
        return {"autodecoder": table, "opt": {
            "nef": self.opts["nef"].init(module_group(self.decoder)),
            "autodecoder": self.opts["autodecoder"].init(table),
            "ode": self.opts["ode"].init(module_group(self.ode_model)),
        }}

    # ------------------------------------------------------------------ losses

    def _recon_loss(self, table, frames: torch.Tensor, idx, generator: torch.Generator,
                    dp_mask=None, sel=None) -> torch.Tensor:
        """Frame-0 reconstruction from the rows ``idx`` of ``table``: the ``dp_mask``
        coordinates first (all without one), then ``sel``, a subset of
        ``max_num_sampled_points`` of those (drawn when not given, when there are more),
        then the decode and the MSE."""
        img = frames.reshape(frames.shape[0], -1, frames.shape[-1])
        coords = self.coords
        if dp_mask is not None:
            dp_mask = _long(dp_mask, self.device)
            coords, img = coords[dp_mask], img[:, dp_mask]
        M = self.cfg.training.max_num_sampled_points
        if M < coords.shape[0]:
            if sel is None:
                sel = torch.randperm(coords.shape[0], generator=generator)[:M]
            sel = _long(sel, self.device)
            coords, img = coords[sel], img[:, sel]
        coords = coords[None].expand(img.shape[0], *coords.shape)
        p, a, w = latents_to_pose(gather_latents(table, idx))
        out = self.decoder(coords, p, a, w, backend=self.train_backend)
        return torch.mean((out - img) ** 2)

    def _ode_loss(self, table, trajectory: torch.Tensor, idx,
                  ode_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Roll the stored latents out over ``traj_len_train`` frames and decode each frame
        at its subset of ``ode_masks`` [T, M] (drawn when not given), shared across the
        batch; the MSE."""
        T = self.cfg.dataset.traj_len_train
        sol = latent_rollout(self.ode_model, self.cfg, latents_to_pose(gather_latents(table, idx)), T)
        return rollout_loss(self.decoder, self.train_backend, self.coords, sol, trajectory[:, :T],
                            self.cfg.training.max_num_sampled_points, self.generator, ode_masks)

    # ------------------------------------------------------------------ steps

    def nef_grads(self, state, trajectory, idx, update_nef: bool = True, dp_mask=None, sel=None,
                  generator: Optional[torch.Generator] = None):
        """(loss, grads) of the frame-0 reconstruction: {'nef', 'autodecoder'}, or only
        {'autodecoder'} with ``update_nef`` off (the decoder is not differentiated)."""
        table = grad_leaves(state["autodecoder"])
        gen = generator if generator is not None else self.generator
        if update_nef:
            loss = self._recon_loss(table, trajectory[:, 0], idx, gen, dp_mask, sel)
            return loss.detach(), group_grads(loss, nef=module_group(self.decoder), autodecoder=table)
        with frozen(self.decoder):
            loss = self._recon_loss(table, trajectory[:, 0], idx, gen, dp_mask, sel)
            return loss.detach(), group_grads(loss, autodecoder=table)

    def _nef_step(self, state, trajectory, idx, update_nef: bool, dp_mask=None, sel=None,
                  generator=None):
        loss, grads = self.nef_grads(state, trajectory, idx, update_nef, dp_mask, sel, generator)
        opt = state["opt"]
        if update_nef:
            opt["nef"] = self.opts["nef"].update(grads["nef"], opt["nef"], module_group(self.decoder))
        opt["autodecoder"] = self.opts["autodecoder"].update(grads["autodecoder"], opt["autodecoder"],
                                                             state["autodecoder"])
        return loss, state

    def nef_train_step(self, state, trajectory, idx, sel=None):
        """One nef-phase step (decoder and table); returns (loss, state)."""
        return self._nef_step(state, trajectory, idx, True, sel=sel)

    def codes_only_step(self, state, trajectory, idx, dp_mask=None, sel=None, generator=None):
        """One step on the table alone, the decoder left as it is; ``dp_mask`` keeps those
        coordinates, and the draws come from ``generator`` (default the trainer's)."""
        return self._nef_step(state, trajectory, idx, False, dp_mask, sel, generator)

    def ode_grads(self, state, trajectory, idx, ode_masks=None):
        """(loss, grads) of the ode phase: {'ode'}; decoder and table are constants."""
        with frozen(self.decoder):
            loss = self._ode_loss(state["autodecoder"], trajectory, idx, ode_masks)
            return loss.detach(), group_grads(loss, ode=module_group(self.ode_model))

    def ode_train_step(self, state, trajectory, idx, ode_masks=None):
        """One ode-phase step (ODE parameters only); returns (loss, state)."""
        loss, grads = self.ode_grads(state, trajectory, idx, ode_masks)
        state["opt"]["ode"] = self.opts["ode"].update(grads["ode"], state["opt"]["ode"], module_group(self.ode_model))
        return loss, state

    @torch.no_grad()
    def val_step(self, state, trajectory, idx):
        """Rollout MSE from the stored latents of rows ``idx`` over
        ``test.val_rollout_frames`` frames (default twice ``traj_len_train``, at most the
        trajectory's); the whole grid decoded on ``eval_backend``. Returns (mse_in,
        mse_out) as device scalars, over the first ``traj_len_train`` frames and the rest."""
        cfg = self.cfg
        T_in = cfg.dataset.traj_len_train
        T_total = min(cfg.get_path("test.val_rollout_frames", 2 * T_in), trajectory.shape[1])
        trajectory = trajectory[:, :T_total]
        sol = latent_rollout(self.ode_model, cfg, latents_to_pose(gather_latents(state["autodecoder"], idx)),
                             T_total)
        recon = decode_trajectories(self.decoder, self.eval_backend, self.coords, sol,
                                    cfg.training.max_num_sampled_points).reshape(trajectory.shape)
        mse_in = torch.mean((recon[:, :T_in] - trajectory[:, :T_in]) ** 2)
        mse_out = torch.mean((recon[:, T_in:] - trajectory[:, T_in:]) ** 2)
        return mse_in, mse_out

    # ------------------------------------------------------------------ validation protocol

    def refit_latents(self, state, loader, num_epochs: int, dp: float = 0.0, seed: int = 1,
                      dp_mask=None) -> dict:
        """Fit a fresh table to ``loader``'s signals with the decoder frozen.

        A fresh table and Adam state, ``num_epochs`` codes-only epochs over the loader,
        every draw from a generator seeded ``seed``. With ``dp`` > 0 every step sees the
        coordinates of ``dp_mask``: the first ``int(num_coords * dp)`` entries of a
        permutation (drawn when not given), so a ``dp`` share of the points is *kept*, as
        the JAX package and the reference do. Returns the state with the new table; the
        decoder and the ODE are not touched.
        """
        gen = torch.Generator().manual_seed(seed)
        table = self.make_table(len(loader.indices))
        val_state = {"autodecoder": table,
                     "opt": {**state["opt"], "autodecoder": self.opts["autodecoder"].init(table)}}
        if dp > 0 and dp_mask is None:
            n = self.coords.shape[0]
            dp_mask = torch.randperm(n, generator=gen)[: int(n * dp)]
        for _ in range(num_epochs):
            for traj, _, idx in loader:
                traj = torch.as_tensor(traj, dtype=torch.float32, device=self.device)
                self.codes_only_step(val_state, traj, idx, dp_mask=dp_mask, generator=gen)
        return val_state
