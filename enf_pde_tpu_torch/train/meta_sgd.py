"""Meta-SGD PDE trainer: state, losses, the nef / ode / dual steps, validation.

Counterpart of ``enf_pde_tpu/train/meta_sgd.py`` (reference ``pde_trainer.py``):

- **nef phase**: outer gradients of the inner-loop query loss update the decoder and
  the learned inner learning rates (second order through the K-step latent fit, on
  ``nef.backend``: the eager decoder, or K1 forward and K2 backward with the plain
  composition's second derivatives, ``ops/fused_decode.py::FusedDecode``).
- **ode phase**: latents are inner-fitted to frame 0 (first order: they are
  constants of the ODE's gradient), rolled out with the latent ODE for
  ``traj_len_train`` frames, decoded at one random coordinate subset per frame on
  ``nef.ode_backend`` (the fused kernels K1 forward, K2 backward), and the rollout
  MSE updates the ODE model.
- **dual phase**: the rollout loss updates decoder + inner learning rates + ODE
  together (second-order inner loop on ``nef.backend``, rollout decode on
  ``nef.ode_backend``).
- **validation**: fit frame 0, roll out over the train and out horizons, decode every
  grid point on ``nef.eval_backend`` (K1), MSE in and out of the train horizon.

Each of ``nef.backend``, ``nef.eval_backend`` and ``nef.ode_backend`` resolves once, at
construction (``builders.resolve_backend``): to the eager decoder where the kernels do
not compute the decoder. The latent fits (training, serving, validation) decode on
``train_backend``. The decoder's and the ODE's parameters live in their modules; the
rest of the state is a dict ``{'autodecoder': shared init latents, 'meta_sgd_lrs':
inner learning rates, 'opt': optimizer states}``. The steps update it (and the modules)
in place and return ``(loss, state)``. The train steps' random draws (frame choice,
inner-loop masks, the rollout loss's coordinate subsets) come from the trainer's
``generator``; validation draws its masks and dp subsets from a generator of its own,
seeded from the trainer's seed and the batch index, as JAX folds ``batch_idx`` into its
key. So validating does not move the training draws, and two evaluations of one state
agree. Any draw may be passed in instead (the parity tests hand in the JAX package's
draws). The rollout rematerializes each step in the backward pass, as JAX's.

Data parallel (``mesh``, ``parallel/mesh.py``): each rank's steps take its rows of the
global batch; every draw is taken at the global shape from the same generator on every
rank (the frame choice, the masks and the rollout subsets are shared across the batch;
the position noise is sliced to the rank's rows), and the loss and every gradient group
are all-reduced to their global means before the optimizers, so the parameters, the
optimizer states and the generator stay equal on every rank and equal to one process
on the whole batch. ``val_step`` then returns the rank's shard's MSEs (the loop
averages them over the ranks). Coordinate-sharded decode (``coord_mesh``): every rank
holds the whole batch and ``decode`` decodes the rank's share of the coordinates, then
gathers them (the super-resolution eval and the forecast on several cards).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from enf_pde_tpu_torch.builders import coordinate_system_for, resolve_backend
from enf_pde_tpu_torch.models.decoder import decode_trajectories
from enf_pde_tpu_torch.models.latents import init_latents, latents_to_pose
from enf_pde_tpu_torch.ops.layers import reset_parameters
from enf_pde_tpu_torch.parallel.mesh import Mesh, mean_over_ranks, replicate, sharded_decode
from enf_pde_tpu_torch.train.inner_loop import (
    InnerLoopConfig,
    init_meta_sgd_lrs,
    make_inner_loop,
    make_train_inner_loop,
)
from enf_pde_tpu_torch.train.state import make_optimizers, restore_opt_states
from enf_pde_tpu_torch.train.steps import (
    frozen,
    grad_leaves,
    group_grads,
    latent_rollout,
    module_group,
    phase_window,
    rollout_loss,
)

__all__ = ["MetaSGDTrainer", "VAL_DP"]

VAL_DP = (0.05, 0.1, 0.5)  # sparse-observation validation fractions


class MetaSGDTrainer:
    """Owns the decoder and ODE modules, the optimizers and the steps of one experiment.

    Args:
        cfg: experiment config.
        decoder / ode_model: from ``build_models``; moved to ``device``.
        coords: the training grid [num_coords, coord_dim].
        seed: seed of the generator that ``init_state`` draws the weights from, of
            ``generator``, which draws the train steps' random subsets, and of the
            validation draws (with the batch index).
        device: where the modules and the latents live (default the card).
        mesh: the data mesh the steps and ``val_step`` run over (their batches are
            the rank's rows); None for one process.
        coord_mesh: the mesh ``decode`` shards the coordinates over (the batch is
            whole on every rank); None decodes every coordinate here.
    """

    def __init__(self, cfg, decoder, ode_model, coords, seed: int = 0, device="cuda",
                 mesh: Optional[Mesh] = None, coord_mesh: Optional[Mesh] = None):
        if mesh is not None and coord_mesh is not None:
            raise ValueError("a trainer shards its batches (mesh) or its coordinates "
                             "(coord_mesh), not both")
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.coord_mesh = coord_mesh
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
        self.ode_backend = resolve_backend(cfg.nef.get("ode_backend", train_backend), decoder,
                                           "nef.ode_backend")
        self.opts = make_optimizers(cfg)
        self.generator = torch.Generator().manual_seed(seed)

        self.inner_cfg = InnerLoopConfig(
            num_inner_steps=cfg.meta.num_inner_steps,
            max_num_sampled_points=cfg.training.max_num_sampled_points,
            optimize_gaussian_window=cfg.nef.optimize_gaussian_window,
            noise_pos_inner_loop=cfg.meta.noise_pos_inner_loop,
        )
        def fit_decode(x, p, a, window):  # reads the decoder and train_backend at each call
            return self.decoder(x, p, a, window, backend=self.train_backend)

        self.inner_loop = make_inner_loop(fit_decode, self.coords, self.inner_cfg)
        self.train_inner_loop = make_train_inner_loop(fit_decode, self.coords, self.inner_cfg)
        self.val_step_dp = {dp: partial(self.val_step, dp=dp) for dp in VAL_DP}

    # ------------------------------------------------------------------ state init

    def init_state(self) -> dict:
        """Draw the decoder's and the ODE's weights from ``seed``; return the latent
        init, the inner learning rates and fresh optimizer states."""
        cfg = self.cfg
        generator = torch.Generator().manual_seed(self.seed)
        reset_parameters(self.decoder, generator)
        reset_parameters(self.ode_model, generator)
        latent_init = init_latents(
            num_signals=1,
            num_latents=cfg.nef.num_latents,
            latent_dim=cfg.nef.latent_dim,
            num_pos_dims=self.num_pos_dims,
            num_ori_dims=self.num_ori_dims,
            coordinate_system=self.coordinate_system,
            gaussian_window_size=cfg.nef.gaussian_window,
        )
        meta_lrs = init_meta_sgd_lrs(
            latent_dim=cfg.nef.latent_dim,
            lr_pos=cfg.meta.inner_learning_rate_p,
            lr_a=cfg.meta.inner_learning_rate_a,
            lr_window=cfg.meta.inner_learning_rate_window,
            with_orientation=self.num_ori_dims > 0,
        )
        return self._new_state(latent_init, meta_lrs)

    def load_state(self, params: dict, opt: Optional[dict] = None) -> dict:
        """Load converted JAX parameters (``convert.convert_params``) with the optimizer states
        ``opt`` (``convert.load_opt_state``'s: checked against each group's tensors, copied to the
        trainer's device and, under a data mesh, replicated from rank 0), or fresh ones."""
        self.decoder.load_state_dict(params["nef"])
        self.ode_model.load_state_dict(params["ode"])
        state = self._new_state(params["autodecoder"], params["meta_sgd_lrs"])
        if opt is not None:
            state["opt"] = restore_opt_states(opt, {"nef": self.nef_group(), "ode": self.ode_group(),
                                                    "autodecoder": state["autodecoder"],
                                                    "meta_sgd": state["meta_sgd_lrs"]}, self.device)
            if self.mesh is not None:
                replicate([t for g in state["opt"].values() for m in ("mu", "nu") for t in g[m].values()], self.mesh)
        return state

    def _new_state(self, latent_init, meta_lrs) -> dict:
        # A copy: the steps update the state in place, never the caller's arrays.
        state = {group: {k: torch.as_tensor(v, dtype=torch.float32).to(self.device, copy=True)
                         for k, v in leaves.items()}
                 for group, leaves in (("autodecoder", latent_init), ("meta_sgd_lrs", meta_lrs))}
        if self.mesh is not None:  # every rank starts from rank 0's state
            replicate([*self.nef_group().values(), *self.ode_group().values(),
                       *(v for g in state.values() for v in g.values())], self.mesh)
        state["opt"] = {
            "nef": self.opts["nef"].init(self.nef_group()),
            "ode": self.opts["ode"].init(self.ode_group()),
            "autodecoder": self.opts["autodecoder"].init(state["autodecoder"]),
            "meta_sgd": self.opts["meta_sgd"].init(state["meta_sgd_lrs"]),
        }
        return state

    def nef_group(self) -> Dict[str, torch.Tensor]:
        """The decoder's optimizer group (``module_group``)."""
        return module_group(self.decoder)

    def ode_group(self) -> Dict[str, torch.Tensor]:
        return module_group(self.ode_model)

    # ------------------------------------------------------------------ losses

    def _rollout(self, latents, num_frames: int):
        return latent_rollout(self.ode_model, self.cfg, latents, num_frames)

    def _nef_loss(self, lrs, init, trajectory: torch.Tensor,
                  frame_idx: Optional[torch.Tensor] = None,
                  masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inner-loop query loss on frame 0 or on ``fit_on_num_steps`` random frames.

        ``frame_idx`` [fit_on_num_steps] picks the frames (drawn when not given).
        """
        cfg = self.cfg
        fos = cfg.training.nef.fit_on_num_steps
        if fos == 1:
            frames = trajectory[:, 0]
        else:
            if frame_idx is None:
                frame_idx = torch.randperm(cfg.dataset.traj_len_train, generator=self.generator)[:fos]
            frames = trajectory[:, torch.as_tensor(frame_idx, dtype=torch.long).to(self.device)]
            frames = frames.reshape(frames.shape[0] * fos, *frames.shape[2:])
        loss, _ = self.train_inner_loop(lrs, init, frames, generator=self.generator, masks=masks,
                                        mesh=self.mesh)
        return loss

    def _ode_loss(self, lrs, init, trajectory: torch.Tensor, second_order: bool,
                  masks: Optional[torch.Tensor] = None,
                  ode_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inner-fit frame 0 -> latent rollout -> decode random subsets -> MSE.

        ``second_order``: differentiate through the inner loop (dual step), else the
        fitted latents are constants (ode step). ``ode_masks`` [T, M] holds one
        coordinate subset per timestep, shared across the batch (drawn when not
        given). The decode runs on ``ode_backend``.
        """
        cfg = self.cfg
        T = cfg.dataset.traj_len_train
        trajectory = trajectory[:, :T]
        if second_order:
            _, fitted = self.train_inner_loop(lrs, init, trajectory[:, 0], generator=self.generator,
                                              masks=masks, query=False, mesh=self.mesh)
        else:
            fitted = self.inner_loop(lrs, init, trajectory[:, 0], generator=self.generator,
                                     masks=masks, mesh=self.mesh)
        return rollout_loss(self.decoder, self.ode_backend, self.coords,
                            self._rollout(latents_to_pose(fitted), T), trajectory,
                            cfg.training.max_num_sampled_points, self.generator, ode_masks)

    # ------------------------------------------------------------------ gradients

    def _global(self, loss: torch.Tensor, grads: dict):
        """The loss and the gradient groups as global means over the data mesh (as they
        are without one)."""
        if self.mesh is None:
            return loss, grads
        keys = [(g, k) for g in sorted(grads) for k in grads[g]]
        means = mean_over_ranks([loss, *(grads[g][k] for g, k in keys)], self.mesh)
        out = {g: {} for g in grads}
        for (g, k), v in zip(keys, means[1:]):
            out[g][k] = v
        return means[0], out

    def nef_grads(self, state, trajectory, frame_idx=None, masks=None):
        """(loss, grads) of the nef phase: grads {'nef', 'meta_sgd_lrs', 'autodecoder'}."""
        lrs, init = grad_leaves(state["meta_sgd_lrs"]), grad_leaves(state["autodecoder"])
        loss = self._nef_loss(lrs, init, trajectory, frame_idx, masks)
        return self._global(loss.detach(), group_grads(loss, nef=self.nef_group(), meta_sgd_lrs=lrs,
                                                       autodecoder=init))

    def ode_grads(self, state, trajectory, masks=None, ode_masks=None):
        """(loss, grads) of the ode phase: grads {'ode'}; the decoder is not differentiated."""
        with frozen(self.decoder):
            loss = self._ode_loss(state["meta_sgd_lrs"], state["autodecoder"], trajectory,
                                  second_order=False, masks=masks, ode_masks=ode_masks)
            return self._global(loss.detach(), group_grads(loss, ode=self.ode_group()))

    def dual_grads(self, state, trajectory, masks=None, ode_masks=None):
        """(loss, grads) of the dual phase: {'nef', 'meta_sgd_lrs', 'autodecoder', 'ode'}."""
        lrs, init = grad_leaves(state["meta_sgd_lrs"]), grad_leaves(state["autodecoder"])
        loss = self._ode_loss(lrs, init, trajectory, second_order=True, masks=masks,
                              ode_masks=ode_masks)
        return self._global(loss.detach(), group_grads(loss, nef=self.nef_group(), meta_sgd_lrs=lrs,
                                                       autodecoder=init, ode=self.ode_group()))

    # ------------------------------------------------------------------ updates

    def _update_nef(self, state, grads) -> None:
        opt = state["opt"]
        opt["nef"] = self.opts["nef"].update(grads["nef"], opt["nef"], self.nef_group())
        lrs = state["meta_sgd_lrs"]
        opt["meta_sgd"] = self.opts["meta_sgd"].update(grads["meta_sgd_lrs"], opt["meta_sgd"], lrs)
        for v in lrs.values():
            v.clamp_(1e-6, 10.0)

    def _update_ode(self, state, grads) -> None:
        state["opt"]["ode"] = self.opts["ode"].update(grads["ode"], state["opt"]["ode"],
                                                      self.ode_group())

    def nef_train_step(self, state, trajectory, frame_idx=None, masks=None):
        """One nef-phase step; returns (loss, state) with the state updated in place."""
        loss, grads = self.nef_grads(state, trajectory, frame_idx, masks)
        self._update_nef(state, grads)
        if self.cfg.optimizer.learning_rate_codes != 0:
            opt = state["opt"]
            opt["autodecoder"] = self.opts["autodecoder"].update(
                grads["autodecoder"], opt["autodecoder"], state["autodecoder"])
        return loss, state

    def ode_train_step(self, state, trajectory, masks=None, ode_masks=None):
        """One ode-phase step (ODE parameters only); returns (loss, state)."""
        loss, grads = self.ode_grads(state, trajectory, masks, ode_masks)
        self._update_ode(state, grads)
        return loss, state

    def dual_train_step(self, state, trajectory, masks=None, ode_masks=None):
        """One dual step (decoder, inner learning rates and ODE); returns (loss, state)."""
        loss, grads = self.dual_grads(state, trajectory, masks, ode_masks)
        self._update_nef(state, grads)
        self._update_ode(state, grads)
        return loss, state

    # ------------------------------------------------------------------ validation

    def val_generator(self, *key: int) -> torch.Generator:
        """The generator of validation batch ``key`` (one index), or of another draw
        beside training (the loop's equivariance check and figures pass ``(epoch,
        purpose)``): a function of the trainer's seed and the key only, never of the
        training draws."""
        seed = np.random.SeedSequence([self.seed, *key]).generate_state(1, np.uint64)[0]
        return torch.Generator().manual_seed(int(seed))

    @torch.no_grad()
    def val_step(self, state, trajectory, dp: float = 0.0, masks=None, keep=None,
                 batch_idx: int = 0):
        """Fit frame 0, roll out over the train + out horizon, decode every grid point.

        Returns (mse_in, mse_out) as device scalars: the MSE over the first
        ``traj_len_train`` frames and over the rest (0 when there is no rest); under a
        data mesh, of the rank's rows.
        ``dp`` > 0 fits on a random dp-fraction of the points (``keep``). The draws
        not passed in come from ``val_generator(batch_idx)``; ``TrainLoop`` passes
        ``(epoch << 20) + batch``, as the JAX loop does.
        """
        cfg = self.cfg
        T_in = cfg.dataset.traj_len_train
        # The out horizon is clamped to the frames the data has (NS asks for 50 of 20).
        T_total = min(T_in + cfg.dataset.traj_len_out_horizon, trajectory.shape[1])
        trajectory = trajectory[:, :T_total]
        fitted = self.fit_latents(state, trajectory[:, 0], generator=self.val_generator(batch_idx),
                                  masks=masks, dp=dp, keep=keep, mesh=self.mesh)
        recon = self.decode(self._rollout(latents_to_pose(fitted), T_total))
        recon = recon.reshape(trajectory.shape)
        mse_in = torch.mean((recon[:, :T_in] - trajectory[:, :T_in]) ** 2)
        if T_total > T_in:
            mse_out = torch.mean((recon[:, T_in:] - trajectory[:, T_in:]) ** 2)
        else:
            mse_out = torch.zeros((), device=self.device)
        return mse_in, mse_out

    # ------------------------------------------------------------------ phases

    def phase_window(self, epoch: int) -> Tuple[bool, bool]:
        """(train_nef, train_ode) flags for this epoch (``phase_window``)."""
        return phase_window(self.cfg.training, epoch)

    def phase_active(self, epoch: int) -> bool:
        """Whether any training phase covers this epoch (``TrainLoop.run`` stops when not)."""
        return any(self.phase_window(epoch))

    def select_train_step(self, epoch: int) -> Tuple[Callable, bool, bool]:
        """Phase scheduling by epoch ranges (reference ``_base_pde_trainer.py:281-299``)."""
        train_nef, train_ode = self.phase_window(epoch)
        if train_nef and train_ode:
            return self.dual_train_step, train_nef, train_ode
        if train_nef:
            return self.nef_train_step, train_nef, train_ode
        if train_ode:
            return self.ode_train_step, train_nef, train_ode
        raise ValueError(f"No training phase active at epoch {epoch}.")

    # ------------------------------------------------------------------ serving

    def fit_latents(self, state, frames: torch.Tensor, generator: Optional[torch.Generator] = None,
                    masks: Optional[torch.Tensor] = None, dp: float = 0.0, keep=None,
                    mesh: Optional[Mesh] = None):
        """Inner-fit latents to frames [batch, *spatial, channels]; returns the latent dict.

        Draws from ``generator``, else from the trainer's own; ``mesh``: the data mesh
        whose rank's rows ``frames`` are (None: the whole batch). The decoder is out of
        autograd meanwhile: the fit takes the latents' gradients alone (the fused decode's
        K2 without weight gradients).
        """
        with frozen(self.decoder):
            return self.inner_loop(
                state["meta_sgd_lrs"], state["autodecoder"], frames,
                generator=generator if generator is not None else self.generator,
                masks=masks, dp=dp, keep=keep, mesh=mesh,
            )

    @torch.no_grad()
    def rollout_latents(self, latents, num_frames: int):
        """Roll fitted latents forward ``num_frames`` (incl. t0): (p, a, window) trajectories."""
        return self._rollout(latents_to_pose(latents), num_frames)

    def decode(self, latent_traj, coords: Optional[torch.Tensor] = None,
               chunk_size: Optional[int] = None) -> torch.Tensor:
        """Decode latent trajectories (p, a, window), each [batch, T, ...], at ``coords``
        (default the training grid) in chunks of ``chunk_size`` points (default
        ``max_num_sampled_points``) on ``eval_backend``; returns [batch, T, points, out]
        (``models.decoder.decode_trajectories``). Under ``coord_mesh`` each rank
        decodes its share of the points, chunked alike, and the shares are gathered."""
        decode = partial(decode_trajectories, self.decoder, self.eval_backend)
        if self.coord_mesh is not None:
            decode = sharded_decode(decode, self.coord_mesh)
        return decode(self.coords if coords is None else coords, latent_traj,
                      chunk_size or self.cfg.training.max_num_sampled_points)
