"""The serving part of the meta-SGD trainer: parameter init, latent fit, latent rollout.

Counterpart of ``enf_pde_tpu/train/meta_sgd.py`` without the optimizers and the
nef / ode / dual training steps (the training slice, ROADMAP.md). The decoder's and
the ODE's parameters live in their modules; the rest of the state is a dict
``{'autodecoder': shared init latents, 'meta_sgd_lrs': inner learning rates}``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from enf_pde_tpu_torch.builders import coordinate_system_for, decoder_backend
from enf_pde_tpu_torch.dynamics.solvers import solve_latent_ode
from enf_pde_tpu_torch.models.latents import init_latents, latents_to_pose
from enf_pde_tpu_torch.ops.layers import reset_parameters
from enf_pde_tpu_torch.train.inner_loop import InnerLoopConfig, init_meta_sgd_lrs, make_inner_loop

__all__ = ["MetaSGDTrainer"]


class MetaSGDTrainer:
    """Owns the decoder and ODE modules and the serving functions of one experiment.

    Args:
        cfg: experiment config.
        decoder / ode_model: from ``build_models``; moved to ``device``.
        coords: the training grid [num_coords, coord_dim].
        seed: seed of the generator that ``init_state`` draws the weights from.
        device: where the modules and the latents live (default the card).
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
        self.eval_backend = decoder_backend(cfg.nef.get("eval_backend", "xla"))

        self.inner_cfg = InnerLoopConfig(
            num_inner_steps=cfg.meta.num_inner_steps,
            max_num_sampled_points=cfg.training.max_num_sampled_points,
            optimize_gaussian_window=cfg.nef.optimize_gaussian_window,
            noise_pos_inner_loop=cfg.meta.noise_pos_inner_loop,
        )
        # The latent fit differentiates the decoder, so it runs the eager backend.
        self.inner_loop = make_inner_loop(self.decoder, self.coords, self.inner_cfg)

    # ------------------------------------------------------------------ state init

    def init_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Draw the decoder's and the ODE's weights from ``seed``; return the latent
        init and the inner learning rates."""
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
        return self._to_device({"autodecoder": latent_init, "meta_sgd_lrs": meta_lrs})

    def load_state(self, params: dict) -> Dict[str, Dict[str, torch.Tensor]]:
        """Load converted JAX parameters (``convert.convert_params``)."""
        self.decoder.load_state_dict(params["nef"])
        self.ode_model.load_state_dict(params["ode"])
        return self._to_device(
            {"autodecoder": params["autodecoder"], "meta_sgd_lrs": params["meta_sgd_lrs"]}
        )

    def _to_device(self, state):
        return {group: {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                        for k, v in leaves.items()}
                for group, leaves in state.items()}

    # ------------------------------------------------------------------ serving

    def _rollout(self, latents, num_frames: int):
        return solve_latent_ode(
            f=lambda z, t: self.ode_model(z),
            latents=latents,
            t0=0,
            tf=(num_frames - 1) * self.cfg.node.dt,
            h=self.cfg.node.dt,
            method=self.cfg.node.method,
        )

    def fit_latents(self, state, frames: torch.Tensor, generator: Optional[torch.Generator] = None,
                    masks: Optional[torch.Tensor] = None, dp: float = 0.0):
        """Inner-fit latents to frames [batch, *spatial, channels]; returns the latent dict."""
        return self.inner_loop(
            state["meta_sgd_lrs"], state["autodecoder"], frames, generator=generator,
            masks=masks, dp=dp,
        )

    @torch.no_grad()
    def rollout_latents(self, latents, num_frames: int):
        """Roll fitted latents forward ``num_frames`` (incl. t0): (p, a, window) trajectories."""
        return self._rollout(latents_to_pose(latents), num_frames)
