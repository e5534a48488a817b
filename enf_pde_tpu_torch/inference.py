"""Fit-then-forecast inference: the serving path of the port.

Counterpart of ``enf_pde_tpu/inference.py``: fit latents to observed frames with the
meta-SGD inner loop (on ``nef.backend``: the eager decoder, or the fused kernels K1 and
K2), roll them forward with the latent ODE, and decode the forecast at any coordinate
set through the fused decode kernel (``nef.eval_backend``), in coordinate chunks of
``max_num_sampled_points`` that share one weight fold. ``Forecaster.from_checkpoint``
serves a training run of the port from its log directory, ``Forecaster.from_jax_export`` a
trained JAX run exported as numpy files (``tools/export_jax_checkpoint.py``). Where a process group of several ranks is
initialised (``torchrun``), the decode shards the coordinates over the ranks
(``parallel.mesh.sharded_decode``): each rank fits and rolls out the whole batch and
decodes its share of the points.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config
from enf_pde_tpu_torch.convert import load_jax_export
from enf_pde_tpu_torch.ops.fused_decode import strict_fp32
from enf_pde_tpu_torch.parallel.mesh import make_mesh
from enf_pde_tpu_torch.train.checkpoint import CheckpointManager
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer

__all__ = ["Forecaster"]


class Forecaster:
    """Fit-then-forecast on a meta-SGD model.

    Args:
        cfg: experiment config (``config.load_experiment_config``).
        coords: the training grid [num_points, coord_dim].
        params: converted JAX parameters (``convert.convert_params``) or a port run's
            ``{'nef', 'ode', 'autodecoder', 'meta_sgd_lrs'}``; ``None`` draws random
            weights from ``cfg.seed``.
        device: where everything runs; the card unless the caller asks for the CPU.
        backend: as in the JAX package: when given, the fit decodes on ``xla`` (the
            eager decoder) and the forecast on ``backend`` (``nef.backend`` and
            ``nef.eval_backend`` of a copy of ``cfg``); ``None`` keeps ``cfg``'s.
        coord_mesh: the mesh the decode shards the coordinates over; ``"auto"`` takes
            the initialised process group's when it has more than one rank, and
            ``None`` decodes every point in this process.

    Example:
        fc = Forecaster(load_experiment_config("navier_stokes"), planar_coords(64, 64))
        forecast = fc.forecast(frames, num_frames=20)   # [b, 20, 4096, 1]
        fc = Forecaster.from_checkpoint("outputs/navier_stokes", cfg, planar_coords(64, 64))
        fc = Forecaster.from_jax_export("weights/ns8192_s0")   # a trained JAX run
    """

    def __init__(self, cfg: Config, coords: np.ndarray, params: Optional[dict] = None,
                 device="cuda", backend: Optional[str] = None, coord_mesh="auto"):
        strict_fp32()
        if coord_mesh == "auto":
            coord_mesh = make_mesh(device)
            coord_mesh = coord_mesh if coord_mesh.size > 1 else None
        if backend is not None:
            cfg = cfg.copy()
            cfg.nef.backend = "xla"
            cfg.nef.eval_backend = backend
        decoder, ode_model = build_models(cfg)
        seed = cfg.get_path("seed", 0)
        self.trainer = MetaSGDTrainer(cfg, decoder, ode_model, coords, seed=seed, device=device,
                                      coord_mesh=coord_mesh)
        self.cfg = cfg
        self.device = self.trainer.device
        self.state = self.trainer.init_state() if params is None else self.trainer.load_state(params)
        self._generator = torch.Generator().manual_seed(seed)

    @classmethod
    def from_checkpoint(cls, log_dir: str, cfg: Config, coords: np.ndarray,
                        backend: Optional[str] = "pallas", device="cuda") -> "Forecaster":
        """Serve the latest checkpoint that a training run saved under ``log_dir``
        (``train.checkpoint.CheckpointManager``): its decoder, ODE, latent init and inner
        learning rates. ``backend`` as in the constructor (default ``pallas``: the fit on
        the eager decoder, the forecast's decode on K1)."""
        fc = cls(cfg, coords, device=device, backend=backend)
        fc.state, _ = CheckpointManager(log_dir).restore(fc.trainer)
        return fc

    @classmethod
    def from_jax_export(cls, path: str, coords: Optional[np.ndarray] = None, device="cuda",
                        backend: Optional[str] = "pallas", coord_mesh="auto") -> "Forecaster":
        """Serve a trained meta-SGD JAX run exported under ``path`` by
        ``tools/export_jax_checkpoint.py``, with numpy alone (``convert.load_jax_export``): the
        run's config, its decoder, ODE, latent init and inner learning rates
        (``MetaSGDTrainer.load_state``), and the grid ``coords`` (default ``reference.npz``'s
        training grid). ``backend``, ``device`` and ``coord_mesh`` as in the constructor: by
        default the fit on the eager decoder and the forecast's decode on K1 (``pallas``: its
        bf16 program on the card; ``pallas_interpret``: its f32 one; ``xla``: eager). The
        export's ``run``, ``epoch`` and ``metrics`` are ``record``."""
        cfg, params, record = load_jax_export(path)
        if params["meta_sgd_lrs"] is None:
            raise ValueError(f"{path} is an autodecoding run; a Forecaster serves meta-SGD runs")
        if coords is None:
            with np.load(Path(path) / "reference.npz", allow_pickle=False) as ref:
                coords = ref["coords"]
        fc = cls(cfg, coords, params=params, device=device, backend=backend, coord_mesh=coord_mesh)
        fc.record = record
        return fc

    def fit(self, frames, dp: float = 0.0, masks=None):
        """Meta-SGD latent fit to observed frames [batch, *spatial, channels].

        ``dp`` restricts the fit to a random dp-fraction of coordinates; ``masks``
        [>= K, num_sampled] fixes the inner loop's coordinate subsets (row k for step k).
        """
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        return self.trainer.fit_latents(self.state, frames, generator=self._generator,
                                        masks=masks, dp=dp)

    def rollout(self, latents, num_frames: int):
        """Latent-space forecast: (p, a, window) trajectories, each [batch, num_frames, ...]."""
        return self.trainer.rollout_latents(latents, num_frames)

    def decode(self, latent_traj: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
               coords: Optional[np.ndarray] = None, chunk_size: Optional[int] = None) -> torch.Tensor:
        """Decode latent trajectories at arbitrary coordinates.

        Args:
            latent_traj: (p, a, window), each [batch, T, ...] (from ``rollout``).
            coords: [num_points, coord_dim]; defaults to the training grid.
            chunk_size: coordinates per decode call (default ``max_num_sampled_points``).

        Returns:
            [batch, T, num_points, num_out]
        """
        if coords is not None:
            coords = torch.as_tensor(coords, dtype=torch.float32, device=self.device)
        return self.trainer.decode(latent_traj, coords=coords, chunk_size=chunk_size)

    def forecast(self, frames, num_frames: int, coords: Optional[np.ndarray] = None,
                 dp: float = 0.0, masks=None) -> torch.Tensor:
        """Observed frames -> latent fit -> ODE rollout -> decoded forecast.

        Returns [batch, num_frames, num_points, num_out].
        """
        fitted = self.fit(frames, dp=dp, masks=masks)
        traj = self.rollout(fitted, num_frames)
        return self.decode(traj, coords=coords)
