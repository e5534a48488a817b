"""Experiment entry point: ``python -m enf_pde_tpu_torch.experiments.fit <config> [k=v ...]``.

Counterpart of ``enf_pde_tpu/experiments/fit.py``:

    python -m enf_pde_tpu_torch.experiments.fit navier_stokes
    python -m enf_pde_tpu_torch.experiments.fit navier_stokes seed=1 training.num_epochs=100
    python -m enf_pde_tpu_torch.experiments.fit navier_stokes logging.resume=true --device cpu
    python -m enf_pde_tpu_torch.experiments.fit navier_stokes nef.invariant_type=abs_pos
    python -m enf_pde_tpu_torch.experiments.fit shallow_water      # + super-resolution eval
    python -m enf_pde_tpu_torch.experiments.fit navier_stokes_nonmaml   # autodecoding

Missing trajectories are generated first (on the same device), the input / output
widths and the grid come from a probe batch, the trajectories stay on the device
(``dataset.device_cache``, default on), and checkpoints go under
``<logging.log_dir>/checkpoints`` when ``logging.checkpoint`` is set. Everything runs
on one device, the card unless ``--device cpu``. A run on ``shallow_water_low_res`` ends
with the zero-shot super-resolution evaluation: the trained state validated on the
full-resolution test split (``superres_mse_in_t``, ``superres_mse_out_t``).

``meta.meta_sgd: false`` trains by autodecoding (``train.loop.AutodecodingLoop``): one
phase an epoch, validation by re-fitting fresh latents on both splits; it writes no
checkpoints, as the JAX package's writes none.

Not ported, and refused: the multi-device mesh and wandb (``logging.use_wandb``).
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple, Union

import torch

from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.data import get_dataloader
from enf_pde_tpu_torch.train.autodecode import AutodecodingTrainer
from enf_pde_tpu_torch.train.checkpoint import CheckpointManager
from enf_pde_tpu_torch.train.logging import MetricLogger
from enf_pde_tpu_torch.train.loop import AutodecodingLoop, TrainLoop
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer

__all__ = ["run_experiment", "prepare", "super_resolution_eval", "main"]


def prepare(cfg: Config, device="cuda"):
    """Build loaders, coords and models; fill in the data-derived config fields.

    Returns ``(train_loader, test_loader, coords, decoder, ode_model)``.
    """
    train_loader, test_loader = get_dataloader(cfg.dataset, device=device)
    for ldr in (train_loader, test_loader):
        ldr.ensure_all()
    frame = next(iter(train_loader))[0][0]
    cfg.dataset.image_shape = list(frame.shape)
    coords = train_loader.coords
    cfg.nef.num_in = int(coords.shape[-1])
    cfg.nef.num_out = int(frame.shape[-1])
    decoder, ode_model = build_models(cfg)
    return train_loader, test_loader, coords, decoder, ode_model


def run_experiment(cfg: Config, device="cuda") -> Tuple[Union[TrainLoop, AutodecodingLoop], dict]:
    """Train ``cfg`` for ``training.num_epochs`` on one device; returns ``(loop, state)``:
    a ``TrainLoop``, or an ``AutodecodingLoop`` for ``meta.meta_sgd: false``."""
    if cfg.get_path("logging.use_wandb", False):
        raise NotImplementedError("wandb is not ported: metrics go to <log_dir>/metrics.jsonl.")
    train_loader, test_loader, coords, decoder, ode_model = prepare(cfg, device)
    logger = MetricLogger(cfg.logging.log_dir)
    # The trajectory set is static: keep it on the device so epochs copy nothing.
    if cfg.get_path("dataset.device_cache", True):
        for ldr in (train_loader, test_loader):
            ldr.enable_device_cache()
    try:
        if not cfg.get_path("meta.meta_sgd", True):
            trainer = AutodecodingTrainer(cfg, decoder, ode_model, coords, seed=cfg.seed, device=device)
            loop = AutodecodingLoop(trainer, train_loader, test_loader, logger)
            return loop, loop.run(cfg.training.num_epochs)
        ckpt = (CheckpointManager(cfg.logging.log_dir,
                                  every_n_epochs=cfg.logging.checkpoint_every_n_epochs,
                                  keep_n=cfg.logging.keep_n_checkpoints)
                if cfg.logging.checkpoint else None)
        trainer = MetaSGDTrainer(cfg, decoder, ode_model, coords, seed=cfg.seed, device=device)
        loop = TrainLoop(trainer, train_loader, test_loader, logger, ckpt)
        state = loop.run(cfg.training.num_epochs)
        if cfg.dataset.name == "shallow_water_low_res":
            super_resolution_eval(cfg, state, decoder, ode_model, logger, device)
    finally:
        logger.close()
    return loop, state


def super_resolution_eval(cfg: Config, state: dict, decoder, ode_model, logger: MetricLogger,
                          device="cuda") -> Tuple[float, float]:
    """Zero-shot super-resolution: the state trained at half resolution, validated on the
    full-resolution (``shallow_water``) test split, every test batch with its index as
    ``batch_idx``; logs and returns the mean ``(superres_mse_in_t, superres_mse_out_t)``."""
    hi_cfg = Config(cfg.to_dict())
    hi_cfg.dataset.name = "shallow_water"
    hi_train, hi_test = get_dataloader(hi_cfg.dataset, device=device)
    hi_trainer = MetaSGDTrainer(hi_cfg, decoder, ode_model, hi_train.coords, seed=cfg.seed, device=device)
    mse_in = mse_out = 0.0
    for i, batch in enumerate(hi_test):
        a, b = hi_trainer.val_step(state, torch.as_tensor(batch[0], device=hi_trainer.device), batch_idx=i)
        mse_in += float(a)
        mse_out += float(b)
    n = max(len(hi_test), 1)
    result = {"superres_mse_in_t": mse_in / n, "superres_mse_out_t": mse_out / n}
    logger.log(result, echo=True)
    return result["superres_mse_in_t"], result["superres_mse_out_t"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config", help="experiment name, e.g. navier_stokes")
    parser.add_argument("overrides", nargs="*", help="key.sub=value overrides")
    parser.add_argument("--device", default="cuda", help="where everything runs (cuda | cpu)")
    args = parser.parse_args(argv)
    cfg = load_experiment_config(args.config, args.overrides)
    os.makedirs(cfg.logging.log_dir, exist_ok=True)
    run_experiment(cfg, device=args.device)


if __name__ == "__main__":
    main()
