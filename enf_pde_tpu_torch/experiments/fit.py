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
(``dataset.device_cache``, default on, for a set of at most 2 GiB; otherwise the native
prefetcher reads each batch, and the run record's ``{train,val}_data_path`` says which),
and checkpoints go under ``<logging.log_dir>/checkpoints`` when ``logging.checkpoint``
is set. Everything runs on the card unless ``--device cpu``. A run on
``shallow_water_low_res`` ends with the zero-shot super-resolution evaluation: the
trained state validated on the full-resolution test split (``superres_mse_in_t``,
``superres_mse_out_t``).

Several cards: ``torchrun`` is the switch, as the device count is in JAX.

    torchrun --standalone --nproc_per_node 4 -m enf_pde_tpu_torch.experiments.fit navier_stokes

Under ``torchrun`` (``WORLD_SIZE`` set) each process joins the group (NCCL on
``cuda:$LOCAL_RANK``; gloo with ``--device cpu``) and trains data parallel: its rows of
every batch, the gradients all-reduced, which computes what one process computes on the
whole batch (``train.meta_sgd``). The batch size must divide by the number of
processes. Rank 0 generates missing data while the others wait, and alone logs, saves
checkpoints and draws; each rank keeps its own device cache. The super-resolution eval
shards the coordinates over the ranks. The autodecoding baseline runs on rank 0 alone,
as the JAX package runs it on no mesh.

``meta.meta_sgd: false`` trains by autodecoding (``train.loop.AutodecodingLoop``): one
phase an epoch, validation by re-fitting fresh latents on both splits; it writes no
checkpoints, as the JAX package's writes none.

Not ported, and refused: wandb (``logging.use_wandb``), a service on the network.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.data import get_dataloader
from enf_pde_tpu_torch.parallel.mesh import Mesh, make_mesh, on_rank0
from enf_pde_tpu_torch.train.autodecode import AutodecodingTrainer
from enf_pde_tpu_torch.train.checkpoint import CheckpointManager
from enf_pde_tpu_torch.train.logging import MetricLogger, NullLogger
from enf_pde_tpu_torch.train.loop import AutodecodingLoop, TrainLoop
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer

__all__ = ["run_experiment", "prepare", "super_resolution_eval", "main"]


def prepare(cfg: Config, device="cuda", mesh: Optional[Mesh] = None):
    """Build loaders, coords and models; fill in the data-derived config fields. Missing
    trajectories are generated first, by rank 0 of ``mesh`` while the others wait.

    Returns ``(train_loader, test_loader, coords, decoder, ode_model)``.
    """
    train_loader, test_loader = get_dataloader(cfg.dataset, device=device)
    on_rank0(lambda: [ldr.ensure_all() for ldr in (train_loader, test_loader)], mesh)
    frame = next(iter(train_loader))[0][0]
    cfg.dataset.image_shape = list(frame.shape)
    coords = train_loader.coords
    cfg.nef.num_in = int(coords.shape[-1])
    cfg.nef.num_out = int(frame.shape[-1])
    decoder, ode_model = build_models(cfg)
    return train_loader, test_loader, coords, decoder, ode_model


def _data_path(loader) -> str:
    return "device_cache" if loader.device_cache else "prefetcher"


def run_experiment(cfg: Config, device="cuda") -> Tuple[Union[TrainLoop, AutodecodingLoop], dict]:
    """Train ``cfg`` for ``training.num_epochs``; returns ``(loop, state)``: a
    ``TrainLoop``, or an ``AutodecodingLoop`` for ``meta.meta_sgd: false``.

    Where a process group is initialised (``main`` under ``torchrun``), the meta-SGD
    run is data parallel over it; the autodecoding run goes on rank 0 alone, and the
    other ranks return ``(None, None)``.
    """
    if cfg.get_path("logging.use_wandb", False):
        raise NotImplementedError("wandb is not ported: metrics go to <log_dir>/metrics.jsonl.")
    mesh = make_mesh(device) if dist.is_initialized() else None
    if mesh is not None and not cfg.get_path("meta.meta_sgd", True):
        result = on_rank0(lambda: _run_single(cfg, device), mesh)
        return result if mesh.is_main else (None, None)
    return _run_single(cfg, device, mesh)


def _run_single(cfg: Config, device, mesh: Optional[Mesh] = None):
    train_loader, test_loader, coords, decoder, ode_model = prepare(cfg, device, mesh)
    main_rank = mesh is None or mesh.is_main
    logger = MetricLogger(cfg.logging.log_dir) if main_rank else NullLogger(cfg.logging.log_dir)
    # The trajectory set is static: keep it on the device so epochs copy nothing. Each
    # rank of a mesh keeps the whole set and takes its rows of every batch.
    if cfg.get_path("dataset.device_cache", True):
        for ldr in (train_loader, test_loader):
            ldr.enable_device_cache()
    logger.log({"train_data_path": _data_path(train_loader), "val_data_path": _data_path(test_loader)},
               echo=True)
    try:
        if not cfg.get_path("meta.meta_sgd", True):
            trainer = AutodecodingTrainer(cfg, decoder, ode_model, coords, seed=cfg.seed, device=device)
            loop = AutodecodingLoop(trainer, train_loader, test_loader, logger)
            return loop, loop.run(cfg.training.num_epochs)
        ckpt = (CheckpointManager(cfg.logging.log_dir,
                                  every_n_epochs=cfg.logging.checkpoint_every_n_epochs,
                                  keep_n=cfg.logging.keep_n_checkpoints)
                if cfg.logging.checkpoint else None)
        trainer = MetaSGDTrainer(cfg, decoder, ode_model, coords, seed=cfg.seed, device=device,
                                 mesh=mesh)
        loop = TrainLoop(trainer, train_loader, test_loader, logger, ckpt)
        state = loop.run(cfg.training.num_epochs)
        if cfg.dataset.name == "shallow_water_low_res":
            super_resolution_eval(cfg, state, decoder, ode_model, logger, device, coord_mesh=mesh)
    finally:
        logger.close()
    return loop, state


def super_resolution_eval(cfg: Config, state: dict, decoder, ode_model, logger: MetricLogger,
                          device="cuda", coord_mesh: Optional[Mesh] = None) -> Tuple[float, float]:
    """Zero-shot super-resolution: the state trained at half resolution, validated on the
    full-resolution (``shallow_water``) test split, every test batch with its index as
    ``batch_idx``; logs and returns the mean ``(superres_mse_in_t, superres_mse_out_t)``.
    With ``coord_mesh`` every rank validates every batch and decodes its share of the
    full-resolution grid (``MetaSGDTrainer(coord_mesh=...)``)."""
    hi_cfg = Config(cfg.to_dict())
    hi_cfg.dataset.name = "shallow_water"
    hi_train, hi_test = get_dataloader(hi_cfg.dataset, device=device)
    on_rank0(hi_test.ensure_all, coord_mesh)  # the train split's grid is all it needs
    hi_trainer = MetaSGDTrainer(hi_cfg, decoder, ode_model, hi_train.coords, seed=cfg.seed, device=device,
                                coord_mesh=coord_mesh)
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
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        run_experiment(cfg, device=args.device)  # one process, or a group set up by the caller
        return
    # torchrun: one process per card (or per CPU process under gloo), the group's
    # address, world size and rank from its environment.
    device = args.device
    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.startswith("cuda") else "gloo")
    try:
        run_experiment(cfg, device=device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
