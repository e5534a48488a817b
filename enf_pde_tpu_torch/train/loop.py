"""Epoch-level training loops: phase scheduling, validation protocol, checkpoints.

Counterpart of ``enf_pde_tpu/train/loop.py`` (reference ``_base_pde_trainer.py:239-424``):
in-t / out-t rollout MSE over the val *and* train loaders, the sparse-observation
variants at 5/10/50 %, a checkpoint offered after every epoch and resume under
``logging.resume``, the numeric equivariance check once past
``test.test_equiv_at_epoch``, and rollout figures every
``logging.visualize_every_n_epochs``. The equivariance check and the figures fit
their latents with generators of their own, so neither moves the training draws.

Not ported: the JAX loop's retry of a failed validation or epoch on another decode
path (``_eval_guarded``). A kernel failure on the card raises and ends the run, and
so does a figure that cannot be drawn (matplotlib is imported before the first
epoch when figures are on).

Data parallel: under the trainer's data mesh (``MetaSGDTrainer(mesh=...)``) each rank
takes its rows of every batch (``parallel.mesh.shard_batch``, the JAX loop's
``shard_batch`` hook), the validation MSEs are averaged over the ranks, and rank 0
alone logs, saves checkpoints, runs the equivariance check and draws the figures (on
the whole batch, with no collective call). Resume restores on every rank.

``AutodecodingLoop`` runs the autodecoding baseline (``meta.meta_sgd: false``), the
counterpart of ``_run_autodecoding`` and ``_autodecode_validation`` in
``enf_pde_tpu/experiments/fit.py``: no checkpoints and no retry, as there.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional

import torch

from enf_pde_tpu_torch.models.latents import latents_to_pose
from enf_pde_tpu_torch.parallel.mesh import mean_over_ranks, shard_batch
from enf_pde_tpu_torch.train.autodecode import AutodecodingTrainer
from enf_pde_tpu_torch.train.checkpoint import CheckpointManager
from enf_pde_tpu_torch.train.logging import MetricLogger, NullLogger
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.train.steps import phase_window
from enf_pde_tpu_torch.utils import visualization as viz
from enf_pde_tpu_torch.utils.equivariance import equivariance_errors

# Second key of ``MetaSGDTrainer.val_generator(epoch, key)`` for the side fits.
_EQUIVARIANCE_DRAWS, _FIGURE_DRAWS = 1, 2

__all__ = ["AutodecodingLoop", "TrainLoop"]


class TrainLoop:
    """Runs epochs of the trainer's phase steps over ``train_loader``.

    Args:
        trainer: the ``MetaSGDTrainer``.
        train_loader / val_loader: re-iterable collections of batches, each a
            trajectory [batch, frames, *spatial, channels] (numpy or tensor), or a
            tuple whose first item is one.
        logger: where metrics go (default ``<logging.log_dir>/metrics.jsonl``; on a
            data mesh's ranks other than 0, nowhere).
        checkpoints: offered a save after every epoch (by rank 0); ``logging.resume``
            restores the latest one before training (on every rank).
    """

    def __init__(self, trainer: MetaSGDTrainer, train_loader: Iterable, val_loader: Iterable,
                 logger: Optional[MetricLogger] = None,
                 checkpoints: Optional[CheckpointManager] = None):
        self.trainer = trainer
        self.cfg = trainer.cfg
        self.mesh = trainer.mesh
        self.is_main = self.mesh is None or self.mesh.is_main
        self.train_loader = train_loader
        self.val_loader = val_loader
        log_dir = self.cfg.get_path("logging.log_dir", "outputs/run")
        self.logger = logger or (MetricLogger(log_dir) if self.is_main else NullLogger(log_dir))
        self.checkpoints = checkpoints
        self.global_step = 0
        self._equivariance_checked = False

    def _batch_traj(self, batch, shard: bool = True) -> torch.Tensor:
        """The batch's trajectories on the trainer's device: this rank's rows under a
        data mesh, unless ``shard`` is off."""
        traj = batch[0] if isinstance(batch, (tuple, list)) else batch
        if shard and self.mesh is not None:
            traj = shard_batch(traj, self.mesh)
        return torch.as_tensor(traj, dtype=torch.float32, device=self.trainer.device)

    def train_epoch(self, state, epoch: int):
        step_fn, train_nef, train_ode = self.trainer.select_train_step(epoch)
        # Losses accumulate on the device: one host read per epoch.
        loss_ep, n = None, 0
        epoch_t0 = time.perf_counter()
        sample_loss = None
        for batch in self.train_loader:
            loss, state = step_fn(state, self._batch_traj(batch))
            loss_ep = loss if loss_ep is None else loss_ep + loss
            if self.global_step % self.cfg.logging.log_every_n_steps == 0:
                sample_loss, sample_step = loss, self.global_step
            n += 1
            self.global_step += 1
        mean_loss = float(loss_ep) / max(n, 1) if loss_ep is not None else 0.0
        epoch_s = time.perf_counter() - epoch_t0
        if sample_loss is not None:
            metrics = {"mse_step": float(sample_loss)}
            if n and epoch_s:
                metrics["step_time_s"] = round(epoch_s / n, 4)
                metrics["steps_per_sec"] = round(n / epoch_s, 3)
            self.logger.log(metrics, step=sample_step)
        self.logger.log(
            {
                "epoch": epoch,
                "train_mse_epoch": mean_loss,
                "phase": ("nef+ode" if train_nef and train_ode else "nef" if train_nef else "ode"),
            },
            step=self.global_step,
            echo=True,
        )
        return state

    def _eval_loader(self, state, loader, step_fn, seed_offset: int):
        # Device-side accumulation: one host read per loader pass. The batch index plus
        # the epoch offset seeds each batch's draws, as in the JAX loop: validation
        # never draws from the training generator. Under a data mesh each rank sums its
        # shards' MSEs and the sums are averaged over the ranks.
        mse_in, mse_out, n = None, None, 0
        for batch in loader:
            a, b = step_fn(state, self._batch_traj(batch), batch_idx=seed_offset + n)
            mse_in = a if mse_in is None else mse_in + a
            mse_out = b if mse_out is None else mse_out + b
            n += 1
        if n == 0:
            return 0.0, 0.0
        if self.mesh is not None:
            mse_in, mse_out = mean_over_ranks([mse_in, mse_out], self.mesh)
        return float(mse_in) / n, float(mse_out) / n

    def validate_epoch(self, state, epoch: int):
        off = epoch << 20
        v_in, v_out = self._eval_loader(state, self.val_loader, self.trainer.val_step, off)
        t_in, t_out = self._eval_loader(state, self.train_loader, self.trainer.val_step, off)
        self.logger.log(
            {
                "epoch": epoch,
                "val_mse_in_t": v_in,
                "val_mse_out_t": v_out,
                "train_mse_in_t": t_in,
                "train_mse_out_t": t_out,
            },
            step=self.global_step,
            echo=True,
        )
        if not self._equivariance_checked and epoch > self.cfg.get_path(
            "test.test_equiv_at_epoch", 10**9
        ):
            if self.is_main:
                self._log_equivariance(state, epoch)
            self._equivariance_checked = True

    def _log_equivariance(self, state, epoch: int):
        """Numeric analogue of the reference's visual equivariance check: fit frame 0
        of the first val batch, then decode (eager decoder) 512 grid points under
        joint translations of coordinates and poses, and rotations where the poses
        carry an orientation (SE(2)). Logs nothing for the non-equivariant ``abs_pos``
        ablation."""
        trainer = self.trainer
        frames = self._batch_traj(next(iter(self.val_loader)), shard=False)[:, 0]
        fitted = trainer.fit_latents(state, frames,
                                     generator=trainer.val_generator(epoch, _EQUIVARIANCE_DRAWS))
        p, a, w = latents_to_pose(fitted)
        n = min(512, trainer.coords.shape[0])
        coords = trainer.coords[None, :n].expand(p.shape[0], n, trainer.coords.shape[-1])
        errs = equivariance_errors(trainer.decoder, coords, p, a, w,
                                   invariant=trainer.decoder.cross_attn_invariant,
                                   coordinate_system=trainer.coordinate_system)
        if not errs:
            return
        self.logger.log({"epoch": epoch, **{f"equivariance_err_{k}": v for k, v in errs.items()}},
                        step=self.global_step, echo=True)

    def visualize_epoch(self, state, epoch: int) -> str:
        """Rollout figure: fit frame 0 of the first val trajectory, roll out over the
        train + out horizon, decode, and plot ground truth / prediction / error panels
        to ``<log_dir>/figures/rollout_epochXXXXX.png``; returns its path."""
        cfg, trainer = self.cfg, self.trainer
        traj = self._batch_traj(next(iter(self.val_loader)), shard=False)
        t_total = min(cfg.dataset.traj_len_train + cfg.dataset.traj_len_out_horizon, traj.shape[1])
        traj = traj[:1, :t_total]
        fitted = trainer.fit_latents(state, traj[:, 0],
                                     generator=trainer.val_generator(epoch, _FIGURE_DRAWS))
        sol = trainer.rollout_latents(fitted, t_total)
        pred = trainer.decode(sol).reshape(traj.shape).cpu().numpy()
        gt = traj.cpu().numpy()
        out_path = os.path.join(self.logger.log_dir, "figures", f"rollout_epoch{epoch:05d}.png")
        cs = trainer.coordinate_system
        if cs == "cartesian":
            viz.plot_planar_rollout(gt[0], pred[0], out_path, p_traj=sol[0][0].cpu().numpy())
        elif cs == "polar":
            viz.plot_sphere_rollout(gt[0], pred[0], out_path)
        else:
            viz.plot_ball_rollout(gt[0], pred[0], out_path)
        self.logger.log_image("rollout_figure", out_path, step=self.global_step)
        return out_path

    def validate_epoch_dp(self, state, epoch: int):
        metrics = {"epoch": epoch}
        off = epoch << 20
        for dp, fn in self.trainer.val_step_dp.items():
            tag = f"dp{int(dp * 100)}"
            v_in, v_out = self._eval_loader(state, self.val_loader, fn, off)
            t_in, t_out = self._eval_loader(state, self.train_loader, fn, off)
            metrics.update(
                {
                    f"val_mse_in_t_{tag}": v_in,
                    f"val_mse_out_t_{tag}": v_out,
                    f"train_mse_in_t_{tag}": t_in,
                    f"train_mse_out_t_{tag}": t_out,
                }
            )
        self.logger.log(metrics, step=self.global_step, echo=True)

    def _check_resumed_config(self, epoch: int) -> dict:
        """The keys where the config saved with ``epoch`` differs from the live one,
        as ``{key: (saved, live)}`` (printed). ``logging.*`` may differ between runs and
        is ignored: the model is already built, so a difference is reported, not
        applied."""
        saved = self.checkpoints.restore_config(epoch)
        # JSON round trip: tuples and lists compare as the restored JSON does.
        live = json.loads(json.dumps(self.cfg.to_dict()))

        def flat(d, prefix=""):
            for k, v in sorted(d.items()):
                key = f"{prefix}{k}"
                if isinstance(v, dict):
                    yield from flat(v, key + ".")
                else:
                    yield key, v

        saved_flat = dict(flat(saved))
        diffs = {k: (saved_flat.get(k), v) for k, v in flat(live)
                 if not k.startswith("logging.") and saved_flat.get(k) != v}
        if diffs:
            print(f"[loop] WARNING: resumed config differs from checkpoint: {diffs}")
        return diffs

    def run(self, num_epochs: int, state=None):
        """Train epochs 1..num_epochs (validating at the test intervals), or from the
        epoch after the latest checkpoint under ``logging.resume``; returns the state."""
        if state is None:
            state = self.trainer.init_state()
        start_epoch = 1
        if self.checkpoints is not None and self.cfg.get_path("logging.resume", False):
            latest = self.checkpoints.latest_epoch()
            if latest is not None:
                state, self.global_step = self.checkpoints.restore(self.trainer, latest)
                start_epoch = latest + 1
                diffs = self._check_resumed_config(latest)
                self.logger.log({"resumed_from_epoch": latest,
                                 "resumed_config_differs": sorted(diffs)}, step=self.global_step)
                print(f"[loop] resumed from epoch {latest}")
        viz_every = self.cfg.get_path("logging.visualize_every_n_epochs", 0)
        if viz_every:
            import matplotlib  # noqa: F401  (figures need it: fail before training, not at the first)
        t_start = time.time()
        self.logger.log(
            {
                "train_backend": self.trainer.train_backend,
                "eval_backend": self.trainer.eval_backend,
                "ode_backend": self.trainer.ode_backend,
            },
            step=self.global_step,
            echo=True,
        )
        for epoch in range(start_epoch, num_epochs + 1):
            if not self.trainer.phase_active(epoch):
                # Schedule exhausted: the reference raises here mid-run; stop cleanly
                # after the last covered epoch, validating it if that was not done.
                print(f"[loop] no training phase covers epoch {epoch} "
                      f"(num_epochs={num_epochs}); schedule exhausted — stopping.")
                self.logger.log({"schedule_exhausted_at_epoch": epoch}, step=self.global_step)
                if epoch > start_epoch and (epoch - 1) % self.cfg.test.test_interval:
                    self.validate_epoch(state, epoch - 1)
                break
            state = self.train_epoch(state, epoch)
            if self.checkpoints is not None and self.is_main:
                self.checkpoints.save(epoch, self.trainer, state, self.cfg.to_dict(),
                                      self.global_step)
            if epoch % self.cfg.test.test_interval == 0:
                self.validate_epoch(state, epoch)
            if epoch % self.cfg.test.test_dp_interval == 0:
                self.validate_epoch_dp(state, epoch)
            if viz_every and epoch % viz_every == 0 and self.is_main:
                self.visualize_epoch(state, epoch)
        self.logger.log({"train_wall_s": time.time() - t_start}, step=self.global_step)
        return state


class AutodecodingLoop:
    """Runs the autodecoding baseline's epochs (reference ``nonmaml_pde_trainer.py``).

    Each epoch runs one phase over the training batches: a nef step inside the nef
    window, else an ode step inside the ode window, else nothing. It logs the epoch's
    mean ``train_mse_epoch`` and one sampled ``mse_step``, and validates (``validate``)
    every ``test.test_interval`` epochs and once more at the end when the last epoch was
    not such an interval.

    Args:
        trainer: the ``AutodecodingTrainer``.
        train_loader / val_loader: loaders yielding ``(trajectory, _, signal indices)``
            with ``indices`` (the signals they hold).
        logger: where metrics go (default ``<logging.log_dir>/metrics.jsonl``).
    """

    def __init__(self, trainer: AutodecodingTrainer, train_loader, val_loader,
                 logger: Optional[MetricLogger] = None):
        self.trainer = trainer
        self.cfg = trainer.cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger or MetricLogger(self.cfg.get_path("logging.log_dir", "outputs/run"))

    def _traj(self, traj) -> torch.Tensor:
        return torch.as_tensor(traj, dtype=torch.float32, device=self.trainer.device)

    def run(self, num_epochs: int, state=None):
        """Train epochs 1..num_epochs; returns the state."""
        cfg, trainer = self.cfg, self.trainer
        self.logger.log({"train_backend": trainer.train_backend, "eval_backend": trainer.eval_backend},
                        echo=True)
        if state is None:
            state = trainer.init_state()
        global_step = 0
        for epoch in range(1, num_epochs + 1):
            train_nef, train_ode = phase_window(cfg.training, epoch)
            # Losses accumulate on the device: one host read per epoch.
            loss_ep, n, sample_loss, sample_step = None, 0, None, None
            for traj, _, idx in self.train_loader:
                if train_nef:
                    loss, state = trainer.nef_train_step(state, self._traj(traj), idx)
                elif train_ode:
                    loss, state = trainer.ode_train_step(state, self._traj(traj), idx)
                else:
                    continue
                loss_ep = loss if loss_ep is None else loss_ep + loss
                n += 1
                if global_step % cfg.logging.log_every_n_steps == 0:
                    sample_loss, sample_step = loss, global_step
                global_step += 1
            if sample_loss is not None:
                self.logger.log({"mse_step": float(sample_loss)}, step=sample_step)
            self.logger.log({"epoch": epoch, "train_mse_epoch": float(loss_ep) / n if n else 0.0}, echo=True)
            if epoch % cfg.test.test_interval == 0:
                self.validate(state, epoch, num_epochs)
        if num_epochs % cfg.test.test_interval != 0:
            self.validate(state, "final", num_epochs)
        return state

    def _rollout_mse(self, state, loader):
        mse_in = mse_out = None
        n = 0
        for traj, _, idx in loader:
            a, b = self.trainer.val_step(state, self._traj(traj), idx)
            mse_in = a if mse_in is None else mse_in + a
            mse_out = b if mse_out is None else mse_out + b
            n += 1
        return (float(mse_in) / n, float(mse_out) / n) if n else (0.0, 0.0)

    def validate(self, state, epoch, num_epochs: int) -> None:
        """Rollout MSE from the stored latents on the train split (``train_mse_{in,out}_t_sc``),
        then, for each coordinate share 0, 0.05, 0.1 and 0.5, a fresh table re-fitted for
        min(``training.nef.train_until_epoch``, ``test.refit_epochs``) epochs on the val split
        (``val_mse_*``) and, at the final validation unless ``test.refit_train_split`` says
        otherwise, on the train split (``train_mse_*``); the dp variants carry ``_dp<share>``.
        Reference ``nonmaml_pde_trainer.py:399-548``."""
        cfg, trainer = self.cfg, self.trainer
        metrics = {"epoch": epoch} if isinstance(epoch, int) else {}
        metrics["train_mse_in_t_sc"], metrics["train_mse_out_t_sc"] = self._rollout_mse(state, self.train_loader)
        refit_epochs = min(cfg.training.nef.train_until_epoch, cfg.get_path("test.refit_epochs", 100))
        is_final = not isinstance(epoch, int) or epoch == num_epochs
        refit_train = cfg.get_path("test.refit_train_split", is_final)
        for dp in (0.0, 0.05, 0.1, 0.5):
            tag = "" if dp == 0 else f"_dp{dp}"
            for split, loader, on in (("val", self.val_loader, True), ("train", self.train_loader, refit_train)):
                if on:
                    refit = trainer.refit_latents(state, loader, num_epochs=refit_epochs, dp=dp)
                    metrics[f"{split}_mse_in_t{tag}"], metrics[f"{split}_mse_out_t{tag}"] = \
                        self._rollout_mse(refit, loader)
        self.logger.log(metrics, echo=True)
