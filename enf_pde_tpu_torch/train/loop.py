"""Epoch-level training loop: phase scheduling and the validation protocol.

Counterpart of ``enf_pde_tpu/train/loop.py`` (reference ``_base_pde_trainer.py:239-424``):
in-t / out-t rollout MSE over the val *and* train loaders, and the sparse-observation
variants at 5/10/50 %. Checkpoints and resume, the equivariance check and the rollout
figures are not ported yet (ROADMAP.md). A kernel failure on the card raises and ends
the run: there is no fallback to another decode path.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import torch

from enf_pde_tpu_torch.train.logging import MetricLogger
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer

__all__ = ["TrainLoop"]


class TrainLoop:
    """Runs epochs of the trainer's phase steps over ``train_loader``.

    Args:
        trainer: the ``MetaSGDTrainer``.
        train_loader / val_loader: re-iterable collections of batches, each a
            trajectory [batch, frames, *spatial, channels] (numpy or tensor), or a
            tuple whose first item is one.
        logger: where metrics go (default ``<logging.log_dir>/metrics.jsonl``).
    """

    def __init__(self, trainer: MetaSGDTrainer, train_loader: Iterable, val_loader: Iterable,
                 logger: Optional[MetricLogger] = None):
        self.trainer = trainer
        self.cfg = trainer.cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger or MetricLogger(self.cfg.get_path("logging.log_dir", "outputs/run"))
        self.global_step = 0

    def _batch_traj(self, batch) -> torch.Tensor:
        traj = batch[0] if isinstance(batch, (tuple, list)) else batch
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
        # never draws from the training generator.
        mse_in, mse_out, n = None, None, 0
        for batch in loader:
            a, b = step_fn(state, self._batch_traj(batch), batch_idx=seed_offset + n)
            mse_in = a if mse_in is None else mse_in + a
            mse_out = b if mse_out is None else mse_out + b
            n += 1
        if n == 0:
            return 0.0, 0.0
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

    def run(self, num_epochs: int, state=None):
        """Train epochs 1..num_epochs (validating at the test intervals); returns the state."""
        if state is None:
            state = self.trainer.init_state()
        t_start = time.time()
        self.logger.log(
            {
                "train_backend": "eager",
                "eval_backend": self.trainer.eval_backend,
                "ode_backend": self.trainer.ode_backend,
            },
            step=self.global_step,
            echo=True,
        )
        for epoch in range(1, num_epochs + 1):
            if not self.trainer.phase_active(epoch):
                # Schedule exhausted: the reference raises here mid-run; stop cleanly
                # after the last covered epoch, validating it if that was not done.
                print(f"[loop] no training phase covers epoch {epoch} "
                      f"(num_epochs={num_epochs}); schedule exhausted — stopping.")
                self.logger.log({"schedule_exhausted_at_epoch": epoch}, step=self.global_step)
                if epoch > 1 and (epoch - 1) % self.cfg.test.test_interval:
                    self.validate_epoch(state, epoch - 1)
                break
            state = self.train_epoch(state, epoch)
            if epoch % self.cfg.test.test_interval == 0:
                self.validate_epoch(state, epoch)
            if epoch % self.cfg.test.test_dp_interval == 0:
                self.validate_epoch_dp(state, epoch)
        self.logger.log({"train_wall_s": time.time() - t_start}, step=self.global_step)
        return state
