"""Checkpoints of a meta-SGD run: save every N epochs, keep the last K, restore.

Counterpart of ``enf_pde_tpu/train/checkpoint.py`` (orbax) in a torch-native format.
Epoch ``e`` is the directory ``<log_dir>/checkpoints/<e>/`` holding ``state.pt``
(the decoder's and the ODE's ``state_dict`` with their RFF buffers, the trainer state
``autodecoder`` / ``meta_sgd_lrs`` / ``opt``, the training generator's state, the
counterpart of ``TrainState.rng``, and the loop's step count) and ``config.json``. It
is written into a temporary directory and renamed, so a directory named by an epoch
is always whole. Which epochs are saved and kept follows the orbax manager the JAX
package configures: a save is taken when no checkpoint exists yet or the epoch is a
multiple of ``every_n_epochs`` (and later than the latest), and only the newest
``keep_n`` stay. Saves are synchronous.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

import torch

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(self, log_dir: str, every_n_epochs: int = 50, keep_n: int = 1):
        self.directory = os.path.abspath(os.path.join(log_dir, "checkpoints"))
        os.makedirs(self.directory, exist_ok=True)
        self.every_n_epochs = every_n_epochs
        self.keep_n = keep_n

    def all_epochs(self) -> list:
        """The saved epochs, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, trainer, state: dict, config_dict: dict, global_step: int = 0) -> bool:
        """Save epoch ``epoch`` if the policy takes it; returns whether it did."""
        latest = self.latest_epoch()
        if latest is not None and (epoch <= latest or epoch % self.every_n_epochs):
            return False
        final = os.path.join(self.directory, str(epoch))
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({
            "nef": trainer.decoder.state_dict(),
            "ode": trainer.ode_model.state_dict(),
            "autodecoder": state["autodecoder"],
            "meta_sgd_lrs": state["meta_sgd_lrs"],
            "opt": state["opt"],
            "generator": trainer.generator.get_state(),
            "global_step": global_step,
        }, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(config_dict, f)
        os.rename(tmp, final)
        for old in self.all_epochs()[: -self.keep_n]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def _epoch_dir(self, epoch: Optional[int]) -> str:
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}.")
        return os.path.join(self.directory, str(epoch))

    def restore(self, trainer, epoch: Optional[int] = None) -> Tuple[dict, int]:
        """Load epoch ``epoch`` (default the latest) into ``trainer``: its modules and
        its generator. Returns ``(state, global_step)``, the state's tensors on the
        trainer's device."""
        ckpt = torch.load(os.path.join(self._epoch_dir(epoch), "state.pt"),
                          map_location=trainer.device, weights_only=True)
        trainer.decoder.load_state_dict(ckpt["nef"])
        trainer.ode_model.load_state_dict(ckpt["ode"])
        trainer.generator.set_state(ckpt["generator"].cpu())
        state = {k: ckpt[k] for k in ("autodecoder", "meta_sgd_lrs", "opt")}
        return state, ckpt["global_step"]

    def restore_config(self, epoch: Optional[int] = None) -> dict:
        """The config saved with epoch ``epoch`` (default the latest)."""
        with open(os.path.join(self._epoch_dir(epoch), "config.json")) as f:
            return json.load(f)

    def wait(self):
        """Nothing to wait for: saves are synchronous (orbax's are not)."""

    def close(self):
        """Nothing to release: no file stays open between saves."""
