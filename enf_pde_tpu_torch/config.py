"""Experiment configuration as plain Python dicts with attribute access.

Counterpart of ``enf_pde_tpu/config.py`` without YAML: the port runs where PyYAML is
not installed, so each ported experiment's configuration is written out here with
the same keys and values as its YAML file under
``enf_pde_tpu/experiments/configs/``. A CPU test holds each one equal to the JAX
package's ``load_experiment_config``.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

__all__ = ["Config", "load_experiment_config", "NAVIER_STOKES"]


class Config(dict):
    """A dict with attribute access and dotted-path get/set. Nested dicts are Configs."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Config) else v for k, v in self.items()}


# ``enf_pde_tpu/experiments/configs/navier_stokes.yaml``, key for key.
NAVIER_STOKES = {
    "seed": 0,
    "proj_name": "enf-pde-tpu",
    "logging": {
        "log_dir": "outputs/navier_stokes",
        "log_every_n_steps": 50,
        "checkpoint_every_n_epochs": 50,
        "keep_n_checkpoints": 1,
        "checkpoint": True,
        "resume": False,
        "use_wandb": False,
        "visualize_every_n_epochs": 0,
    },
    "dataset": {
        "name": "navier_stokes",
        "batch_size": 8,
        "traj_len_train": 10,
        "traj_len_out_horizon": 50,
        "path": "data/",
        "num_signals_train": 16,
        "num_signals_test": 16,
    },
    "nef": {
        "num_in": 2,
        "num_out": 1,
        "num_layers": 0,
        "num_hidden": 128,
        "num_heads": 2,
        "condition_value_transform": True,
        "latent_dim": 16,
        "num_latents": 4,
        "gaussian_window": -1,
        "optimize_gaussian_window": False,
        "use_gaussian_window": True,
        "embedding_type": "rff",
        "embedding_freq_multiplier_invariant": 0.05,
        "embedding_freq_multiplier_value": 0.1,
        "invariant_type": "rel_pos_periodic",
        "backend": "xla",
        "eval_backend": "pallas",
        "ode_backend": "pallas",
    },
    "node": {
        "name": "ponita",
        "num_layers": 3,
        "num_hidden": 128,
        "widening_factor": 2,
        "kernel_size": "global",
        "degree": 3,
        "basis_dim": 64,
        "dt": 1,
        "method": "euler",
    },
    "training": {
        "num_epochs": 2000,
        "max_num_sampled_points": 512,
        "ode": {"train_from_epoch": 400, "train_until_epoch": 2000},
        "nef": {"train_from_epoch": 0, "fit_on_num_steps": 2, "train_until_epoch": 400},
    },
    "test": {"test_interval": 50, "test_dp_interval": 500, "test_equiv_at_epoch": 400},
    "meta": {
        "meta_sgd": True,
        "num_inner_steps": 3,
        "inner_learning_rate_p": 1.0,
        "inner_learning_rate_a": 5.0,
        "inner_learning_rate_window": 0.0,
        "learning_rate_meta_sgd": 1.0e-4,
        "noise_pos_inner_loop": 0.0,
    },
    "optimizer": {
        "name": "adamw",
        "learning_rate_enf": 1.0e-4,
        "learning_rate_codes": 0.0,
        "learning_rate_ode": 1.0e-3,
    },
}

_EXPERIMENTS = {"navier_stokes": NAVIER_STOKES}


def load_experiment_config(name: str) -> Config:
    """A fresh copy of a ported experiment's configuration, e.g. ``navier_stokes``."""
    if name not in _EXPERIMENTS:
        raise NotImplementedError(
            f"Experiment {name!r} is not ported yet (ported: {sorted(_EXPERIMENTS)}); "
            "see ROADMAP.md, Queue 1."
        )
    return Config(copy.deepcopy(_EXPERIMENTS[name]))
