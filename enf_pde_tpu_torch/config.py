"""Experiment configuration as plain Python dicts with attribute access.

Counterpart of ``enf_pde_tpu/config.py`` without PyYAML: the port runs where PyYAML is
not installed, so each ported experiment's configuration is written out here with
the same keys and values as its YAML file under
``enf_pde_tpu/experiments/configs/``, and the ``key.sub=value`` overrides are parsed
here with the YAML 1.1 scalar rules PyYAML applies (``_parse_value``). ``load_config``
reads a YAML file of the kind those files are (block mappings of scalars and ``[a, b]``
lists, comments) with the same rules. CPU tests hold all three equal to the JAX
package's.
"""

from __future__ import annotations

import copy
import json
import math
import re
from typing import Any, Iterable, Mapping

__all__ = ["Config", "apply_overrides", "load_config", "load_experiment_config", "NAVIER_STOKES",
           "NAVIER_STOKES_NONMAML", "DIFFUSION_PLANE", "CAHN_HILLIARD", "DIFF_SPHERE", "SHALLOW_WATER",
           "IHC"]


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

    def copy(self) -> "Config":
        """A deep copy."""
        return Config(copy.deepcopy(self.to_dict()))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), default=str)


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


# ``enf_pde_tpu/experiments/configs/navier_stokes_nonmaml.yaml``, key for key: the
# autodecoding baseline (``meta.meta_sgd: false``) on the Navier-Stokes data.
NAVIER_STOKES_NONMAML = {
    "seed": 0,
    "proj_name": "enf-pde-tpu",
    "logging": {
        "log_dir": "outputs/navier_stokes_nonmaml",
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
        "traj_len_out_horizon": 10,
        "path": "data/",
        "num_signals_train": 8192,
        "num_signals_test": 512,
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
        "embedding_freq_multiplier_value": 0.2,
        "invariant_type": "rel_pos_periodic",
        "backend": "xla",
        "eval_backend": "pallas",
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
        "max_num_sampled_points": 2048,
        "ode": {"train_from_epoch": 600, "train_until_epoch": 2000},
        "nef": {"train_from_epoch": 0, "fit_on_num_steps": 2, "train_until_epoch": 600},
    },
    "test": {"test_interval": 500, "test_dp_interval": 9999, "test_equiv_at_epoch": 400,
             "refit_epochs": 100},
    "meta": {
        "meta_sgd": False,
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
        "learning_rate_codes": 1.0e-3,
        "learning_rate_ode": 1.0e-3,
    },
}


# ``enf_pde_tpu/experiments/configs/diffusion_plane.yaml``, key for key.
DIFFUSION_PLANE = {
    "seed": 0,
    "proj_name": "enf-pde-tpu",
    "logging": {
        "log_dir": "outputs/diffusion_plane",
        "log_every_n_steps": 50,
        "checkpoint_every_n_epochs": 50,
        "keep_n_checkpoints": 1,
        "checkpoint": True,
        "resume": False,
        "use_wandb": False,
        "visualize_every_n_epochs": 0,
    },
    "dataset": {
        "name": "diffusion_plane",
        "batch_size": 8,
        "traj_len_train": 10,
        "traj_len_out_horizon": 10,
        "path": "data/",
        "num_signals_train": 2048,
        "num_signals_test": 32,
    },
    "nef": {
        "num_in": 2,
        "num_out": 1,
        "num_layers": 0,
        "num_hidden": 64,
        "num_heads": 2,
        "condition_value_transform": True,
        "latent_dim": 16,
        "num_latents": 4,
        "gaussian_window": -1,
        "optimize_gaussian_window": False,
        "use_gaussian_window": True,
        "embedding_type": "rff",
        "embedding_freq_multiplier_invariant": 0.05,
        "embedding_freq_multiplier_value": 0.01,
        "invariant_type": "ponita",
        "backend": "xla",
        "eval_backend": "pallas",
    },
    "node": {
        "name": "ponita",
        "num_layers": 3,
        "num_hidden": 64,
        "widening_factor": 2,
        "kernel_size": "global",
        "degree": 3,
        "basis_dim": 64,
        "dt": 1,
        "method": "euler",
    },
    "training": {
        "num_epochs": 1000,
        "max_num_sampled_points": 1024,
        "ode": {"train_from_epoch": 100, "train_until_epoch": 10000},
        "nef": {"train_from_epoch": 0, "fit_on_num_steps": 4, "train_until_epoch": 100},
    },
    "test": {"test_interval": 100, "test_dp_interval": 100, "test_equiv_at_epoch": 200},
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

# ``enf_pde_tpu/experiments/configs/cahn_hilliard.yaml``, key for key.
CAHN_HILLIARD = {
    "seed": 0,
    "proj_name": "enf-pde-tpu",
    "logging": {
        "log_dir": "outputs/cahn_hilliard",
        "log_every_n_steps": 50,
        "checkpoint_every_n_epochs": 50,
        "keep_n_checkpoints": 1,
        "checkpoint": True,
        "resume": False,
        "use_wandb": False,
        "visualize_every_n_epochs": 0,
    },
    "dataset": {
        "name": "cahn_hilliard",
        "batch_size": 8,
        "traj_len_train": 10,
        "traj_len_out_horizon": 10,
        "path": "data/",
        "num_signals_train": 2048,
        "num_signals_test": 32,
    },
    "nef": {
        "num_in": 2,
        "num_out": 1,
        "num_layers": 0,
        "num_hidden": 64,
        "num_heads": 2,
        "condition_value_transform": True,
        "latent_dim": 32,
        "num_latents": 9,
        "gaussian_window": -1,
        "optimize_gaussian_window": False,
        "use_gaussian_window": True,
        "embedding_type": "rff",
        "embedding_freq_multiplier_invariant": 0.05,
        "embedding_freq_multiplier_value": 0.2,
        "invariant_type": "ponita",
        "backend": "xla",
        "eval_backend": "pallas",
    },
    "node": {
        "name": "ponita",
        "num_layers": 3,
        "num_hidden": 128,
        "widening_factor": 2,
        "kernel_size": 0.2,
        "degree": 3,
        "basis_dim": 128,
        "dt": 1,
        "method": "euler",
    },
    "training": {
        "num_epochs": 10000,
        "max_num_sampled_points": 2048,
        "ode": {"train_from_epoch": 100, "train_until_epoch": 10000},
        "nef": {"train_from_epoch": 0, "fit_on_num_steps": 3, "train_until_epoch": 100},
    },
    "test": {"test_interval": 100, "test_dp_interval": 1000, "test_equiv_at_epoch": 400},
    "meta": {
        "meta_sgd": True,
        "num_inner_steps": 3,
        "inner_learning_rate_p": 2.0,
        "inner_learning_rate_a": 2.0,
        "inner_learning_rate_window": 0.0,
        "learning_rate_meta_sgd": 1.0e-4,
        "noise_pos_inner_loop": 0.05,
    },
    "optimizer": {
        "name": "adamw",
        "learning_rate_enf": 1.0e-4,
        "learning_rate_codes": 0.0,
        "learning_rate_ode": 1.0e-3,
    },
}

# ``enf_pde_tpu/experiments/configs/diff_sphere.yaml``, key for key.
DIFF_SPHERE = {
    "seed": 0,
    "proj_name": "enf-pde-tpu",
    "logging": {
        "log_dir": "outputs/diff_sphere",
        "log_every_n_steps": 50,
        "checkpoint_every_n_epochs": 50,
        "keep_n_checkpoints": 1,
        "checkpoint": True,
        "resume": False,
        "use_wandb": False,
        "visualize_every_n_epochs": 0,
    },
    "dataset": {
        "name": "diff_sphere",
        "batch_size": 2,
        "traj_len_train": 10,
        "traj_len_out_horizon": 10,
        "path": "data/",
        "num_signals_train": 512,
        "num_signals_test": 128,
    },
    "nef": {
        "num_in": 2,
        "num_out": 1,
        "num_layers": 0,
        "num_hidden": 16,
        "num_heads": 2,
        "condition_value_transform": True,
        "latent_dim": 4,
        "num_latents": 18,
        "gaussian_window": -1,
        "optimize_gaussian_window": False,
        "use_gaussian_window": False,
        "embedding_type": "rff",
        "embedding_freq_multiplier_invariant": 0.01,
        "embedding_freq_multiplier_value": 0.01,
        "invariant_type": "polar_periodic",
        "backend": "xla",
        "eval_backend": "pallas",
    },
    "node": {
        "name": "ponita",
        "num_layers": 3,
        "num_hidden": 32,
        "widening_factor": 2,
        "kernel_size": "global",
        "degree": 3,
        "basis_dim": 32,
        "dt": 1,
        "method": "euler",
    },
    "training": {
        "num_epochs": 750,
        "max_num_sampled_points": 2048,
        "ode": {"train_from_epoch": 150, "train_until_epoch": 9999},
        "nef": {"train_from_epoch": 0, "fit_on_num_steps": 4, "train_until_epoch": 150},
    },
    "test": {"test_interval": 100, "test_dp_interval": 500, "test_equiv_at_epoch": 400},
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

# ``enf_pde_tpu/experiments/configs/shallow_water.yaml``, key for key.
SHALLOW_WATER = {
    "seed": 0,
    "proj_name": "enf-pde-tpu",
    "logging": {
        "log_dir": "outputs/shallow_water",
        "log_every_n_steps": 50,
        "checkpoint_every_n_epochs": 50,
        "keep_n_checkpoints": 1,
        "checkpoint": True,
        "resume": False,
        "use_wandb": False,
        "visualize_every_n_epochs": 0,
    },
    "dataset": {
        "name": "shallow_water_low_res",
        "batch_size": 1,
        "traj_len_train": 10,
        "traj_len_out_horizon": 4,
        "path": "data/",
        "num_signals_train": 512,
        "num_signals_test": 128,
    },
    "nef": {
        "num_in": 2,
        "num_out": 1,
        "num_layers": 0,
        "num_hidden": 128,
        "num_heads": 2,
        "condition_value_transform": True,
        "latent_dim": 32,
        "num_latents": 8,
        "gaussian_window": -1,
        "optimize_gaussian_window": False,
        "use_gaussian_window": True,
        "embedding_type": "rff",
        "embedding_freq_multiplier_invariant": 0.05,
        "embedding_freq_multiplier_value": 0.2,
        "invariant_type": "latitude_periodic",
        "backend": "xla",
        "eval_backend": "pallas",
        "ode_backend": "pallas",
    },
    "node": {
        "name": "ponita",
        "num_layers": 3,
        "num_hidden": 256,
        "widening_factor": 2,
        "kernel_size": "global",
        "degree": 3,
        "basis_dim": 128,
        "dt": 1,
        "method": "euler",
    },
    "training": {
        "num_epochs": 1500,
        "max_num_sampled_points": 2048,
        "ode": {"train_from_epoch": 500, "train_until_epoch": 2000},
        "nef": {"train_from_epoch": 0, "fit_on_num_steps": 4, "train_until_epoch": 500},
    },
    "test": {"test_interval": 100, "test_dp_interval": 1000, "test_equiv_at_epoch": 400},
    "meta": {
        "meta_sgd": True,
        "num_inner_steps": 3,
        "inner_learning_rate_p": 0.0,
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

# ``enf_pde_tpu/experiments/configs/ihc.yaml``, key for key.
IHC = {
    "seed": 0,
    "proj_name": "enf-pde-tpu",
    "logging": {
        "log_dir": "outputs/ihc",
        "log_every_n_steps": 50,
        "checkpoint_every_n_epochs": 50,
        "keep_n_checkpoints": 1,
        "checkpoint": True,
        "resume": False,
        "use_wandb": False,
        "visualize_every_n_epochs": 0,
    },
    "dataset": {
        "name": "ihc",
        "batch_size": 1,
        "traj_len_train": 10,
        "traj_len_out_horizon": 4,
        "path": "data/",
        "num_signals_train": 512,
        "num_signals_test": 128,
    },
    "nef": {
        "num_in": 3,
        "num_out": 1,
        "num_layers": 0,
        "num_hidden": 32,
        "num_heads": 3,
        "condition_value_transform": True,
        "latent_dim": 32,
        "num_latents": 25,
        "gaussian_window": -1,
        "optimize_gaussian_window": False,
        "use_gaussian_window": True,
        "embedding_type": "rff",
        "embedding_freq_multiplier_invariant": 0.2,
        "embedding_freq_multiplier_value": 0.5,
        "invariant_type": "ball",
        "backend": "xla",
        "eval_backend": "pallas",
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
        "num_epochs": 2500,
        "max_num_sampled_points": 2048,
        "ode": {"train_from_epoch": 500, "train_until_epoch": 2000},
        "nef": {"train_from_epoch": 0, "fit_on_num_steps": 2, "train_until_epoch": 500},
    },
    "test": {"test_interval": 100, "test_dp_interval": 1000, "test_equiv_at_epoch": 400},
    "meta": {
        "meta_sgd": True,
        "num_inner_steps": 3,
        "inner_learning_rate_p": 0.0,
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

_EXPERIMENTS = {"navier_stokes": NAVIER_STOKES, "navier_stokes_nonmaml": NAVIER_STOKES_NONMAML,
                "diffusion_plane": DIFFUSION_PLANE,
                "cahn_hilliard": CAHN_HILLIARD, "diff_sphere": DIFF_SPHERE,
                "shallow_water": SHALLOW_WATER, "ihc": IHC}


# PyYAML's implicit resolvers for untagged plain scalars (YAML 1.1), ``yaml/resolver.py``.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)


def _sexagesimal(text: str, cast) -> Any:
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    text = text.lstrip("+-")
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    return sign * (_sexagesimal(text, int) if ":" in text else int(text))


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    text = text.lstrip("+-")
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    return sign * (_sexagesimal(text, float) if ":" in text else float(text))


def _scalar(text: str) -> Any:
    """One plain or quoted scalar, resolved as PyYAML's ``safe_load`` resolves it."""
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return json.loads(text)
    if text[:1] in ("{", "&", "*", "!", "|", ">", "%") or text == "-" or text.startswith("- ") \
            or ": " in text or text.endswith(":"):
        raise ValueError(f"Override value {text!r} is YAML that the port does not parse "
                         "(only scalars and [a, b] lists).")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


def _flow_list(text: str, pos: int):
    """Parse the ``[...]`` starting at ``text[pos]``; returns (list, index after it)."""
    items, pos = [], pos + 1
    while True:
        while pos < len(text) and text[pos] == " ":
            pos += 1
        if pos >= len(text):
            raise ValueError("unclosed [")
        if text[pos] == "]":
            return items, pos + 1
        if text[pos] == "[":
            item, pos = _flow_list(text, pos)
        else:
            end = pos
            while end < len(text) and text[end] not in ",]":
                end += 1
            item, pos = _scalar(text[pos:end].strip()), end
        items.append(item)
        while pos < len(text) and text[pos] == " ":
            pos += 1
        if pos < len(text) and text[pos] == ",":
            pos += 1
        elif pos >= len(text) or text[pos] != "]":
            raise ValueError("expected , or ]")


def _parse_value(raw: str) -> Any:
    """Parse a CLI override value as the JAX package's ``_parse_value`` does
    (``yaml.safe_load``): int, float (YAML 1.1: ``1.0e-4`` is a float, ``1e-4`` a
    string), bool (``true`` / ``yes`` / ``on`` ...), null, ``[a, b]`` lists, quoted
    and plain strings. A value YAML cannot parse stays the raw string, as there."""
    text = re.split(r"\s#", raw.strip(), maxsplit=1)[0].strip()
    if text.startswith("["):
        try:
            value, end = _flow_list(text, 0)
        except ValueError:
            return raw
        return value if not text[end:].strip() else raw
    return _scalar(text)


def _read_yaml(text: str) -> dict:
    """The mapping of a block-style YAML document: nested ``key: value`` mappings by
    indentation, values as ``_parse_value`` reads them, ``#`` comments; a key with
    neither a value nor an indented block under it is None, as in PyYAML. Raises on
    anything else (sequences of ``- item`` lines, anchors, multi-line scalars)."""
    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping) of the open blocks
    opened = set()  # ids of the mappings opened by a bare "key:", until a child arrives
    for lineno, line in enumerate(text.splitlines(), 1):
        body = line.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        indent = len(line) - len(body)
        key, sep, rest = body.partition(":")
        if not sep or (rest and rest[0] not in " \t") or key != key.strip() or body.startswith("- "):
            raise ValueError(f"line {lineno}: {line!r} is YAML that the port does not parse")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        opened.discard(id(parent))
        value = rest.strip()
        if not value or value.startswith("#"):
            parent[key] = child = {}
            opened.add(id(child))
            stack.append((indent, child))
        else:
            parent[key] = _parse_value(value)

    def close(node: dict) -> dict:
        return {k: (None if id(v) in opened else close(v)) if isinstance(v, dict) else v
                for k, v in node.items()}

    return close(root)


def load_config(path: str, overrides: Iterable[str] = ()) -> Config:
    """Read a YAML config file (``_read_yaml``) and apply ``key.sub=value`` overrides."""
    with open(path) as f:
        cfg = Config(_read_yaml(f.read()))
    return apply_overrides(cfg, overrides)


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    """Apply ``key.sub=value`` overrides to ``cfg`` in place; returns it."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must look like key.subkey=value, got: {ov!r}")
        key, raw = ov.split("=", 1)
        cfg.set_path(key.strip(), _parse_value(raw.strip()))
    return cfg


def load_experiment_config(name: str, overrides: Iterable[str] = ()) -> Config:
    """A fresh copy of a ported experiment's configuration, e.g. ``navier_stokes``,
    with ``key.sub=value`` overrides applied."""
    if name not in _EXPERIMENTS:
        raise ValueError(f"Unknown experiment {name!r} (known: {sorted(_EXPERIMENTS)})")
    return apply_overrides(Config(copy.deepcopy(_EXPERIMENTS[name])), overrides)
