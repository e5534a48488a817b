"""Bridge from the JAX package's parameters to the port's.

The JAX state's ``params`` is ``{'nef', 'ode', 'autodecoder', 'meta_sgd_lrs'}`` (the
autodecoding trainer's has no ``meta_sgd_lrs``); the first two are flax trees ``{'params': {module: {...: leaf}}}``. The caller hands them
over as nested dicts of numpy arrays (this module does not import JAX). The port's
submodules carry the flax names (a list of blocks as ``self_attention_blocks_<i>``, an
embedding's layers as ``Dense_<i>``), so a leaf path maps to a ``state_dict`` key
directly, with the leaf renamed:

- ``kernel`` -> ``weight``, transposed (flax ``Dense.kernel`` is ``[in, out]``,
  the port's ``Dense.weight`` is ``[out, in]`` like ``nn.Linear``);
- ``scale`` -> ``weight`` (LayerNorm);
- ``bias`` and ``coefficients`` (RFF buffer) keep their names.

``load_jax_export`` reads a trained JAX run that ``tools/export_jax_checkpoint.py`` wrote as
numpy files (``config.json``, ``params.npz`` keyed by the flax paths joined with ``/``), with
numpy alone: the orbax checkpoint itself needs JAX, orbax and zstd.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from enf_pde_tpu_torch.builders import build_models, coordinate_system_for
from enf_pde_tpu_torch.config import Config
from enf_pde_tpu_torch.models.latents import init_latents

__all__ = ["flax_to_state_dict", "convert_params", "nest", "check_leaves", "load_jax_export"]

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias", "coefficients": "coefficients"}


def flax_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (with or without the top ``'params'`` level) -> state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            if name not in _LEAF_NAMES:
                raise KeyError(f"Unexpected flax leaf {prefix}{name}")
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                arr = arr.T
            out[f"{prefix}{_LEAF_NAMES[name]}"] = torch.from_numpy(np.array(arr, copy=True))

    walk(tree, "")
    return out


def convert_params(params: Mapping) -> dict:
    """The JAX trainer's ``state.params`` (numpy leaves) -> the port's parameters.

    Returns ``{'nef': decoder state_dict, 'ode': ODE state_dict, 'autodecoder': {...},
    'meta_sgd_lrs': {...}}``, the input of ``MetaSGDTrainer.load_state`` and of
    ``Forecaster(params=...)``; from an autodecoding state (no ``meta_sgd_lrs``) the
    last entry is None, and the result is the input of
    ``AutodecodingTrainer.load_state``.
    """
    as_tensors = lambda d: {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in d.items()}  # noqa: E731
    return {
        "nef": flax_to_state_dict(params["nef"]),
        "ode": flax_to_state_dict(params["ode"]),
        "autodecoder": as_tensors(params["autodecoder"]),
        "meta_sgd_lrs": as_tensors(params["meta_sgd_lrs"]) if "meta_sgd_lrs" in params else None,
    }


def nest(flat: Mapping[str, object]) -> dict:
    """``{'a/b/c': leaf}`` -> ``{'a': {'b': {'c': leaf}}}``: a tree from its ``/``-joined paths."""
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def check_leaves(cfg: Config, params: Mapping) -> None:
    """Raise ``KeyError`` naming each leaf of ``params`` (``convert_params``'s output) that the
    port's models and latents of ``cfg`` do not have, and each they need that it lacks: the
    decoder's and the ODE's ``state_dict`` keys, the latent init's (``init_latents``) and, for a
    meta-SGD config (``meta.meta_sgd``, default on), one inner learning rate for each latent."""
    decoder, ode = build_models(cfg)
    inv = decoder.cross_attn_invariant
    latents = init_latents(1, cfg.nef.num_latents, cfg.nef.latent_dim, inv.num_z_pos_dims, inv.num_z_ori_dims,
                           coordinate_system_for(cfg.dataset.name), cfg.nef.gaussian_window)
    want = {"nef": decoder.state_dict(), "ode": ode.state_dict(), "autodecoder": latents,
            "meta_sgd_lrs": latents if cfg.get_path("meta.meta_sgd", True) else {}}
    odd = [f"{'unexpected' if key in (params[group] or ()) else 'missing'} {group} leaf {key}"
           for group, names in want.items() for key in sorted(set(params[group] or ()) ^ set(names))]
    if odd:
        raise KeyError("; ".join(odd))


def load_jax_export(path) -> Tuple[Config, dict, dict]:
    """A JAX run exported by ``tools/export_jax_checkpoint.py`` under ``path``.

    Returns ``(config, params, record)``: the run's config, its parameters through
    ``convert_params`` (the input of ``MetaSGDTrainer.load_state``, or of
    ``AutodecodingTrainer.load_state`` for an autodecoding run), and the rest of
    ``config.json`` (``run``, ``epoch``, ``metrics``: the run's last validation line).
    Raises ``KeyError`` naming a leaf of ``params.npz`` that the config's models do not have,
    or one they need that it lacks (``check_leaves``; a leaf name that no module has is
    refused by ``flax_to_state_dict``).
    """
    path = Path(path)
    record = json.loads((path / "config.json").read_text())
    cfg = Config(record.pop("config"))
    with np.load(path / "params.npz", allow_pickle=False) as f:
        params = convert_params(nest({key: f[key] for key in f.files}))
    check_leaves(cfg, params)
    return cfg, params, record
