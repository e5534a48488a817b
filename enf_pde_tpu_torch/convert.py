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
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "convert_params"]

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
