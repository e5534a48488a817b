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
numpy files (``config.json``, ``params.npz`` keyed by the flax paths joined with ``/``, and
``opt_state.npz``, the optimizer states keyed by their optax paths), with numpy alone: the orbax
checkpoint itself needs JAX, orbax and zstd. ``load_opt_state`` maps the optimizer states to the
port's (``convert_opt_state``; ``train/state.py``), and ``write_resume_checkpoint`` writes the
whole run as the port's checkpoint, from which ``run_experiment`` with ``logging.resume`` trains
on, as JAX's ``TrainLoop.run`` resumes from its own.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from enf_pde_tpu_torch.builders import build_models, coordinate_system_for
from enf_pde_tpu_torch.config import Config
from enf_pde_tpu_torch.models.latents import init_latents
from enf_pde_tpu_torch.train.checkpoint import CheckpointManager
from enf_pde_tpu_torch.train.inner_loop import init_meta_sgd_lrs
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.train.state import moment_mismatches

__all__ = ["flax_to_state_dict", "convert_params", "nest", "port_leaves", "check_leaves", "convert_opt_state",
           "load_jax_export", "load_opt_state", "write_resume_checkpoint"]

# Where ``make_optimizers`` (``enf_pde_tpu/train/state.py``) puts optax's ``ScaleByAdamState`` in each
# group's state, and the parameter group it updates. ``chain(clip_by_global_norm, adamw)`` (decoder,
# ODE) is ``(clip's EmptyState, (ScaleByAdamState, decay's EmptyState, learning rate's EmptyState))``;
# ``adam`` (latent init, inner learning rates) is ``(ScaleByAdamState, learning rate's EmptyState)``.
# Empty states hold no leaf; a leaf anywhere else is a chain this map does not describe.
ADAM_STATE = {"nef": ("1/0", "nef"), "ode": ("1/0", "ode"), "autodecoder": ("0", "autodecoder"),
              "meta_sgd": ("0", "meta_sgd_lrs")}

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


def port_leaves(cfg: Config) -> Dict[str, Dict[str, tuple]]:
    """``{group: {leaf: shape}}`` of the port's trainer state for ``cfg``: the decoder's and the
    ODE's ``state_dict`` (parameters and RFF buffers: their optimizer groups), the latent init
    (``init_latents``: one signal, or ``dataset.num_signals_train`` rows of an autodecoding table)
    and, for a meta-SGD config (``meta.meta_sgd``, default on), the inner learning rates
    (``init_meta_sgd_lrs``; else none)."""
    decoder, ode = build_models(cfg)
    inv = decoder.cross_attn_invariant
    meta = cfg.get_path("meta.meta_sgd", True)
    latents = init_latents(1 if meta else cfg.dataset.num_signals_train, cfg.nef.num_latents, cfg.nef.latent_dim,
                           inv.num_z_pos_dims, inv.num_z_ori_dims, coordinate_system_for(cfg.dataset.name),
                           cfg.nef.gaussian_window)
    lrs = init_meta_sgd_lrs(cfg.nef.latent_dim, 1.0, 1.0, 1.0, inv.num_z_ori_dims > 0) if meta else {}
    shapes = lambda group: {k: tuple(v.shape) for k, v in group.items()}  # noqa: E731
    return {"nef": shapes(decoder.state_dict()), "ode": shapes(ode.state_dict()), "autodecoder": shapes(latents),
            "meta_sgd_lrs": shapes(lrs)}


def check_leaves(cfg: Config, params: Mapping) -> None:
    """Raise ``KeyError`` naming each leaf of ``params`` (``convert_params``'s output) that the
    port's models and latents of ``cfg`` do not have, and each they need that it lacks
    (``port_leaves``): the decoder's and the ODE's ``state_dict`` keys, the latent init's and, for a
    meta-SGD config, one inner learning rate for each latent."""
    odd = [f"{'unexpected' if key in (params[group] or ()) else 'missing'} {group} leaf {key}"
           for group, names in port_leaves(cfg).items() for key in sorted(set(params[group] or ()) ^ set(names))]
    if odd:
        raise KeyError("; ".join(odd))


def convert_opt_state(cfg: Config, flat: Mapping[str, np.ndarray]) -> dict:
    """The JAX state's optimizer states, flattened as ``opt_state.npz`` holds them (its leaves but
    ``rng`` and ``step``), -> the port's ``state["opt"]``: ``{'nef' | 'ode' | 'autodecoder' |
    'meta_sgd': {'count': int, 'mu': {...}, 'nu': {...}}}`` (``train/state.py::Adam.init``'s
    structure; no ``meta_sgd`` for an autodecoding config), CPU float32 tensors. The decoder's and
    the ODE's moments are keyed by the port's ``state_dict`` keys, ``kernel`` moments transposed as
    ``flax_to_state_dict`` transposes the parameters (the RFF ``coefficients`` moments kept: the
    port's AdamW group holds those buffers); the latents' and learning rates' keep their layout.

    Strict, as ``check_leaves``: raises ``KeyError`` naming every leaf that is missing, one too
    many, of another shape than the port's group (``port_leaves``, ``moment_mismatches``), or not
    where ``ADAM_STATE`` says ``make_optimizers`` puts its ``ScaleByAdamState``: a changed optax
    chain is refused, not misread."""
    want = port_leaves(cfg)
    groups = {g: v for g, v in ADAM_STATE.items() if want[v[1]]}
    out, odd, used = {}, [], set()
    for group, (chain_path, param_group) in groups.items():
        prefix = f"{group}/{chain_path}/"
        count = flat.get(prefix + "count")
        scalar = count is not None and count.shape == () and np.issubdtype(count.dtype, np.integer)
        if not scalar:
            odd.append(f"missing {group} leaf {prefix}count (an integer scalar)")
        out[group] = {"count": int(count) if scalar else None}
        used.add(prefix + "count")
        for moment in ("mu", "nu"):
            start = f"{prefix}{moment}/"
            tree = nest({k[len(start):]: v for k, v in flat.items() if k.startswith(start)})
            used.update(k for k in flat if k.startswith(start))
            if param_group in ("nef", "ode"):
                out[group][moment] = flax_to_state_dict(tree) if tree else {}
            else:
                out[group][moment] = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in tree.items()}
    odd += moment_mismatches(out, {g: want[param_group] for g, (_, param_group) in groups.items()})
    odd += [f"unexpected leaf {k} (not where make_optimizers puts its ScaleByAdamState)" for k in sorted(set(flat) - used)]
    if odd:
        raise KeyError("; ".join(odd))
    return out


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


def load_opt_state(path, cfg: Config) -> Tuple[dict, Optional[int], Tuple[int, int]]:
    """The optimizer states of the JAX run exported under ``path`` (``opt_state.npz``), whose
    config is ``cfg``. Returns ``(opt, step, rng)``: the states through ``convert_opt_state`` (the
    ``opt`` of ``load_state``), the loop's global step (None where the run's record had none) and
    JAX's key as two ints. Raises ``FileNotFoundError`` where the export holds no optimizer states,
    and ``KeyError`` as ``convert_opt_state`` does."""
    file = Path(path) / "opt_state.npz"
    if not file.exists():
        raise FileNotFoundError(f"{file} is missing: the export holds no optimizer states "
                                "(tools/export_jax_checkpoint.py --only opt_state.npz writes them)")
    with np.load(file, allow_pickle=False) as f:
        flat = {key: f[key] for key in f.files}
    if "rng" not in flat:
        raise KeyError(f"missing leaf rng of {file}")
    rng = tuple(int(k) for k in flat.pop("rng"))
    step = flat.pop("step", None)
    return convert_opt_state(cfg, flat), None if step is None else int(step), rng


def write_resume_checkpoint(export_dir, log_dir) -> Path:
    """Write the JAX run exported under ``export_dir`` (with its ``opt_state.npz``) as the port's
    checkpoint of its epoch, ``<log_dir>/checkpoints/<epoch>/``, by ``CheckpointManager.save`` of a
    CPU ``MetaSGDTrainer`` that holds it: the parameters (``load_jax_export``), the optimizer states
    (``load_opt_state``), ``global_step`` the export's ``step``, and the training generator seeded
    from JAX's key ``(k0, k1)`` as ``manual_seed((k0 << 32) | k1)`` (the port's draws cannot follow
    JAX's streams; the key fixes which draws the resumed run takes). Then ``run_experiment`` with
    ``logging.resume=true`` and ``logging.log_dir=<log_dir>`` trains on from epoch ``epoch + 1``.
    Returns the epoch's directory. Raises ``FileNotFoundError`` where the export has no optimizer
    states (it never writes fresh ones), ``ValueError`` for an autodecoding run (its loop writes
    and reads no checkpoints) or one whose export records no global step, and
    ``FileExistsError`` where ``log_dir`` already holds a checkpoint."""
    cfg, params, record = load_jax_export(export_dir)
    if params["meta_sgd_lrs"] is None:
        raise ValueError(f"{export_dir} is an autodecoding run: its loop writes and reads no checkpoints")
    opt, step, (k0, k1) = load_opt_state(export_dir, cfg)
    if step is None:
        raise ValueError(f"{Path(export_dir) / 'opt_state.npz'} records no global step (its run's validation line had none)")
    # A checkpoint holds no grid: the trainer gets a one-point stand-in.
    trainer = MetaSGDTrainer(cfg, *build_models(cfg), np.zeros((1, cfg.nef.num_in), np.float32), device="cpu")
    state = trainer.load_state(params, opt)
    trainer.generator.manual_seed((k0 << 32) | k1)
    manager = CheckpointManager(str(log_dir))
    if not manager.save(record["epoch"], trainer, state, cfg.to_dict(), global_step=step):
        raise FileExistsError(f"{manager.directory} already holds epoch {manager.latest_epoch()}")
    return Path(manager.directory) / str(record["epoch"])
