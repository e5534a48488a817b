"""Export a trained JAX run to plain numpy files that the PyTorch port serves.

    python tools/export_jax_checkpoint.py results/ckpt/ns8192_s0 --out weights/ns8192_s0 [--epoch N] [--only FILE ...]

Runs on the CPU with the JAX package and orbax (an orbax state is zstd-compressed zarr chunks
in OCDBT storage, which the port cannot read). The run directory is copied to a temporary
directory first, so nothing under it is written. The state is restored with the JAX
``CheckpointManager`` into a trainer built from the run's own saved config and the registry's
training grid for its dataset. Writes, under ``--out``:

- ``config.json``: ``{"run", "epoch", "config", "metrics"}``: the run's config dict verbatim,
  the epoch exported (default the latest), and the last line of the run's ``metrics.jsonl``
  that holds ``val_mse_in_t``;
- ``params.npz``: every leaf of ``state.params``, keyed by its path joined with ``/`` (for
  example ``nef/params/out_proj/kernel``), as its own float32 array, untransposed (flax
  layouts: ``enf_pde_tpu_torch.convert`` maps them);
- ``opt_state.npz`` (zip-compressed: moments compress by about 10 %): every leaf of the four
  optimizer states (``nef_opt_state``, ``ode_opt_state``, ``autodecoder_opt_state``,
  ``meta_sgd_opt_state``), keyed by the field's name without ``_opt_state`` and the leaf's path in
  the optax chain joined with ``/`` (for example ``nef/1/0/mu/params/out_proj/kernel`` and
  ``nef/1/0/count``: the clip's empty state first, then AdamW's chain, Adam's state first in it),
  each with its own dtype (int32 counts, float32 moments, untransposed); empty states write
  nothing. Beside them ``rng`` (the state's uint32[2] key) and ``step`` (the loop's global step:
  the ``step`` of the last validation line; left out where that line has none).
  ``enf_pde_tpu_torch.convert.convert_opt_state`` maps them and checks the chain's positions;
- ``reference.npz``: JAX's outputs on the CPU for seeded inputs,
  from ``np.random.default_rng(0)``: ``coords`` (the training grid); ``p``, ``a``, ``window``:
  two latent sets, the trained init tiled twice and perturbed (positions and orientations by
  0.1, contexts by 0.5 standard normals; an autodecoding run's first two codes instead);
  ``decode_f32``: their decode on the whole grid by the XLA decoder at highest precision;
  ``decode_bf16``: the same decode by the fused Pallas decoder in interpret mode at
  ``compute_dtype=bfloat16`` (the mode the kernel runs on the TPU); and, for a meta-SGD run,
  ``forecast``: ``Forecaster(..., backend="xla").forecast`` of the two f32 fields, taken as
  frames at ``dp = 0``, over ``dataset.traj_len_train`` frames, with ``forecast_masks``, the
  inner loop's coordinate masks that call drew.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from enf_pde_tpu.builders import build_models  # noqa: E402
from enf_pde_tpu.config import Config  # noqa: E402
from enf_pde_tpu.data.registry import dataset_spec  # noqa: E402
from enf_pde_tpu.inference import Forecaster  # noqa: E402
from enf_pde_tpu.models.decoder import decode_chunked  # noqa: E402
from enf_pde_tpu.models.latents import latents_to_pose  # noqa: E402
from enf_pde_tpu.ops import pallas_decode  # noqa: E402
from enf_pde_tpu.train.autodecode import AutodecodingTrainer  # noqa: E402
from enf_pde_tpu.train.checkpoint import CheckpointManager  # noqa: E402
from enf_pde_tpu.train.inner_loop import sample_coordinate_masks  # noqa: E402
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer  # noqa: E402

__all__ = ["restore_run", "flat_params", "flat_opt_state", "last_val_record", "export_record", "reference_latents",
           "jax_decode", "reference_arrays", "export_run", "EXPORT_FILES"]

EXPORT_FILES = ("config.json", "params.npz", "reference.npz", "opt_state.npz")
OPT_STATE_FIELDS = ("nef", "ode", "autodecoder", "meta_sgd")

# Perturbation scale of each latent leaf (standard normals), in the order they are drawn.
PERTURB = (("p_pos", 0.1), ("p_ori", 0.1), ("a", 0.5))


def restore_run(run_dir, epoch=None):
    """(config dict, epoch, trainer, state, coords) of ``run_dir``'s checkpoint at ``epoch``
    (default the latest), restored from a copy in a temporary directory."""
    run_dir = Path(run_dir)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp) / run_dir.name
        shutil.copytree(run_dir / "checkpoints", work / "checkpoints")
        mgr = CheckpointManager(str(work))
        epoch = mgr.latest_epoch() if epoch is None else epoch
        cfg_dict = mgr.restore_config(epoch)
        cfg = Config(cfg_dict)
        coords = dataset_spec(cfg.dataset.name, cfg.dataset).coords
        decoder, ode = build_models(cfg)
        if cfg.get_path("meta.meta_sgd", True):
            trainer = MetaSGDTrainer(cfg, decoder, ode, coords, seed=cfg.seed)
        else:
            trainer = AutodecodingTrainer(cfg, decoder, ode, coords, seed=cfg.seed)
        state = mgr.restore(trainer.init_state(), epoch)
        mgr.close()
    return cfg_dict, int(epoch), trainer, state, np.asarray(coords, dtype=np.float32)


def flat_params(params) -> dict:
    """``{path joined with '/': float32 array}`` of every leaf of ``params``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        arr = np.asarray(leaf)
        key = "/".join(str(k.key) for k in path)
        if arr.dtype != np.float32:
            raise TypeError(f"{key} is {arr.dtype}, not float32")
        out[key] = arr
    return out


def _key_name(entry) -> str:
    """One entry of a JAX key path as text: a dict key, a sequence index or a named field."""
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(f"unexpected key path entry {entry!r}")


def flat_opt_state(state) -> dict:
    """``{field/path joined with '/': array}`` of every leaf of ``state``'s four optimizer states
    (the ``*_opt_state`` fields, named without the suffix), each with its own dtype."""
    out = {}
    for field in OPT_STATE_FIELDS:
        for path, leaf in jax.tree_util.tree_flatten_with_path(getattr(state, f"{field}_opt_state"))[0]:
            out["/".join([field, *(_key_name(k) for k in path)])] = np.asarray(leaf)
    return out


def last_val_record(run_dir) -> dict:
    """The last line of ``run_dir/metrics.jsonl`` that holds ``val_mse_in_t``."""
    record = None
    with open(Path(run_dir) / "metrics.jsonl") as f:
        for line in f:
            row = json.loads(line)
            if "val_mse_in_t" in row:
                record = row
    if record is None:
        raise ValueError(f"{run_dir}/metrics.jsonl has no val_mse_in_t line")
    return record


def export_record(run_dir, epoch: int, cfg_dict: dict) -> dict:
    """``config.json``'s content: the run's name, the epoch, its config and its last validation line."""
    return {"run": Path(run_dir).name, "epoch": epoch, "config": cfg_dict, "metrics": last_val_record(run_dir)}


def forecast_masks(cfg, num_coords: int) -> np.ndarray:
    """The inner-loop masks of the first ``Forecaster.fit`` call (its key, split as it splits)."""
    _, key = jax.random.split(jax.random.PRNGKey(cfg.get_path("seed", 0)))
    _, k_mask, _ = jax.random.split(key, 3)
    return np.asarray(sample_coordinate_masks(
        k_mask, num_coords, cfg.meta.num_inner_steps + 1, cfg.training.max_num_sampled_points))


def reference_latents(init: dict, meta: bool):
    """(p, a, window) of the two seeded latent sets drawn from the latent init ``init`` (the
    trained init tiled twice and perturbed for a meta-SGD run, else the table's first two codes;
    see the module's docstring), as numpy arrays."""
    rng = np.random.default_rng(0)
    init = {k: np.asarray(v) for k, v in init.items()}
    latents = {k: np.repeat(v, 2, axis=0) if meta else v[:2] for k, v in init.items()}
    if meta:
        for name, scale in PERTURB:
            if name in latents:
                v = latents[name]
                latents[name] = (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
    return tuple(np.asarray(t) for t in latents_to_pose(latents))


def jax_decode(cfg, nef, coords, p, a, w, compute_dtype=None) -> np.ndarray:
    """JAX's decode of the latents (p, a, w) [2, ...] on ``coords`` under the decoder weights
    ``nef``, chunked as the run trains: by the XLA decoder at highest precision, or with
    ``compute_dtype=jnp.bfloat16`` by the fused Pallas decoder in interpret mode at that dtype
    (its interpret mode asks the kernel for its f32 program; the TPU runs its bf16 one)."""
    base, _ = build_models(cfg)
    xs = jnp.broadcast_to(jnp.asarray(coords)[None], (2, *coords.shape))
    backend, mode = "xla", contextlib.nullcontext()
    if compute_dtype is not None:
        kernel = pallas_decode.fused_enf_decode
        backend, mode = "pallas_interpret", mock.patch.object(
            pallas_decode, "fused_enf_decode", lambda *args, **kw: kernel(*args, **{**kw, "compute_dtype": compute_dtype}))
    with jax.default_matmul_precision("highest"), mode:
        apply = jax.jit(base.clone(backend=backend).apply)
        return np.asarray(decode_chunked(apply, nef, xs, p, a, w, chunk_size=cfg.training.max_num_sampled_points))


def reference_arrays(cfg, params, coords) -> dict:
    """JAX's decodes (f32 and bf16) of the two seeded latent sets and, for a meta-SGD run, its
    forecast from the f32 fields (see the module's docstring), under ``params`` (a trainer's
    ``state.params``)."""
    meta = "meta_sgd_lrs" in params
    p, a, w = reference_latents(params["autodecoder"], meta)
    f32 = jax_decode(cfg, params["nef"], coords, p, a, w)
    out = dict(coords=coords, p=p, a=a, window=w, decode_f32=f32,
               decode_bf16=jax_decode(cfg, params["nef"], coords, p, a, w, jnp.bfloat16))
    if meta:
        with jax.default_matmul_precision("highest"):
            fc = Forecaster(cfg, SimpleNamespace(params=params), coords, backend="xla", coord_mesh=None)
            out["forecast_masks"] = forecast_masks(cfg, coords.shape[0])
            out["forecast"] = np.asarray(fc.forecast(f32, num_frames=cfg.dataset.traj_len_train))
    return out


def export_run(run_dir, out, epoch=None, files=EXPORT_FILES) -> Path:
    """Write ``files`` (default all of EXPORT_FILES) of ``run_dir``'s export under ``out``; returns
    ``out``. (An npz file's bytes hold the time it was written; its arrays are the export.)"""
    run_dir, out = Path(run_dir), Path(out)
    unknown = set(files) - set(EXPORT_FILES)
    if unknown:
        raise ValueError(f"unknown export files {sorted(unknown)}; choose from {EXPORT_FILES}")
    cfg_dict, epoch, trainer, state, coords = restore_run(run_dir, epoch)
    record = export_record(run_dir, epoch, cfg_dict)
    out.mkdir(parents=True, exist_ok=True)
    if "config.json" in files:
        (out / "config.json").write_text(json.dumps(record, indent=1) + "\n")
    if "params.npz" in files:
        np.savez(out / "params.npz", **flat_params(state.params))
    if "reference.npz" in files:
        np.savez(out / "reference.npz", **reference_arrays(trainer.cfg, state.params, coords))
    if "opt_state.npz" in files:
        step = record["metrics"].get("step")
        np.savez_compressed(out / "opt_state.npz", **flat_opt_state(state), rng=np.asarray(state.rng),
                            **({} if step is None else {"step": np.asarray(step, dtype=np.int64)}))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir", help="a training run's log directory (holds checkpoints/ and metrics.jsonl)")
    ap.add_argument("--out", required=True, help="where to write the export (for example weights/<run>)")
    ap.add_argument("--epoch", type=int, default=None, help="the checkpoint's epoch (default the latest)")
    ap.add_argument("--only", nargs="+", choices=EXPORT_FILES, default=EXPORT_FILES,
                    help="write these files alone (default all)")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    out = export_run(args.run_dir, args.out, args.epoch, files=args.only)
    for f in sorted(out.iterdir()):
        print(f"{f} {f.stat().st_size} B")


if __name__ == "__main__":
    main()
