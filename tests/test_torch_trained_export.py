"""The repo's four trained JAX runs, exported as numpy files and served by the port, on the CPU.

``weights/<run>/`` holds what ``tools/export_jax_checkpoint.py`` wrote from
``results/ckpt/<run>`` (``config.json``, ``params.npz``, ``reference.npz``: JAX's outputs for
seeded inputs). Here, for each of ``ns8192_s0`` (Navier-Stokes), ``diff_plane_full_s0``
(``diffusion_plane``), ``ihc_full_s0`` (``ihc``) and ``sw_full_s1`` (``shallow_water_low_res``):

- the run's orbax checkpoint, restored afresh, gives the committed ``params.npz``'s arrays bit for
  bit, the same ``config.json`` and the reference's grid (skipped, with the reason, where the
  checkout lacks the checkpoint: ``.gitattributes`` leaves three out of ``git archive`` exports);
- the files load with numpy alone (``allow_pickle=False``);
- the committed reference's latents are the tool's seeded draws from the committed latent init,
  its grid is the registry's, and JAX's XLA decode of them under the committed weights, run live
  here, gives the committed ``decode_f32`` within rel-L2 DECODE_TOL (at Navier-Stokes every
  array of ``reference.npz`` is made again live, the bf16 decode and the forecast too);
- ``Forecaster.from_jax_export(device="cpu")`` decodes the reference latents to that live JAX
  decode within rel-L2 DECODE_TOL, eagerly and through the kernel backend (its plain version on
  CPU tensors);
- its ``xla`` forecast of the two reference fields (JAX's inner-loop masks) matches JAX's within
  rel-L2 FORECAST_TOL, at about FORECAST_POINTS of the grid's points;
- a ``params.npz`` with a leaf removed or one leaf too many is refused with a ``KeyError`` naming
  the leaf;
- an autodecoding run's state (no ``meta_sgd_lrs``; the repo holds no such checkpoint) exports
  and loads strictly into the port's ``AutodecodingTrainer``.
"""

import json
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import Config as JaxConfig
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.data import planar_coords as jax_planar_coords
from enf_pde_tpu.data.registry import dataset_spec as jax_dataset_spec
from enf_pde_tpu.train.autodecode import AutodecodingTrainer as JaxAutodecodingTrainer
from enf_pde_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager

from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.convert import load_jax_export, nest
from enf_pde_tpu_torch.inference import Forecaster
from enf_pde_tpu_torch.models.decoder import decode_trajectories
from enf_pde_tpu_torch.train.autodecode import AutodecodingTrainer
from tools.export_jax_checkpoint import (export_record, export_run, flat_params, jax_decode, reference_arrays,
                                         reference_latents, restore_run)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS, CKPT = ROOT / "weights", ROOT / "results" / "ckpt"
RUNS = ("ns8192_s0", "diff_plane_full_s0", "ihc_full_s0", "sw_full_s1")
# JAX's decode made again here gave the committed decode_f32 bit for bit at all four runs.
DECODE_TOL = 1e-5
# The forecast: the inner SGD steps, the ODE's Euler steps and the decode compound the two
# frameworks' f32 sum orders (the fit's gradients cross RFF ReLU kinks). Measured on the CPU:
# 8.4e-7 (ns8192_s0), 2.1e-6 (diff_plane_full_s0), 5.1e-6 (sw_full_s1), 1.1e-6 (ihc_full_s0),
# a margin of about 200 at the worst.
FORECAST_TOL = 1e-3
FORECAST_POINTS = 1024


def rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64).ravel(), np.asarray(b, dtype=np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def npz(path) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module", params=RUNS)
def served(request):
    run = request.param
    return run, Forecaster.from_jax_export(WEIGHTS / run, device="cpu", backend="xla"), npz(WEIGHTS / run / "reference.npz")


def jax_run(run):
    """(JAX config, ``state.params``) of the committed export: the tree of ``params.npz``."""
    record = json.loads((WEIGHTS / run / "config.json").read_text())
    return JaxConfig(record["config"]), nest({k: jnp.asarray(v) for k, v in npz(WEIGHTS / run / "params.npz").items()})


@pytest.mark.parametrize("run", RUNS)
def test_fresh_export_rebuilds_the_committed_files(run):
    if not (CKPT / run / "checkpoints").is_dir():
        pytest.skip(f"results/ckpt/{run} is not in this checkout (.gitattributes leaves it out of `git archive`)")
    cfg_dict, epoch, _, state, coords = restore_run(CKPT / run)
    want, got = npz(WEIGHTS / run / "params.npz"), flat_params(state.params)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == np.float32 and np.array_equal(got[key], arr), key
    record = json.loads(json.dumps(export_record(CKPT / run, epoch, cfg_dict)))
    assert record == json.loads((WEIGHTS / run / "config.json").read_text())
    assert np.array_equal(coords, npz(WEIGHTS / run / "reference.npz")["coords"])


def test_committed_reference_is_jaxs_again_at_navier_stokes():
    """Every array of ``ns8192_s0``'s ``reference.npz`` made again by JAX from the committed
    parameters: its inputs bit for bit, its outputs (decodes, forecast) to JAX's own rounding."""
    run = "ns8192_s0"
    cfg, params = jax_run(run)
    want = npz(WEIGHTS / run / "reference.npz")
    got = reference_arrays(cfg, params, want["coords"])
    assert sorted(got) == sorted(want)
    for key in ("coords", "p", "a", "window", "forecast_masks"):
        assert np.array_equal(got[key], want[key]), key
    for key in ("decode_f32", "decode_bf16", "forecast"):
        assert rel(got[key], want[key]) <= DECODE_TOL, key


@pytest.mark.parametrize("run", RUNS)
def test_export_loads_with_numpy_alone(run):
    record = json.loads((WEIGHTS / run / "config.json").read_text())
    assert set(record) == {"run", "epoch", "config", "metrics"} and record["run"] == run
    assert record["metrics"]["epoch"] == record["epoch"] and "val_mse_in_t" in record["metrics"]
    params, ref = npz(WEIGHTS / run / "params.npz"), npz(WEIGHTS / run / "reference.npz")
    assert all(v.dtype == np.float32 for v in params.values())
    assert {k.split("/")[0] for k in params} == {"nef", "ode", "autodecoder", "meta_sgd_lrs"}
    n = ref["coords"].shape[0]
    assert ref["decode_f32"].shape == ref["decode_bf16"].shape == (2, n, record["config"]["nef"]["num_out"])
    assert ref["forecast"].shape == (2, record["config"]["dataset"]["traj_len_train"], *ref["decode_f32"].shape[1:])
    assert (WEIGHTS / run / "reference.npz").stat().st_size < 4 << 20


def test_trained_decode_matches_jax(served):
    """The port's decode held to JAX's, run live on the committed inputs: the reference's latents
    (the tool's seeded draws from the committed latent init) and grid (the registry's)."""
    run, fc, ref = served
    cfg, params = jax_run(run)
    for key, arr in zip(("p", "a", "window"), reference_latents(params["autodecoder"], meta=True)):
        assert np.array_equal(ref[key], arr), key
    assert np.array_equal(ref["coords"], np.asarray(jax_dataset_spec(cfg.dataset.name, cfg.dataset).coords))
    want = jax_decode(cfg, params["nef"], ref["coords"], ref["p"], ref["a"], ref["window"])
    assert np.abs(want).max() > 0 and rel(ref["decode_bf16"], want) > 0  # the trained field, two JAX modes
    assert rel(ref["decode_f32"], want) <= DECODE_TOL, run
    dec = fc.trainer.decoder
    traj = tuple(torch.from_numpy(ref[k])[:, None] for k in ("p", "a", "window"))
    with torch.no_grad():
        for backend in ("eager", "kernel"):
            got = decode_trajectories(dec, backend, fc.trainer.coords, traj, fc.cfg.training.max_num_sampled_points)
            assert got.shape == (2, 1, *want.shape[1:])
            assert rel(got[:, 0], want) <= DECODE_TOL, (run, backend)


def test_trained_forecast_matches_jax(served):
    """The whole forecast (the fit on every point of the two fields, the rollout), decoded at
    FORECAST_POINTS of the grid's points (evenly strided): the CPU's eager decode of every point
    of ``ihc``'s 48 x 24 x 24 grid takes 90 s, and each point's decode is independent."""
    run, fc, ref = served
    n = ref["coords"].shape[0]
    sel = np.arange(0, n, -(-n // FORECAST_POINTS))
    want = ref["forecast"][:, :, sel]
    got = fc.forecast(ref["decode_f32"], num_frames=want.shape[1], coords=ref["coords"][sel],
                      masks=ref["forecast_masks"])
    assert got.shape == want.shape
    assert np.abs(want[:, -1] - want[:, 0]).max() > 1e-3 * np.abs(want).max()  # the rollout moved the field
    assert rel(got, want) <= FORECAST_TOL, run


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("change", ["missing", "unexpected", "missing_latent"])
def test_export_with_a_leaf_too_few_or_too_many_is_refused(run, change, tmp_path):
    """The leaf is named as the port names it: its group and its ``state_dict`` key or latent."""
    shutil.copy(WEIGHTS / run / "config.json", tmp_path / "config.json")
    params = npz(WEIGHTS / run / "params.npz")
    if change == "missing":
        key = sorted(k for k in params if k.startswith("nef/") and k.endswith("/bias"))[-1]
        del params[key]
        name = "missing nef leaf " + ".".join(key.split("/")[2:])
    elif change == "unexpected":
        params["ode/params/Dense_9/bias"] = np.zeros(4, np.float32)
        name = "unexpected ode leaf Dense_9.bias"
    else:
        del params["autodecoder/gaussian_window"]
        name = "missing autodecoder leaf gaussian_window"
    np.savez(tmp_path / "params.npz", **params)
    with pytest.raises(KeyError, match=re.escape(name)):
        load_jax_export(tmp_path)


def test_autodecoding_state_exports_and_loads_strictly(tmp_path):
    overrides = ["nef.num_hidden=16", "node.num_hidden=16", "node.basis_dim=8", "node.num_layers=1",
                 "dataset.num_signals_train=4", "training.max_num_sampled_points=256"]
    jcfg = jax_load_config("navier_stokes_nonmaml", overrides)
    jtr = JaxAutodecodingTrainer(jcfg, *jax_build_models(jcfg), jax_planar_coords(64, 64), seed=0)
    state = jtr.init_state()
    run = tmp_path / "nonmaml"
    mgr = JaxCheckpointManager(str(run), every_n_epochs=1)
    mgr.save(1, state, jcfg.to_dict())
    mgr.wait()
    mgr.close()
    (run / "metrics.jsonl").write_text(json.dumps({"epoch": 1, "val_mse_in_t": 0.5, "val_mse_out_t": 0.7}) + "\n")
    out = export_run(run, tmp_path / "export")
    cfg, params, record = load_jax_export(out)
    assert params["meta_sgd_lrs"] is None and record["epoch"] == 1
    assert params["autodecoder"]["a"].shape == (4, jcfg.nef.num_latents, jcfg.nef.latent_dim)
    tr = AutodecodingTrainer(cfg, *build_models(cfg), jax_planar_coords(64, 64), device="cpu")
    tr.load_state(params)  # strict: every module's leaf, none left over
    ref = npz(out / "reference.npz")
    assert "forecast" not in ref and np.array_equal(ref["a"], np.asarray(state.params["autodecoder"]["a"])[:2])
    traj = tuple(torch.from_numpy(ref[k])[:, None] for k in ("p", "a", "window"))
    with torch.no_grad():
        got = decode_trajectories(tr.decoder, "eager", torch.from_numpy(ref["coords"]), traj, 256)
    assert rel(got[:, 0], ref["decode_f32"]) <= DECODE_TOL
    with pytest.raises(ValueError, match="autodecoding"):
        Forecaster.from_jax_export(out, device="cpu")
