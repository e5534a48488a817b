"""The port's planar datasets, configs and CLI runs (``diffusion_plane``, ``cahn_hilliard``).

Against the JAX package on the CPU: the configs equal the YAMLs; the heat-kernel
trajectories equal JAX's for the same seeds (rel-L2 1e-5: the sources are drawn with
the same numpy ``RandomState``); the orthonormal DCT-II matrix equals
``jax.scipy.fft.dctn`` (atol 1e-6); the Cahn-Hilliard solver's first 100 steps from one
numpy initial field equal JAX's (rel-L2 1e-5; a whole trajectory diverges at any
rounding, spinodal decomposition amplifies it), and over 8,000 steps it conserves the
mean of c (atol 1e-5) and separates towards |c| = 1. Then the registry's specs, and the
``fit`` CLI training each config for 3 epochs (nef, dual, ode) at a small width on the
CPU, with validation, the rotation and translation equivariance check and a rollout
figure.
"""

import json
import os

import jax.numpy as jnp
import jax.scipy.fft as jfft
import numpy as np
import pytest
import torch

from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.data.cache import test_seed as jax_test_seed
from enf_pde_tpu.data.cahn_hilliard import cahn_hilliard_rollout as jax_ch_rollout
from enf_pde_tpu.data.diffusion_plane import generate_diffusion_trajectories as jax_diffusion
from enf_pde_tpu.data.diffusion_plane import sample_source as jax_sample_source
from enf_pde_tpu.data.registry import dataset_spec as jax_dataset_spec

from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.data import cahn_hilliard as tch
from enf_pde_tpu_torch.data import diffusion_plane as tdp
from enf_pde_tpu_torch.data.cache import TrajectoryCache
from enf_pde_tpu_torch.data.registry import dataset_spec
from enf_pde_tpu_torch.experiments.fit import main as fit_main

torch.set_num_threads(1)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", ["diffusion_plane", "cahn_hilliard"])
def test_planar_configs_equal_yaml(name):
    assert load_experiment_config(name).to_dict() == jax_load_config(name).to_dict()


# ----------------------------------------------------------------- diffusion_plane


@pytest.mark.parametrize("test", [False, True])
def test_diffusion_trajectories_match_jax(test):
    seeds = [0, 5, jax_test_seed(3)]
    for s in seeds:
        assert tdp.sample_source(s, test) == jax_sample_source(s, test)
    got = tdp.generate_diffusion_trajectories(seeds, test=test, device="cpu")
    want = jax_diffusion(np.asarray(seeds), test=test)
    assert got.shape == want.shape == (3, 20, 64, 64, 1) and got.dtype == np.float32
    for g, w in zip(got, want):  # each whole trajectory
        assert rel_l2(g, w) <= 1e-5
    # Heat is conserved in the domain (first-order images; the JAX test's 1 %).
    mass = got[..., 0].sum(axis=(2, 3)) * (6.0 / 64) ** 2
    values = [tdp.sample_source(s, test)[2] for s in seeds]
    np.testing.assert_allclose(mass, np.broadcast_to(np.asarray(values)[:, None], mass.shape), rtol=1e-2)


# ----------------------------------------------------------------- cahn_hilliard


def test_dct_matrix_matches_jax_dctn():
    x = np.random.default_rng(0).standard_normal((3, 64, 64)).astype(np.float32)
    M = tch.dct_matrix(64)
    got = M @ torch.from_numpy(x) @ M.T
    np.testing.assert_allclose(got.numpy(), np.asarray(jfft.dctn(x, type=2, axes=(-2, -1), norm="ortho")),
                               atol=1e-6)
    back = M.T @ got @ M
    np.testing.assert_allclose(back.numpy(), np.asarray(jfft.idctn(got.numpy(), type=2, axes=(-2, -1),
                                                                    norm="ortho")), atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def test_cahn_hilliard_first_steps_match_jax():
    c0 = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64)).astype(np.float32)
    want = np.asarray(jax_ch_rollout(jnp.asarray(c0), 1e-2, record_steps=5, steps_per_record=25))
    got = tch.cahn_hilliard_rollout(torch.from_numpy(c0), 1e-2, record_steps=5, steps_per_record=25)
    assert got.shape == (2, 5, 64, 64)
    for k in range(5):  # steps 0, 25, 50, 75, 100
        assert rel_l2(got[:, k], want[:, k]) <= 1e-5, k


def test_cahn_hilliard_conserves_mass_and_coarsens():
    c0 = tch.initial_fields([0, 1], size=32, device="cpu")
    snaps = tch.cahn_hilliard_rollout(c0, 1e-2, record_steps=5, steps_per_record=2000).numpy()
    means = snaps.mean(axis=(2, 3))
    np.testing.assert_allclose(means, np.broadcast_to(means[:, :1], means.shape), atol=1e-5)
    # Phase separation: |c| grows towards the wells at +-1 (the bulk reaches them; the
    # interfaces of a 32^2 field still hold a large share of the points).
    mag = np.abs(snaps).mean(axis=(0, 2, 3))
    assert np.all(np.diff(mag) > 0) and mag[0] < 0.55
    assert np.median(np.abs(snaps[:, -1])) > 0.8 and np.abs(snaps).max() < 1.5


def test_cahn_hilliard_initial_fields_are_seeded_and_generation_composes():
    a, b = tch.initial_fields([3, 4], device="cpu"), tch.initial_fields([4], device="cpu")
    assert torch.equal(a[1:], b) and float(a.min()) >= -1 and float(a.max()) <= 1
    assert abs(float(a.mean())) < 0.05
    traj = tch.generate_ch_trajectories([3, 4], frame_dt=0.05, num_frames=4, skip_frames=2, device="cpu")
    want = tch.cahn_hilliard_rollout(a, 1e-2, record_steps=6, steps_per_record=5)[:, 2:]
    assert traj.shape == (2, 4, 64, 64, 1) and traj.dtype == np.float32
    np.testing.assert_array_equal(traj[..., 0], want.numpy())


# ----------------------------------------------------------------- registry


def test_registry_planar_specs_match_jax(monkeypatch):
    seen = []

    def recorder(kind):
        def gen(ids, test=False, device=None):
            seen.append((kind, [int(i) for i in ids], test, device))
            return np.zeros((len(ids), 1))
        return gen

    monkeypatch.setattr(tdp, "generate_diffusion_trajectories", recorder("diffusion"))
    monkeypatch.setattr(tch, "generate_ch_trajectories", recorder("ch"))
    for name, kind in (("diffusion_plane", "diffusion"), ("cahn_hilliard", "ch")):
        spec, jspec = dataset_spec(name, device="cpu"), jax_dataset_spec(name)
        assert (spec.n_frames_train, spec.batch_size_gen, spec.cache_name) == (
            jspec.n_frames_train, jspec.batch_size_gen, jspec.cache_name)
        np.testing.assert_array_equal(spec.coords, planar_coords(64, 64))
        np.testing.assert_array_equal(spec.coords, jspec.coords)
        spec.gen_train(np.arange(2))
        spec.gen_test(np.arange(2))
        assert seen[-2:] == [(kind, [0, 1], False, "cpu"),
                             (kind, [jax_test_seed(0), jax_test_seed(1)], kind == "diffusion", "cpu")]
    assert [dataset_spec(n).batch_size_gen for n in ("diffusion_plane", "cahn_hilliard")] == [32, 8]


# ----------------------------------------------------------------- the CLI, 3 epochs on the CPU


SMALL = {
    "nef.num_hidden": 16,
    "node.num_hidden": 16,
    "node.basis_dim": 8,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "training.max_num_sampled_points": 256,
    "dataset.traj_len_train": 3,
    "dataset.traj_len_out_horizon": 2,
    "dataset.batch_size": 2,
    "dataset.num_signals_train": 4,
    "dataset.num_signals_test": 2,
    "training.nef.fit_on_num_steps": 2,
    # epoch 1 nef, 2 dual, 3 ode
    "training.num_epochs": 3,
    "training.nef.train_until_epoch": 2,
    "training.ode.train_from_epoch": 1,
    "training.ode.train_until_epoch": 3,
    "test.test_interval": 3,
    "test.test_dp_interval": 3,
    "test.test_equiv_at_epoch": 0,
    "logging.log_every_n_steps": 1,
    "logging.checkpoint_every_n_epochs": 1,
    "logging.visualize_every_n_epochs": 3,  # the figure draws each latent's orientation
}


@pytest.mark.parametrize("name", ["diffusion_plane", "cahn_hilliard"])
def test_fit_cli_trains_three_epochs_on_cpu(tmp_path, name):
    data_dir, log_dir = tmp_path / "data", tmp_path / "run"
    if name == "cahn_hilliard":  # short solver runs (5 steps a record) in place of 60,000 steps
        for group, ids in (("train", range(4)), ("test", [jax_test_seed(i) for i in range(2)])):
            cache = TrajectoryCache(os.path.join(data_dir, name, group), None)
            trajs = tch.generate_ch_trajectories(list(ids), frame_dt=0.05, device="cpu")
            for i, traj in enumerate(trajs):
                cache.write(i, traj)
    # diffusion_plane generates its blocks of 32 (analytic) on the CPU.
    over = [f"{k}={v}" for k, v in SMALL.items()]
    fit_main([name, *over, f"dataset.path={data_dir}", f"logging.log_dir={log_dir}", "--device", "cpu"])
    records = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in records if "phase" in r] == ["nef", "nef+ode", "ode"]
    eqv = next(r for r in records if "equivariance_err_translation" in r)
    # SE(2): both errors at f32 rounding (the decoder is equivariant by construction).
    assert set(k for k in eqv if k.startswith("equivariance")) == {
        "equivariance_err_translation", "equivariance_err_rotation"}
    assert eqv["equivariance_err_translation"] < 1e-4 and eqv["equivariance_err_rotation"] < 1e-4
    val = next(r for r in records if "val_mse_in_t" in r)
    assert val["val_mse_out_t"] > 0  # the out horizon is scored
    assert any("val_mse_in_t_dp5" in r for r in records)
    assert all(np.isfinite(v) for r in records for k, v in r.items() if "mse" in k or "err" in k)
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["3"]  # keep_n_checkpoints: 1
    assert os.listdir(log_dir / "figures") == ["rollout_epoch00003.png"]
    npz = [f for f in os.listdir(data_dir / name / "train") if f.endswith(".npz")]
    assert len(npz) == (32 if name == "diffusion_plane" else 4)  # one block of 32 generated
