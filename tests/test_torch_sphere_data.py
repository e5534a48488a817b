"""The port's sphere data, config and CLI run (``diff_sphere``) against the JAX package, on the CPU.

The config equals the YAML; ``legendre_table`` equals JAX's; ``SphereGrid``'s nodes and
weights equal JAX's, and its analysis, synthesis, theta-derivative tables, longitude
derivative, low-pass filter and exact diffusion agree with JAX's at 32 x 16 and 128 x 64
(rel-L2 1e-5: f32 tables and FFTs on both sides, sums in other orders); the heat-equation
trajectories equal JAX's for the same seeds (rel-L2 1e-5: the bump centres come from the
same numpy ``RandomState``) and conserve the area-weighted mean; the registry's spec
(coordinates, frames, solver batch, test seeds) equals JAX's; and the ``fit`` CLI trains
``diff_sphere`` for 3 epochs (nef, dual, ode) at a few latents on the CPU, with validation,
the sphere equivariance check (longitude and rotation) and a rollout figure.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.data import angular_coords as jax_angular_coords
from enf_pde_tpu.data.cache import test_seed as jax_test_seed
from enf_pde_tpu.data.diffusion_sphere import generate_sphere_diffusion_trajectories as jax_generate
from enf_pde_tpu.data.registry import dataset_spec as jax_dataset_spec
from enf_pde_tpu.data.sphere_harmonics import SphereGrid as JaxGrid
from enf_pde_tpu.data.sphere_harmonics import legendre_table as jax_legendre_table

from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.data import angular_coords
from enf_pde_tpu_torch.data import diffusion_sphere as tds
from enf_pde_tpu_torch.data.registry import DATASET_NAMES, dataset_spec
from enf_pde_tpu_torch.data.sphere_harmonics import SphereGrid, legendre_table
from enf_pde_tpu_torch.experiments.fit import main as fit_main

torch.set_num_threads(1)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def test_diff_sphere_config_equals_yaml():
    assert load_experiment_config("diff_sphere").to_dict() == jax_load_config("diff_sphere").to_dict()


# ----------------------------------------------------------------- harmonics


def test_legendre_table_matches_jax():
    x = np.cos(np.linspace(0.1, 3.0, 11))
    got, want = legendre_table(12, x), jax_legendre_table(12, x)
    assert got.dtype == np.float64 and got.shape == (13, 13, 11)
    assert rel_l2(got, want) <= 1e-5
    np.testing.assert_array_equal(got, want)  # the same float64 recurrences


@pytest.mark.parametrize("nphi,ntheta", [(32, 16), (128, 64)])
def test_sphere_grid_matches_jax(nphi, ntheta):
    g, jg = SphereGrid(nphi, ntheta, device="cpu"), JaxGrid(nphi, ntheta)
    assert (g.lmax, g.mmax) == (jg.lmax, jg.mmax)
    for name in ("x", "w", "theta", "phi"):
        np.testing.assert_array_equal(getattr(g, name), getattr(jg, name))
    for name in ("_P", "_Pw", "_H", "sin_theta", "laplacian_eig"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(jg, name)))
    f = np.random.default_rng(nphi).standard_normal((3, nphi, ntheta)).astype(np.float32)
    tf, jf = torch.from_numpy(f), jnp.asarray(f)
    flm, jflm = g.analysis(tf), jg.analysis(jf)
    assert flm.dtype == torch.complex64 and flm.shape == (3, g.lmax + 1, g.mmax + 1)
    checks = {
        "analysis": (flm, jflm),
        "synthesis": (g.synthesis(flm), jg.synthesis(jflm)),
        "synthesis_dtheta": (g.synthesis_dtheta(flm), jg.synthesis_dtheta(jflm)),
        "analysis_dtheta_flux": (g.analysis_dtheta_flux(tf), jg.analysis_dtheta_flux(jf)),
        "dphi_coeffs": (g.dphi_coeffs(flm), jg.dphi_coeffs(jflm)),
        "filter_lowpass": (g.filter_lowpass(tf, 5), jg.filter_lowpass(jf, 5)),
        "diffuse": (g.diffuse(tf, 0.01, [0.0, 0.5, 5.5]), jg.diffuse(jf, 0.01, jnp.asarray([0.0, 0.5, 5.5]))),
    }
    for name, (got, want) in checks.items():
        assert tuple(got.shape) == want.shape, name
        assert rel_l2(got.numpy(), want) <= 1e-5, name


def test_sphere_harmonics_are_exact_for_band_limited_fields():
    """Synthesis then analysis returns valid coefficients (l >= m, real at m = 0), and
    the constant field is sqrt(4 pi) Y_00."""
    g = SphereGrid(32, 16, device="cpu")
    rng = np.random.default_rng(0)
    L, M = np.arange(g.lmax + 1)[:, None], np.arange(g.mmax + 1)[None, :]
    flm = (rng.standard_normal(L.shape[:1] + M.shape[1:]) + 1j * rng.standard_normal((g.lmax + 1, g.mmax + 1)))
    flm = np.where(L >= M, flm, 0)
    flm[:, 0] = flm[:, 0].real
    flm = torch.from_numpy(flm.astype(np.complex64))
    np.testing.assert_allclose(g.analysis(g.synthesis(flm)).numpy(), flm.numpy(), atol=1e-4)
    const = g.analysis(torch.ones(32, 16))
    np.testing.assert_allclose(float(const[0, 0].real), np.sqrt(4 * np.pi), rtol=1e-5)


# ----------------------------------------------------------------- trajectories


def test_sphere_diffusion_trajectories_match_jax():
    seeds = [0, 5, jax_test_seed(3)]
    got = tds.generate_sphere_diffusion_trajectories(seeds, device="cpu")
    want = jax_generate(np.asarray(seeds))
    assert got.shape == want.shape == (3, 20, 128, 64, 1) and got.dtype == np.float32
    for g, w in zip(got, want):  # each whole trajectory
        assert rel_l2(g, w) <= 1e-5
    np.testing.assert_array_equal(tds.reference_frame_times()[:3], [0.0, 0.5, 5.5])
    # The heat equation conserves the area-weighted mean (Gauss-Legendre weights in theta).
    w = SphereGrid(128, 64, device="cpu").w
    means = (got[..., 0] * w).sum(axis=-1).mean(axis=-1) / 2
    np.testing.assert_allclose(means, np.broadcast_to(means[:, :1], means.shape), atol=1e-5)
    peaks = got[..., 0].max(axis=(2, 3))
    assert np.all(np.diff(peaks[:, 1:], axis=1) < 0)  # the bump flattens


def test_generation_is_per_seed_and_batches_compose():
    a = tds.generate_sphere_diffusion_trajectories([7, 8], nphi=16, ntheta=8, num_frames=4, device="cpu")
    b = tds.generate_sphere_diffusion_trajectories([8], nphi=16, ntheta=8, num_frames=4, device="cpu")
    assert a.shape == (2, 4, 16, 8, 1)
    np.testing.assert_allclose(a[1:], b, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------- registry


def test_registry_diff_sphere_spec_matches_jax(monkeypatch):
    seen = []

    def recorder(ids, grid=None):
        seen.append(([int(i) for i in ids], grid.nphi, grid.ntheta, str(grid.device)))
        return np.zeros((len(ids), 1))

    monkeypatch.setattr(tds, "generate_sphere_diffusion_trajectories", recorder)
    spec, jspec = dataset_spec("diff_sphere", device="cpu"), jax_dataset_spec("diff_sphere")
    assert DATASET_NAMES.index("diff_sphere") == 4
    assert (spec.n_frames_train, spec.batch_size_gen, spec.cache_name) == (
        jspec.n_frames_train, jspec.batch_size_gen, jspec.cache_name) == (20, 16, "diff_sphere")
    assert spec.coords.shape == (128 * 64, 2) and spec.coords.dtype == np.float32
    np.testing.assert_array_equal(spec.coords, jspec.coords)
    grid = SphereGrid(128, 64, device="cpu")
    np.testing.assert_array_equal(angular_coords(grid.phi, grid.theta), jax_angular_coords(grid.phi, grid.theta))
    spec.gen_train(np.arange(2))
    spec.gen_test(np.arange(2))
    assert seen == [([0, 1], 128, 64, "cpu"), ([jax_test_seed(0), jax_test_seed(1)], 128, 64, "cpu")]
    traj = np.arange(6.0).reshape(1, 6)
    np.testing.assert_array_equal(spec.postprocess(traj), jspec.postprocess(traj))


# ----------------------------------------------------------------- the CLI, 3 epochs on the CPU


SMALL = {
    "nef.num_latents": 8,
    "node.num_hidden": 16,
    "node.basis_dim": 8,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "training.max_num_sampled_points": 256,
    "dataset.traj_len_train": 3,
    "dataset.traj_len_out_horizon": 2,
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
    "logging.visualize_every_n_epochs": 3,
}


def test_fit_cli_trains_diff_sphere_three_epochs_on_cpu(tmp_path):
    data_dir, log_dir = tmp_path / "data", tmp_path / "run"
    over = [f"{k}={v}" for k, v in SMALL.items()]
    fit_main(["diff_sphere", *over, f"dataset.path={data_dir}", f"logging.log_dir={log_dir}", "--device", "cpu"])
    records = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in records if "phase" in r] == ["nef", "nef+ode", "ode"]
    eqv = next(r for r in records if "equivariance_err_longitude" in r)
    # SO(3): the longitude shift and a generic rotation, both at f32 rounding.
    assert set(k for k in eqv if k.startswith("equivariance")) == {
        "equivariance_err_longitude", "equivariance_err_rotation"}
    assert eqv["equivariance_err_longitude"] < 1e-4 and eqv["equivariance_err_rotation"] < 1e-4
    val = next(r for r in records if "val_mse_in_t" in r)
    assert val["val_mse_out_t"] > 0
    assert any("val_mse_in_t_dp5" in r for r in records)
    assert all(np.isfinite(v) for r in records for k, v in r.items() if "mse" in k or "err" in k)
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["3"]  # keep_n_checkpoints: 1
    assert os.listdir(log_dir / "figures") == ["rollout_epoch00003.png"]
    npz = [f for f in os.listdir(data_dir / "diff_sphere" / "train") if f.endswith(".npz")]
    assert len(npz) == 16  # one block of 16 generated (batch_size_gen)
