"""The port's shallow-water data, config and CLI run against the JAX package, on the CPU.

The config equals the YAML; the solver's tables equal JAX's; its operators
(``velocities``, ``div``, ``curl_r``, ``tendencies_nonlinear``, ``linear_propagator``)
agree with JAX's at ``SphereGrid(48, 24, lmax=16)``, the reduced size of the JAX
package's own tests, and satisfy JAX's Helmholtz identities; ``galewsky_state`` agrees
(rel-L2 1e-6: the same numpy draws and float64 profile, f32 transforms); a 2-record x
10-step rollout agrees (rel-L2 1e-5 over the trajectory, h and the velocity field; the
meridional velocity alone 1e-4: a 1e-7 nudge of the state moves it by more than 5e-6 in
JAX's own solver); a batched block agrees
with its seeds run one at a time; the 2 x 2 pool and both registry specs equal JAX's; and
the ``fit`` CLI trains ``shallow_water_low_res`` for 3 epochs on the CPU and ends with the
super-resolution eval, on cheap seeded fields of the true shape (3,000 solver steps at
192 x 96 a trajectory are too slow here).
"""

import json

import numpy as np
import pytest
import torch

from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.data.cache import test_seed as jax_test_seed
from enf_pde_tpu.data.registry import dataset_spec as jax_dataset_spec
from enf_pde_tpu.data import shallow_water as jsw
from enf_pde_tpu.data.sphere_harmonics import SphereGrid as JaxGrid

from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.data import shallow_water as tsw
from enf_pde_tpu_torch.data.registry import DATASET_NAMES, dataset_spec
from enf_pde_tpu_torch.data.sphere_harmonics import SphereGrid
from enf_pde_tpu_torch.experiments.fit import main as fit_main

torch.set_num_threads(1)

DT = tsw.SWUnits.timestep / 3  # the generation step, 400 s


def rel_l2(a, b) -> float:
    """rel-L2 of real or complex arrays, in double precision."""
    a, b = np.asarray(a), np.asarray(b)
    dtype = np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b) else np.float64
    a, b = a.astype(dtype), b.astype(dtype)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


@pytest.fixture(scope="module")
def solvers():
    """(port solver, JAX solver) at the JAX package's reduced test size."""
    return (tsw.ShallowWaterSolver(SphereGrid(48, 24, lmax=16, device="cpu")),
            jsw.ShallowWaterSolver(JaxGrid(48, 24, lmax=16)))


def random_coeffs(grid, seed: int, lcut: int = 10):
    """Band-limited SH coefficients (1 <= l <= lcut, l >= m, real at m = 0), complex64."""
    rng = np.random.default_rng(seed)
    L, M = np.arange(grid.lmax + 1)[:, None], np.arange(grid.mmax + 1)[None, :]
    flm = rng.standard_normal((grid.lmax + 1, grid.mmax + 1)) + 1j * rng.standard_normal((grid.lmax + 1, grid.mmax + 1))
    flm = np.where((L >= M) & (L >= 1) & (L <= lcut), flm, 0)
    flm[:, 0] = flm[:, 0].real
    return flm.astype(np.complex64)


def test_shallow_water_config_equals_yaml():
    assert load_experiment_config("shallow_water").to_dict() == jax_load_config("shallow_water").to_dict()


# ----------------------------------------------------------------- the solver


def test_solver_tables_equal_jax(solvers):
    port, jax_solver = solvers
    for name in ("lap", "lap_inv", "f_grid", "inv_sin", "valid"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(jax_solver, name)), name)
    assert [getattr(tsw.SWUnits, k) for k in vars(jsw.SWUnits) if not k.startswith("_")] == [
        getattr(jsw.SWUnits, k) for k in vars(jsw.SWUnits) if not k.startswith("_")]


def test_operators_match_jax(solvers):
    """velocities, div, curl_r and the nonlinear tendencies of a random band-limited state,
    and the linear propagator: rel-L2 1e-5 (f32 transforms on both sides, sums in other
    orders; the propagator's cos and sin from two libraries)."""
    port, jax_solver = solvers
    g = port.grid
    zeta, delta, h = (random_coeffs(g, s) for s in (1, 2, 3))
    h = h * np.float32(1e-3)  # heights are O(1e-3) of the radius, as in the data
    tz, td, th = (torch.from_numpy(v) for v in (zeta, delta, h))
    checks = {
        "velocities": (port.velocities(tz, td), jax_solver.velocities(zeta, delta)),
        "div": ((port.div(*port.velocities(tz, td)),), (jax_solver.div(*jax_solver.velocities(zeta, delta)),)),
        "curl_r": ((port.curl_r(*port.velocities(tz, td)),), (jax_solver.curl_r(*jax_solver.velocities(zeta, delta)),)),
        "tendencies_nonlinear": (port.tendencies_nonlinear((tz, td, th)),
                                 jax_solver.tendencies_nonlinear((zeta, delta, h))),
        "linear_propagator": (port.linear_propagator(0.5 * DT), jax_solver.linear_propagator(0.5 * DT)),
    }
    for name, (got, want) in checks.items():
        assert len(got) == len(want), name
        for i, (a, b) in enumerate(zip(got, want)):
            assert tuple(a.shape) == b.shape, (name, i)
            assert rel_l2(a.numpy(), b) <= 1e-5, (name, i, rel_l2(a.numpy(), b))


def test_helmholtz_identities_and_propagator(solvers):
    """JAX's own checks (``tests/test_data_sw_ihc.py``): div of the potential flow of chi
    is lap chi, its curl is 0; curl of the rotational flow of psi is lap psi, its div is 0
    (atol 2e-3); ``det exp(tM) = cos^2 - a12 a21 = 1``."""
    port, _ = solvers
    flm = torch.from_numpy(random_coeffs(port.grid, 4))
    lap_flm = flm * port.lap
    uph, uth = port.velocities(torch.zeros_like(flm), lap_flm)
    assert float((port.div(uph, uth) - lap_flm).abs().max()) < 2e-3
    assert float(port.curl_r(uph, uth).abs().max()) < 2e-3
    uph, uth = port.velocities(lap_flm, torch.zeros_like(flm))
    assert float((port.curl_r(uph, uth) - lap_flm).abs().max()) < 2e-3
    assert float(port.div(uph, uth).abs().max()) < 2e-3
    cos, a12, a21 = port.linear_propagator(0.5)
    np.testing.assert_allclose((cos**2 - a12 * a21).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3, jax_test_seed(1)])
def test_galewsky_state_matches_jax(solvers, seed):
    port, jax_solver = solvers
    got = tsw.galewsky_state(port.grid, seed)
    want = jsw.galewsky_state(jax_solver.grid, seed)
    assert all(a.dtype == torch.complex64 and tuple(a.shape) == (17, 17) for a in got)
    assert float(got[1].abs().max()) == 0 and float(np.abs(np.asarray(want[1])).max()) == 0  # no divergence
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        assert rel_l2(a.numpy(), b) <= 1e-6


def test_rollout_matches_jax(solvers):
    """2 records x 10 steps of 400 s from seed 3: the whole trajectory, h and the velocity
    (u_phi, u_theta) within rel-L2 1e-5 of JAX's. The meridional velocity alone is 1/300
    of the zonal jet and the most sensitive to rounding (JAX's own rollout moves it by more
    than 5e-6 in these 10 steps when its state is perturbed by 1e-7, as the next test
    shows), so it is held to 1e-4. Physical magnitudes and mass as JAX's test checks them."""
    port, jax_solver = solvers
    got = port.rollout(tsw.galewsky_state(port.grid, 3), DT, num_records=2, steps_per_record=10)
    want = jax_solver.rollout(jsw.galewsky_state(jax_solver.grid, 3), DT, num_records=2, steps_per_record=10)
    got, want = torch.stack(got, -1).numpy(), np.stack([np.asarray(w) for w in want], -1)
    assert got.shape == want.shape == (2, 48, 24, 3)
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= 1e-5
    assert rel_l2(got[..., 0], want[..., 0]) <= 1e-5
    assert rel_l2(got[..., 1:], want[..., 1:]) <= 1e-5
    assert rel_l2(got[..., 2], want[..., 2]) <= 1e-4
    units = tsw.SWUnits
    assert np.abs(got[..., 1]).max() < 3 * units.umax and np.abs(got[..., 0]).max() < 1e4 * units.meter
    mass = (got[..., 0] * port.grid.w).sum(axis=-1).mean(axis=-1)
    np.testing.assert_allclose(mass, mass[0], atol=1e-10)


def test_meridional_velocity_carries_the_rounding_of_the_state(solvers):
    """Why u_theta alone is held to 1e-4: in JAX's own solver, a state perturbed by 1e-7
    (numpy-seeded, relative) moves u_theta by more than 5e-6 rel-L2 in 10 steps, while h
    and u_phi move by less than 1e-6."""
    _, jax_solver = solvers
    state = jsw.galewsky_state(jax_solver.grid, 3)
    rng = np.random.default_rng(0)
    nudged = tuple(np.asarray(x) * (1 + 1e-7 * rng.standard_normal(x.shape)).astype(np.float32) for x in state)
    base = jax_solver.rollout(state, DT, num_records=1, steps_per_record=10)
    moved = jax_solver.rollout(tuple(nudged), DT, num_records=1, steps_per_record=10)
    rels = [rel_l2(m, b) for m, b in zip(moved, base)]
    assert rels[0] < 1e-6 and rels[1] < 1e-6 and 5e-6 < rels[2] < 1e-4


def test_batched_block_agrees_with_seeds_one_at_a_time():
    """Two seeds in one batched state against each alone (one record of 150 steps): the
    Legendre products are a matrix product for the block and a matrix-vector product for
    one seed, so the sums run in another order and agree to rounding (rel-L2 1e-5 per
    trajectory), not bit for bit."""
    grid = SphereGrid(48, 24, lmax=16, device="cpu")
    block = tsw.generate_sw_trajectories([3, 4], num_frames=1, grid=grid)
    assert block.shape == (2, 1, 48, 24, 3) and block.dtype == np.float32
    for i, seed in enumerate((3, 4)):
        alone = tsw.generate_sw_trajectories([seed], num_frames=1, grid=grid)
        assert rel_l2(block[i], alone[0]) <= 1e-5
    assert rel_l2(block[0], block[1]) > 1e-3  # the seeds differ


def test_avg_pool_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 3)).astype(np.float32)
    got = tsw._avg_pool_2x2(x)
    assert got.shape == (2, 4, 3, 3)
    np.testing.assert_array_equal(got, jsw._avg_pool_2x2(x))
    np.testing.assert_allclose(got[0, 1, 2, 0], x[0, 2:4, 4:6, 0].mean(), rtol=1e-6)


# ----------------------------------------------------------------- registry


@pytest.mark.parametrize("name", ["shallow_water", "shallow_water_low_res"])
def test_registry_shallow_water_specs_match_jax(monkeypatch, name):
    seen = []

    def recorder(ids, grid=None):
        seen.append(([int(i) for i in ids], grid.nphi, grid.ntheta, grid.lmax, str(grid.device)))
        return np.zeros((len(ids), 1))

    monkeypatch.setattr(tsw, "generate_sw_trajectories", recorder)
    monkeypatch.setattr(jsw, "generate_sw_trajectories", lambda ids, grid=None: np.zeros((len(ids), 1)))
    spec, jspec = dataset_spec(name, device="cpu"), jax_dataset_spec(name)
    assert name in DATASET_NAMES
    assert (spec.n_frames_train, spec.batch_size_gen, spec.cache_name) == (
        jspec.n_frames_train, jspec.batch_size_gen, jspec.cache_name) == (None, 4, "shallow_water")
    n = 96 * 48 if name.endswith("low_res") else 192 * 96
    assert spec.coords.shape == (n, 2) and spec.coords.dtype == np.float32
    np.testing.assert_array_equal(spec.coords, jspec.coords)
    spec.gen_train(np.arange(2))
    spec.gen_test(np.arange(2))
    assert seen == [([0, 1], 192, 96, 64, "cpu"), ([jax_test_seed(0), jax_test_seed(1)], 192, 96, 64, "cpu")]
    traj = np.random.default_rng(1).standard_normal((20, 8, 4, 3)).astype(np.float32)
    got = spec.postprocess(traj)
    assert got.shape == ((14, 4, 2, 3) if name.endswith("low_res") else (14, 8, 4, 3))
    np.testing.assert_array_equal(got, jspec.postprocess(traj))


# ----------------------------------------------------------------- the CLI, 3 epochs on the CPU


def cheap_fields(ids, grid=None):
    """Seeded smooth fields of the generator's shape, [n, 20, 192, 96, 3]: a few
    longitude and colatitude harmonics per channel, drifting in time."""
    phi = np.linspace(0, 2 * np.pi, 192, endpoint=False)[:, None]
    theta = np.linspace(0.02, np.pi - 0.02, 96)[None, :]
    out = np.zeros((len(ids), 20, 192, 96, 3), np.float32)
    for n, i in enumerate(ids):
        rng = np.random.default_rng(int(i) % (2**31 - 1))
        for c in range(3):
            for m in range(1, 4):
                amp, ph, om = rng.standard_normal(), rng.uniform(0, 2 * np.pi), rng.uniform(-0.1, 0.1)
                for t in range(20):
                    out[n, t, ..., c] += amp / m * np.cos(m * phi + ph + om * t) * np.sin(theta) ** m
    return out


SMALL = {
    "nef.num_hidden": 16,
    "nef.latent_dim": 8,
    "node.num_hidden": 32,
    "node.basis_dim": 16,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "training.nef.fit_on_num_steps": 2,
    "dataset.num_signals_train": 2,
    "dataset.num_signals_test": 2,
    # epoch 1 nef, 2 dual, 3 ode
    "training.num_epochs": 3,
    "training.nef.train_until_epoch": 2,
    "training.ode.train_from_epoch": 1,
    "training.ode.train_until_epoch": 3,
    "test.test_interval": 3,
    "test.test_dp_interval": 9,
    "test.test_equiv_at_epoch": 0,
    "logging.log_every_n_steps": 1,
    "logging.checkpoint": False,
}


def test_fit_cli_trains_shallow_water_low_res_and_runs_the_superres_eval(tmp_path, monkeypatch):
    """3 epochs at hid 16 on the 96 x 48 grid (4,608 points: two chunks of 2,048 and a
    padded one), the rollout decode on the kernel backend (its plain versions here),
    validation, the longitude-only equivariance check, then the zero-shot super-resolution
    eval on the 192 x 96 test split, from one shared cache of full-resolution fields."""
    monkeypatch.setattr(tsw, "generate_sw_trajectories", cheap_fields)
    data_dir, log_dir = tmp_path / "data", tmp_path / "run"
    over = [f"{k}={v}" for k, v in SMALL.items()]
    fit_main(["shallow_water", *over, f"dataset.path={data_dir}", f"logging.log_dir={log_dir}", "--device", "cpu"])
    records = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in records if "phase" in r] == ["nef", "nef+ode", "ode"]
    eqv = next(r for r in records if any(k.startswith("equivariance") for k in r))
    assert {k for k in eqv if k.startswith("equivariance")} == {"equivariance_err_longitude"}
    assert eqv["equivariance_err_longitude"] < 1e-4
    val = next(r for r in records if "val_mse_in_t" in r)
    sr = records[-1]
    assert set(sr) >= {"superres_mse_in_t", "superres_mse_out_t"}
    assert val["val_mse_out_t"] > 0 and sr["superres_mse_out_t"] > 0
    assert all(np.isfinite(v) for r in records for k, v in r.items() if "mse" in k or "err" in k)
    for split in ("train", "test"):  # one block of 4 full-resolution fields a split, shared
        files = sorted(p.name for p in (data_dir / "shallow_water" / split).glob("*.npz"))
        assert files == [f"traj_{i:06d}.npz" for i in range(4)]
    assert not (data_dir / "shallow_water_low_res").exists()
