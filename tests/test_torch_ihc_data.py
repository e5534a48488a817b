"""The port's ball-convection data, the ``ihc`` config and its CLI run against the JAX package, on the CPU.

The config equals the YAML; the solver's set-up tables equal the numpy solver's; its
states (temperature, poloidal and toroidal coefficients) after 20 steps at ``lmax=7,
nmax=10`` and after 5 steps at the full ``lmax=23, nmax=24``, buoyancy on, agree with the
numpy ``BallConvectionSolver`` to rel-L2 1e-10 (both float64); a batched block with
per-trajectory CFL steps agrees with each seed alone in the numpy solver; the (Q, S, T)
round trip and the sign-definite weak operators (the JAX package's own checks); the output
grid's temperature; the conduction limit against ``BallModes``' closed-form frames (within
2e-3, as the JAX package's test); ``generate_ihc_trajectories`` with a small solver
against JAX's same call (float32 frames, rel-L2 1e-6); the registry spec; and the ``fit``
CLI for 3 epochs of ``ihc`` on the CPU, on a cache of short small-solver runs (the full
protocol is about 3,400 solver steps a trajectory).
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.linalg import eigh

from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.data import ball_convection as jbc
from enf_pde_tpu.data import ihc as jihc
from enf_pde_tpu.data.cache import test_seed as jax_test_seed
from enf_pde_tpu.data.registry import dataset_spec as jax_dataset_spec

from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.data import ball_convection as tbc
from enf_pde_tpu_torch.data import ihc as tihc
from enf_pde_tpu_torch.data.cache import TrajectoryCache
from enf_pde_tpu_torch.data.registry import DATASET_NAMES, dataset_spec
from enf_pde_tpu_torch.experiments.fit import main as fit_main
from tests.test_torch_shallow_water_data import rel_l2

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    """(port solver, numpy solver) at lmax=7, nmax=10, buoyancy on."""
    return tbc.BallConvectionSolver(lmax=7, nmax=10, device="cpu"), jbc.BallConvectionSolver(lmax=7, nmax=10)


def test_ihc_config_equals_yaml():
    assert load_experiment_config("ihc").to_dict() == jax_load_config("ihc").to_dict()


# ----------------------------------------------------------------- the solver


def test_solver_tables_equal_numpy(small):
    """The set-up is the numpy solver's code: its tables are equal, element for element."""
    port, ref = small
    assert (port.L, port.M, port.NT, port.NZ, port.NW, port.nq) == (ref.L, ref.M, ref.NT, ref.NZ, ref.NW, ref.nq)
    for name in ("ET0", "ET1", "PT", "EZ0", "EZ1", "EW0", "EW1", "EW2", "MT", "KT", "MZ", "KZ", "MW", "GW"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), getattr(ref, name), name)
    np.testing.assert_array_equal(port.ang.P_m.numpy(), ref.ang.P_m)
    np.testing.assert_array_equal(port.ang.HwT_m.numpy(), ref.ang.HwT_m)
    np.testing.assert_array_equal(port.rq, ref.rq)


@pytest.mark.parametrize("lmax,nmax,steps", [(7, 10, 20), (23, 24, 5)])
def test_solver_states_match_numpy(lmax, nmax, steps):
    """Seed 3 from the same noise (``RandomState``), buoyancy on: Tc, Wc and Zc after
    ``steps`` SBDF steps (the first SBDF1) within rel-L2 1e-10, and the recorded frames."""
    port = tbc.BallConvectionSolver(lmax=lmax, nmax=nmax, device="cpu")
    ref = jbc.BallConvectionSolver(lmax=lmax, nmax=nmax)
    got_ic, want_ic = port.initial_condition([3]), ref.initial_condition(3)
    assert all(a.dtype == torch.complex128 and tuple(a.shape[1:]) == b.shape for a, b in zip(got_ic, want_ic))
    assert rel_l2(got_ic[0][0].numpy(), want_ic[0]) <= 1e-10
    states = {}

    def keep(name, take):
        def on_step(step, t, dt, solver, T, W, Z):
            if step == steps:
                states[name] = [take(x) for x in (T, W, Z)] + [t, dt]
        return on_step

    kw = dict(stop_time=(steps - 0.5) * 0.02, record_interval=0.02, t_start_record=0.02, num_frames=steps)
    got = port.simulate([3], on_step=keep("port", lambda x: x[0].numpy().copy()), **kw)
    want = ref.simulate(3, on_step=keep("ref", np.copy), **kw)
    assert tuple(got.shape) == (1, *want.shape) == (1, steps, 48, 24, 24)
    for name, a, b in zip("TWZ", states["port"][:3], states["ref"][:3]):
        assert np.abs(b).max() > 0, name  # the flow has started
        assert rel_l2(a, b) <= 1e-10, (name, rel_l2(a, b))
    assert states["port"][3:] == [[states["ref"][3]], [states["ref"][4]]]  # the same time and dt
    assert rel_l2(got[0].numpy(), want) <= 1e-10


def test_batched_block_with_its_own_steps_matches_each_seed(small):
    """Two seeds as one batch until t = 6: each follows its own CFL dt sequence and SBDF1
    restarts (the steps shrink from 0.02 at different times), and each trajectory equals
    the numpy solver's run of its seed alone (rel-L2 1e-10); ``last_run`` holds each
    trajectory's steps and dt range."""
    port, ref = small
    dts = []
    kw = dict(stop_time=6.0, record_interval=2.0, t_start_record=2.0, num_frames=3)
    got = port.simulate([3, 11], on_step=lambda step, t, dt, *_: dts.append(tuple(dt)), **kw)
    assert got.shape == (2, 3, 48, 24, 24)
    assert any(a != b for a, b in dts)  # the two trajectories' steps differ
    for i, seed in enumerate((3, 11)):
        ref_dts = []
        assert rel_l2(got[i].numpy(), ref.simulate(seed, on_step=lambda step, t, dt, *_: ref_dts.append(dt),
                                                   **kw)) <= 1e-10
        steps, lo, hi = port.last_run[i]
        assert steps == len(ref_dts)
        np.testing.assert_allclose([lo, hi], [min(ref_dts), max(ref_dts)], rtol=1e-9)  # CFL on rounded velocities


def _random_potentials(solver, scale, seed=0, lcut=4):
    rng = np.random.RandomState(seed)
    L, M = solver.L, solver.M

    def draw(n):
        X = (rng.randn(L, M, n) + 1j * rng.randn(L, M, n)) * scale
        ls = np.arange(L)[:, None, None]
        ms = np.arange(M)[None, :, None]
        X *= (ms <= ls) * (ls >= 1) * (ls <= lcut)
        X[:, 0] = X[:, 0].real
        X[..., n // 2:] = 0
        return torch.from_numpy(X[None])

    return draw(solver.NW), draw(solver.NZ)


def test_qst_round_trip_and_sign_definite_operators(small):
    """The JAX package's checks on the port's operators: a field synthesized from (W, Z)
    analyzes back to Q = l(l+1) W / r^2, S = W'/r, T = -Z/r (to 1e-10 of its scale); the
    weak forms are positive semi-definite (unconditional SBDF stability)."""
    s = small[0]
    Wc, Zc = _random_potentials(s, 0.1)
    W0, W1, Z0 = s._radial_eval(Wc, s.EW0), s._radial_eval(Wc, s.EW1), s._radial_eval(Zc, s.EZ0)
    Q, S, T = s._qst_analysis(*s._vector_grid(W0, W1, Z0))
    rq = torch.from_numpy(s.rq)[:, None, None]
    llp1 = s.ang.llp1[None, :, None]
    ls, ms = np.arange(s.L)[None, :, None], np.arange(s.M)[None, None, :]
    mask = np.broadcast_to((ls >= 1) & (ms <= ls), Q.shape[1:])
    for got, want in ((Q, llp1 * W0 / rq**2), (S, W1 / rq), (T, -Z0 / rq)):
        got, want = got[0].numpy(), want[0].numpy()
        assert np.abs(got - want)[mask].max() < 1e-10 * max(np.abs(want)[mask].max(), 1.0)
    for l in range(1, s.L):
        for K, Mm in ((s.KZ, s.MZ), (s.GW, s.MW), (s.KT, s.MT)):
            ev = eigh(K[l].numpy(), Mm[l].numpy(), eigvals_only=True)
            assert ev.min() > -1e-8 * max(1.0, abs(ev.max()))


def test_output_grid_temperature_matches_numpy(small):
    port, ref = small
    Tc = port.initial_condition([5, 6])[0]
    got = tbc.BallOutputGrid(port).temperature(port, Tc)
    assert tuple(got.shape) == (2, 48, 24, 24) and got.dtype == torch.float64
    out = jbc.BallOutputGrid(ref)
    for i in range(2):
        assert rel_l2(got[i].numpy(), out.temperature(ref, Tc[i].numpy())) <= 1e-12
    small_grid = tbc.BallOutputGrid(port, nphi=16, ntheta=8, nr=8)
    np.testing.assert_array_equal(small_grid.r, np.linspace(0, 1, 8))
    assert tuple(small_grid.temperature(port, Tc).shape) == (2, 16, 8, 8)


def test_conduction_limit_matches_ball_modes_decay():
    """Buoyancy off, ``BallModes``' seeded modal field (l <= 4, three radial modes each) on
    the conductive profile: the solver's frames 0.5 apart equal ``BallModes.frames``, the
    closed-form Neumann heat-kernel decay, the perturbation off 1 - r^2 to rel-L2 2e-3 (as
    the JAX package's test; about 2e-6 here); ``BallModes`` equals JAX's."""
    s = tbc.BallConvectionSolver(lmax=5, nmax=12, buoyancy=0.0, device="cpu")
    modes = tihc.BallModes(nphi=16, ntheta=8, nr=8, lmax=4, nmax=3)
    jmodes = jihc.BallModes(nphi=16, ntheta=8, nr=8, lmax=4, nmax=3)
    np.testing.assert_array_equal(modes.lam, jmodes.lam)
    coeffs, dt_rec = modes.sample_ic_coeffs(4), 0.5
    times = dt_rec * np.arange(1, 4)
    want = modes.frames(coeffs, times)
    np.testing.assert_array_equal(want, jmodes.frames(coeffs, times))
    out = tbc.BallOutputGrid(s, nphi=16, ntheta=8, nr=8)
    frames = s.simulate([0], stop_time=3 * dt_rec, record_interval=dt_rec, t_start_record=dt_rec, num_frames=3,
                        out_grid=out, ic=modes.conduction_state(s, coeffs))[0].numpy()
    base = 1.0 - out.r**2
    for k in range(3):
        assert rel_l2(frames[k] - base, want[k] - base) <= 2e-3, k
    assert rel_l2(want[2] - base, want[0] - base) > 2e-2  # the field decays measurably


def test_generate_ihc_trajectories_matches_jax():
    """A small solver (lmax=5, nmax=8), two seeds, 2 frames at t = 2.0 and 2.2: the port's
    batched block against JAX's seeds one at a time, in float32 (rel-L2 1e-6)."""
    seeds = [0, jax_test_seed(1)]
    got = tihc.generate_ihc_trajectories(seeds, tbc.BallConvectionSolver(lmax=5, nmax=8, device="cpu"), num_frames=2)
    want = jihc.generate_ihc_trajectories(np.asarray(seeds), jbc.BallConvectionSolver(lmax=5, nmax=8), num_frames=2)
    assert got.shape == want.shape == (2, 2, 48, 24, 24, 1) and got.dtype == np.float32
    assert rel_l2(got, want) <= 1e-6
    assert rel_l2(got[0], got[1]) > 1e-3  # the seeds differ


# ----------------------------------------------------------------- registry


def test_registry_ihc_spec_matches_jax(monkeypatch):
    seen = []

    def recorder(ids, solver=None):
        seen.append(([int(i) for i in ids], solver.lmax, solver.nmax, str(solver.device)))
        return np.zeros((len(ids), 1))

    monkeypatch.setattr(tihc, "generate_ihc_trajectories", recorder)
    monkeypatch.setattr(jihc, "generate_ihc_trajectories", lambda ids, solver=None: np.zeros((len(ids), 1)))
    spec, jspec = dataset_spec("ihc", device="cpu"), jax_dataset_spec("ihc")
    assert DATASET_NAMES[-1] == "ihc"
    assert (spec.n_frames_train, spec.batch_size_gen, spec.cache_name) == (
        jspec.n_frames_train, jspec.batch_size_gen, jspec.cache_name) == (None, 2, "ihc_convection")
    assert spec.coords.shape == (48 * 24 * 24, 3) and spec.coords.dtype == np.float32
    np.testing.assert_array_equal(spec.coords, jspec.coords)
    spec.gen_train(np.arange(2))
    spec.gen_test(np.arange(2))
    assert seen == [([0, 1], 23, 24, "cpu"), ([jax_test_seed(0), jax_test_seed(1)], 23, 24, "cpu")]
    traj = np.random.default_rng(1).standard_normal((20, 4, 3, 2, 1)).astype(np.float32)
    assert spec.postprocess(traj).shape == (14, 4, 3, 2, 1)
    np.testing.assert_array_equal(spec.postprocess(traj), jspec.postprocess(traj))


# ----------------------------------------------------------------- the CLI, 3 epochs on the CPU


SMALL = {
    "nef.num_hidden": 16,
    "nef.latent_dim": 8,
    "nef.num_latents": 4,
    "node.num_hidden": 32,
    "node.basis_dim": 16,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "dataset.num_signals_train": 2,
    "dataset.num_signals_test": 2,
    # epoch 1 nef, 2 dual, 3 ode; no phase covers epoch 4 (ihc.yaml's case: 2500 epochs
    # against an ode phase that ends at 2000), so the run stops after epoch 3
    "training.num_epochs": 4,
    "training.nef.train_until_epoch": 2,
    "training.ode.train_from_epoch": 1,
    "training.ode.train_until_epoch": 3,
    "test.test_interval": 3,
    "test.test_dp_interval": 9,
    "test.test_equiv_at_epoch": 0,
    "logging.log_every_n_steps": 1,
    "logging.checkpoint": False,
    "logging.visualize_every_n_epochs": 3,
}


def test_fit_cli_trains_ihc_three_epochs_on_cpu(tmp_path):
    """3 epochs (nef, dual, ode) at hid 16 on the 48 x 24 x 24 grid (27,648 points: 13
    chunks of 2,048 and a padded last one for validation), from a cache of 20-step runs of
    a small solver, then the stop where the schedule is exhausted; finite metrics, the
    ball's rotation error and the ball's rollout figure."""
    data_dir, log_dir = tmp_path / "data", tmp_path / "run"
    solver = tbc.BallConvectionSolver(lmax=5, nmax=8, device="cpu")
    for group, seeds in (("train", [0, 1]), ("test", [jax_test_seed(0), jax_test_seed(1)])):
        cache = TrajectoryCache(os.path.join(data_dir, "ihc_convection", group), None)
        frames = solver.simulate(seeds, record_interval=0.02, t_start_record=0.02, num_frames=20)
        for i, traj in enumerate(frames.numpy().astype(np.float32)[..., None]):
            cache.write(i, traj)
    over = [f"{k}={v}" for k, v in SMALL.items()]
    fit_main(["ihc", *over, f"dataset.path={data_dir}", f"logging.log_dir={log_dir}", "--device", "cpu"])
    records = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in records if "phase" in r] == ["nef", "nef+ode", "ode"]
    eqv = next(r for r in records if any(k.startswith("equivariance") for k in r))
    assert {k for k in eqv if k.startswith("equivariance")} == {"equivariance_err_rotation"}
    val = next(r for r in records if "val_mse_in_t" in r)
    assert val["val_mse_out_t"] > 0
    assert all(np.isfinite(v) for r in records for k, v in r.items() if "mse" in k or "err" in k)
    assert [r["schedule_exhausted_at_epoch"] for r in records if "schedule_exhausted_at_epoch" in r] == [4]
    assert os.listdir(log_dir / "figures") == ["rollout_epoch00003.png"]
    assert sorted(os.listdir(data_dir / "ihc_convection" / "train")) == [
        "shape.json", "traj_000000.npz", "traj_000000.raw", "traj_000001.npz", "traj_000001.raw"]
