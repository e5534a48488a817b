"""The port's autodecoding trainer and CLI branch against the JAX package's, on the CPU.

The JAX ``AutodecodingTrainer``'s initial state is converted into the port's trainer;
both then see the same trajectories, rows and random draws: JAX draws with
``jax.random`` from a key, so these tests recompute those draws (the coordinate subset of
the reconstruction loss, one subset per frame of the rollout loss, the refit's dropout
mask and its per-step subsets) and hand them to the port. The port's validation decode
runs the kernel backend (``nef.eval_backend: pallas``), which on the CPU is the plain
version of K1; JAX's runs its XLA composition. ``navier_stokes_nonmaml`` at a small
width (hidden 16, 8 x 8 grid, 3 training frames, 1 PONITA layer, 24 sampled points).
Losses rtol 1e-4; gradients rtol 2e-4 / atol 2e-5; parameters after a step rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.data.loader import TrajectoryLoader as JaxLoader
from enf_pde_tpu.experiments import fit as jax_fit
from enf_pde_tpu.models.latents import gather_latents as jax_gather
from enf_pde_tpu.train.autodecode import AutodecodingTrainer as JaxTrainer

from chip_smoke import smooth_trajectories
from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.convert import convert_params, flax_to_state_dict
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.data.loader import TrajectoryLoader
from enf_pde_tpu_torch.experiments.fit import main as fit_main
from enf_pde_tpu_torch.models.latents import gather_latents
from enf_pde_tpu_torch.train.autodecode import AutodecodingTrainer
from enf_pde_tpu_torch.train.steps import grad_leaves, group_grads, module_group
from tests.test_torch_fit import fill_cache, read_metrics
from tests.test_torch_modules import assert_close, np_tree

torch.set_num_threads(1)

SIZE, BATCH, FRAMES, SIGNALS = 8, 2, 6, 4
LOSS_RTOL, RTOL, ATOL = 1e-4, 2e-4, 2e-5
OVERRIDES = {
    "nef.num_hidden": 16,
    "node.num_hidden": 16,
    "node.basis_dim": 8,
    "node.num_layers": 1,
    "training.max_num_sampled_points": 24,
    "dataset.traj_len_train": 3,
    "dataset.num_signals_train": SIGNALS,
}
IDX = np.array([2, 0])


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, its state, port trainer with that state, port state, trajectories)."""
    jcfg = jax_load_config("navier_stokes_nonmaml", [f"{k}={v}" for k, v in OVERRIDES.items()])
    coords = planar_coords(SIZE, SIZE)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    # Scale the ODE readouts (initialised at 1e-6) so the rollout moves the latents, and
    # spread the table's contexts so that each row decodes differently.
    ode = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if "Dense_3" in str(path) or "Dense_4" in str(path) else v,
        jstate.params["ode"])
    table = dict(jstate.params["autodecoder"])
    table["a"] = table["a"] + 0.3 * jax.random.normal(jax.random.PRNGKey(4), table["a"].shape)
    jstate = jstate.replace(params={**jstate.params, "ode": ode, "autodecoder": table})
    cfg = load_experiment_config("navier_stokes_nonmaml", [f"{k}={v}" for k, v in OVERRIDES.items()])
    tr = AutodecodingTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    traj = smooth_trajectories(SIGNALS, FRAMES, SIZE, seed=7)
    return jtr, jstate, tr, state, traj


def port_grads(tree, groups):
    out = {g: flax_to_state_dict(np_tree(tree[g])) for g in groups if g in ("nef", "ode")}
    if "autodecoder" in groups:
        out["autodecoder"] = np_tree(tree["autodecoder"])
    return out


def compare(got, want, rtol=RTOL, atol=ATOL):
    """Every tensor of every group; returns how many are not all zero."""
    nonzero = 0
    for g, leaves in want.items():
        assert set(got[g]) == set(leaves), g
        for k, w in leaves.items():
            w = np.asarray(w)
            nonzero += bool(np.abs(w).max() > 0)
            assert_close(got[g][k], w.reshape(got[g][k].shape), rtol=rtol, atol=atol)
    return nonzero


def recon_draw(key, n, M):
    return np.asarray(jax.random.permutation(key, n)[:M])


# ----------------------------------------------------------------- state


def test_nonmaml_config_equals_yaml():
    name = "navier_stokes_nonmaml"
    assert load_experiment_config(name).to_dict() == jax_load_config(name).to_dict()


def test_gather_latents_and_converted_state(pair):
    jtr, jstate, tr, state, _ = pair
    table = jstate.params["autodecoder"]
    got = gather_latents(state["autodecoder"], IDX)
    want = jax_gather(table, jnp.asarray(IDX))
    assert set(got) == set(want) == {"p_pos", "a", "gaussian_window"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # convert_params takes the autodecoding state (no meta_sgd_lrs) and it loads strictly.
    params = convert_params(np_tree(jtr.init_state().params))
    assert params["meta_sgd_lrs"] is None and params["autodecoder"]["a"].shape == (SIGNALS, 4, 16)
    fresh = AutodecodingTrainer(tr.cfg, *build_models(tr.cfg), planar_coords(SIZE, SIZE), device="cpu")
    st = fresh.load_state(params)
    assert set(st) == {"autodecoder", "opt"} and set(st["opt"]) == {"nef", "autodecoder", "ode"}
    # The port's own init: a table of num_signals_train rows with the JAX table's values.
    own = fresh.init_state()
    for k, v in np_tree(jtr.init_state().params["autodecoder"]).items():
        np.testing.assert_array_equal(own["autodecoder"][k].numpy(), v)


# ----------------------------------------------------------------- losses


@pytest.mark.parametrize("dp", [0.0, 0.5])
def test_recon_loss_and_grads_match_jax(pair, dp):
    """The dropout mask first, then the subset of M of the kept points, decode, MSE."""
    jtr, jstate, tr, state, traj = pair
    key = jax.random.PRNGKey(11)
    n = SIZE * SIZE
    dp_mask = np.asarray(jax.random.permutation(jax.random.PRNGKey(1), n)[: int(n * dp)]) if dp else None
    frames = traj[IDX][:, 0]
    want_loss, want = jax.jit(jax.value_and_grad(jtr._recon_loss), static_argnums=())(
        jstate.params, jnp.asarray(frames), jnp.asarray(IDX), key,
        None if dp_mask is None else jnp.asarray(dp_mask))
    sel = recon_draw(key, len(dp_mask) if dp else n, tr.cfg.training.max_num_sampled_points)
    table = grad_leaves(state["autodecoder"])
    loss = tr._recon_loss(table, torch.from_numpy(frames), IDX, tr.generator, dp_mask=dp_mask, sel=sel)
    got = group_grads(loss, nef=module_group(tr.decoder), autodecoder=table)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare(got, port_grads(want, ("nef", "autodecoder"))) > 10
    # Only the rows of the batch get a gradient.
    assert float(got["autodecoder"]["a"][[1, 3]].abs().max()) == 0.0


def ode_draws(key, T, n, M):
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n)[:M])(jax.random.split(key, T)))


def test_ode_loss_and_grads_match_jax(pair):
    """The rollout loss of the stored latents, differentiated for decoder, table and ODE."""
    jtr, jstate, tr, state, traj = pair
    key = jax.random.PRNGKey(12)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._ode_loss))(
        jstate.params, jnp.asarray(traj[IDX]), jnp.asarray(IDX), key)
    masks = ode_draws(key, tr.cfg.dataset.traj_len_train, SIZE * SIZE, tr.cfg.training.max_num_sampled_points)
    table = grad_leaves(state["autodecoder"])
    loss = tr._ode_loss(table, torch.from_numpy(traj[IDX]), IDX, ode_masks=masks)
    got = group_grads(loss, nef=module_group(tr.decoder), autodecoder=table, ode=module_group(tr.ode_model))
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare(got, port_grads(want, ("nef", "autodecoder", "ode"))) > 20
    # The ode step's own gradient: the ODE's alone, the decoder out of autograd after.
    step_loss, step_grads = tr.ode_grads(state, torch.from_numpy(traj[IDX]), IDX, ode_masks=masks)
    assert set(step_grads) == {"ode"} and float(step_loss) == float(loss.detach())
    compare(step_grads, {"ode": got["ode"]}, rtol=0, atol=0)
    assert all(q.requires_grad for q in tr.decoder.parameters())


# ----------------------------------------------------------------- steps


def snapshot(tr, state):
    return {**{f"nef.{k}": v.detach().clone() for k, v in module_group(tr.decoder).items()},
            **{f"ode.{k}": v.detach().clone() for k, v in module_group(tr.ode_model).items()},
            **{f"ad.{k}": v.detach().clone() for k, v in state["autodecoder"].items()}}


def test_nef_step_matches_optax_and_codes_only_freezes_the_decoder(pair):
    jtr, jstate, _, _, traj = pair
    cfg = load_experiment_config("navier_stokes_nonmaml", [f"{k}={v}" for k, v in OVERRIDES.items()])
    tr = AutodecodingTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    x = torch.from_numpy(traj[IDX])
    loss_key, _ = jax.random.split(jstate.rng)
    sel = recon_draw(loss_key, SIZE * SIZE, cfg.training.max_num_sampled_points)
    want_loss, want = jtr.nef_train_step(jstate, jnp.asarray(traj[IDX]), jnp.asarray(IDX))
    loss, state = tr.nef_train_step(state, x, IDX, sel=sel)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    compare({"nef": tr.decoder.state_dict(), "autodecoder": state["autodecoder"]},
            port_grads(want.params, ("nef", "autodecoder")), rtol=1e-5, atol=1e-7)
    assert state["opt"]["nef"]["count"] == 1 and state["opt"]["autodecoder"]["count"] == 1

    before = snapshot(tr, state)
    loss, state = tr.codes_only_step(state, x, IDX)
    after = snapshot(tr, state)
    moved = {k.split(".")[0] for k in before if not torch.equal(before[k], after[k])}
    assert moved == {"ad"} and torch.isfinite(loss)  # the decoder bit for bit
    assert state["opt"]["nef"]["count"] == 1 and state["opt"]["autodecoder"]["count"] == 2
    before = snapshot(tr, state)
    loss, state = tr.ode_train_step(state, x, IDX)
    moved = {k.split(".")[0] for k, v in snapshot(tr, state).items() if not torch.equal(before[k], v)}
    assert moved == {"ode"} and torch.isfinite(loss)


def test_val_step_matches_jax(pair):
    """A 6-frame rollout from the stored latents (twice the 3-frame train horizon), the
    whole grid decoded by the plain K1 (the port) and XLA (JAX)."""
    jtr, jstate, tr, state, traj = pair
    want_in, want_out = jtr.val_step(jstate, jnp.asarray(traj[IDX]), jnp.asarray(IDX))
    got_in, got_out = tr.val_step(state, torch.from_numpy(traj[IDX]), IDX)
    assert float(want_out) > 0
    assert_close(got_in, want_in, rtol=1e-4, atol=1e-6)
    assert_close(got_out, want_out, rtol=1e-4, atol=1e-6)


def test_refit_latents_matches_jax(pair, monkeypatch):
    """dp = 0.5: JAX keeps the first half of a permutation from PRNGKey(1); two epochs of
    codes-only steps over a loader of two batches, each step's subset drawn from that key."""
    jtr, jstate, tr, state, traj = pair
    n, M, dp = SIZE * SIZE, tr.cfg.training.max_num_sampled_points, 0.5
    key = jax.random.PRNGKey(1)
    dp_mask = np.asarray(jax.random.permutation(key, n)[: int(n * dp)])
    rng, sels = key, []
    for _ in range(2 * 2):
        loss_key, rng = jax.random.split(rng)
        sels.append(recon_draw(loss_key, len(dp_mask), M))
    want = jtr.refit_latents(jstate, JaxLoader(lambda i: traj[i], range(SIGNALS), tr.coords.numpy(), BATCH),
                             num_epochs=2, dp=dp)
    before = snapshot(tr, state)
    draws = iter(sels)
    step = tr.codes_only_step
    monkeypatch.setattr(tr, "codes_only_step", lambda st, x, idx, dp_mask=None, generator=None: step(
        st, x, idx, dp_mask=dp_mask, sel=next(draws), generator=generator))
    got = tr.refit_latents(state, TrajectoryLoader(lambda i: traj[i], range(SIGNALS), tr.coords.numpy(),
                                                   BATCH, device="cpu"), num_epochs=2, dp=dp, dp_mask=dp_mask)
    assert next(draws, None) is None  # every step took its draw
    compare({"autodecoder": got["autodecoder"]}, {"autodecoder": np_tree(want.params["autodecoder"])},
            rtol=1e-5, atol=1e-7)
    assert got["opt"]["autodecoder"]["count"] == 4
    after = snapshot(tr, state)
    assert all(torch.equal(before[k], after[k]) for k in before)  # nothing of the state moved


# ----------------------------------------------------------------- the fit CLI


class _StubTrainer:
    """Stands in for JAX's trainer so that its loop logs its metric names without compiling."""

    def __init__(self, cfg, decoder, *args, **kwargs):
        self.eval_decoder = decoder

    def init_state(self):
        return {}

    def nef_train_step(self, state, traj, idx):
        return jnp.float32(0.5), state

    ode_train_step = nef_train_step

    def val_step(self, state, traj, idx):
        return jnp.float32(0.25), jnp.float32(0.5)

    def refit_latents(self, state, loader, num_epochs, dp=0.0):
        return state


def test_fit_cli_runs_navier_stokes_nonmaml_three_epochs_on_cpu(tmp_path, monkeypatch):
    """Epochs nef, nef, ode; the final validation (epoch 3) refits both splits for 2 epochs
    at each dropout share. Every logged record has the keys of the JAX loop's record."""
    data_dir = tmp_path / "data"
    fill_cache(data_dir, "train", SIGNALS, seed=0)
    fill_cache(data_dir, "test", BATCH, seed=100)
    over = [f"{k}={v}" for k, v in OVERRIDES.items() if k != "training.max_num_sampled_points"]
    over += ["training.max_num_sampled_points=256", f"dataset.batch_size={BATCH}",
             f"dataset.num_signals_test={BATCH}", "training.num_epochs=3",
             "training.nef.train_until_epoch=2", "training.ode.train_from_epoch=2",
             "training.ode.train_until_epoch=3", "test.test_interval=3", "test.refit_epochs=2",
             "logging.log_every_n_steps=1", f"dataset.path={data_dir}"]
    fit_main(["navier_stokes_nonmaml", *over, f"logging.log_dir={tmp_path / 'port'}", "--device", "cpu"])
    records = read_metrics(tmp_path / "port")
    # The port's run record names the data path first; the JAX loop logs no such record.
    assert (records[0]["train_data_path"], records[0]["val_data_path"]) == ("device_cache", "device_cache")
    records = records[1:]

    monkeypatch.setattr(jax_fit, "AutodecodingTrainer", _StubTrainer)
    jax_fit.run_experiment(jax_load_config("navier_stokes_nonmaml", [*over, f"logging.log_dir={tmp_path / 'jax'}"]))
    want = read_metrics(tmp_path / "jax")
    assert [set(r) for r in records] == [set(r) for r in want]
    assert [r["epoch"] for r in records if "train_mse_epoch" in r] == [1, 2, 3]
    val = records[-1]
    assert val["epoch"] == 3 and len([k for k in val if "mse" in k]) == 18
    assert all(np.isfinite(v) for r in records for k, v in r.items() if "mse" in k)
    assert (records[0]["train_backend"], records[0]["eval_backend"]) == ("eager", "kernel")
    assert not (tmp_path / "port" / "checkpoints").exists()  # the JAX path writes none either
