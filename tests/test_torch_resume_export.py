"""Training on from a JAX run in the port: its optimizer states exported, converted and resumed, on the CPU.

``tools/export_jax_checkpoint.py`` writes ``opt_state.npz`` (every leaf of the JAX state's four
optimizer states by its optax path, JAX's key ``rng`` and the loop's ``step``);
``convert.convert_opt_state`` maps it to the port's ``state["opt"]``, the trainers' ``load_state``
take it, and ``convert.write_resume_checkpoint`` writes the whole run as the port's checkpoint.
Here, at the Navier-Stokes config shrunk as in ``tests/test_torch_train.py`` (hidden 16, 8 x 8 grid,
3 training frames, 2 inner steps, 1 PONITA layer; the latent init's learning rate set so that all four
optimizers step) after three JAX steps (nef, ode, dual: every count non-zero, the counts not all equal):

- the port's ``Adam.update`` from the converted states, given JAX's own gradients, gives optax's new
  parameters and moments within rtol ADAM_RTOL, for each of the four groups;
- one whole nef, ode and dual step from the restored state, on the draws JAX takes from its key
  (``split(state.rng)[0]``), moves each group as JAX's step moves it within rel-L2 UPDATE_TOL, with
  the losses within LOSS_RTOL; from fresh optimizer states the same step lies more than FRESH_MIN away
  (Adam's first step is about ``lr * sign(g)``: the comparison sees the fault it guards);
- the four committed ``weights/<run>/opt_state.npz`` load with numpy alone and convert strictly, their
  counts are the steps of each optimizer's phases in the run's schedule, a leaf too few, one too many, a
  changed chain or another shape is refused with a ``KeyError`` naming it, and a fresh export from
  ``results/ckpt`` gives the committed arrays bit for bit (skipped, with the reason, where the checkout
  lacks the checkpoint);
- an autodecoding state exports and converts, with no ``meta_sgd`` group;
- a JAX run saved by its ``CheckpointManager``, exported, written as the port's checkpoint and trained on
  by ``run_experiment`` with ``logging.resume``, starts at the next epoch with its step and counts
  continued.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.train.autodecode import AutodecodingTrainer as JaxAutodecodingTrainer
from enf_pde_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer

from chip_smoke import smooth_trajectories
from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.convert import (convert_opt_state, convert_params, flax_to_state_dict, load_jax_export,
                                       load_opt_state, write_resume_checkpoint)
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.experiments.fit import run_experiment
from enf_pde_tpu_torch.train.autodecode import AutodecodingTrainer
from enf_pde_tpu_torch.train.checkpoint import CheckpointManager
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.train.state import make_optimizers
from enf_pde_tpu_torch.train.steps import phase_window
from tests.test_torch_fit import fill_cache
from tests.test_torch_modules import assert_close, np_tree
from tests.test_torch_train import ode_draws, inner_masks
from tools.export_jax_checkpoint import export_run, flat_opt_state, restore_run

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS, CKPT = ROOT / "weights", ROOT / "results" / "ckpt"
RUNS = ("ns8192_s0", "diff_plane_full_s0", "ihc_full_s0", "sw_full_s1")
SIZE, BATCH, FRAMES = 8, 2, 5
ADAM_RTOL = 1e-5
LOSS_RTOL, UPDATE_TOL, FRESH_MIN = 1e-4, 1e-3, 0.1
OVERRIDES = {
    "nef.num_hidden": 16,
    "node.num_hidden": 16,
    "node.basis_dim": 8,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "training.max_num_sampled_points": 24,
    "dataset.traj_len_train": 3,
    "optimizer.learning_rate_codes": 1e-3,  # the latent init's optimizer steps too
}
# The JAX state's parameter group of each optimizer state.
PARAM_GROUP = {"nef": "nef", "ode": "ode", "autodecoder": "autodecoder", "meta_sgd": "meta_sgd_lrs"}
# Where make_optimizers' chains hold optax's ScaleByAdamState: chain(clip, adamw) and adam.
ADAM_AT = {"nef": (1, 0), "ode": (1, 0), "autodecoder": (0,), "meta_sgd": (0,)}


def port_config(**extra):
    cfg = load_experiment_config("navier_stokes")
    for k, v in {**OVERRIDES, **extra}.items():
        cfg.set_path(k, v)
    return cfg


def rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64).ravel(), np.asarray(b, dtype=np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def npz(path) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def adam_state(opt_state, group):
    """optax's ScaleByAdamState of ``group``'s chain state."""
    for i in ADAM_AT[group]:
        opt_state = opt_state[i]
    return opt_state


def port_tree(tree, group) -> dict:
    """A JAX tree of ``group``'s parameters (or of their moments or gradients) in the port's naming."""
    return flax_to_state_dict(np_tree(tree)) if group in ("nef", "ode") else {
        k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in np_tree(tree).items()}


@pytest.fixture(scope="module")
def trained():
    """(JAX trainer, its state after a nef, an ode and a dual step, the trajectories, the jitted steps
    by kind, and JAX's gradients of a dual loss from that state: every group's)."""
    jcfg = jax_load_config("navier_stokes", [f"{k}={v}" for k, v in OVERRIDES.items()])
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), planar_coords(SIZE, SIZE), seed=0)
    state = jtr.init_state()
    # Scale the ODE readouts (initialised at 1e-6) so the rollout moves the latents.
    ode = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if "Dense_3" in str(path) or "Dense_4" in str(path) else v, state.params["ode"])
    state = state.replace(params={**state.params, "ode": ode})
    traj = smooth_trajectories(BATCH, FRAMES, SIZE, seed=7)
    steps = {kind: jax.jit(getattr(jtr, f"_{kind}_train_step")) for kind in ("nef", "ode", "dual")}
    for kind in steps:
        _, state = steps[kind](state, jnp.asarray(traj))
    counts = {g: int(adam_state(getattr(state, f"{g}_opt_state"), g).count) for g in PARAM_GROUP}
    assert counts == {"nef": 2, "ode": 2, "autodecoder": 1, "meta_sgd": 2}
    _, grads = jax.jit(jax.value_and_grad(jtr._ode_loss))(state.params, jnp.asarray(traj), jax.random.PRNGKey(4))
    return jtr, state, traj, steps, grads


def restored_trainer(state, opt: bool):
    """The port's trainer holding the JAX ``state``'s parameters, with its converted optimizer
    states (``opt``) or fresh ones."""
    cfg = port_config()
    tr = MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), seed=0, device="cpu")
    return tr, tr.load_state(convert_params(np_tree(state.params)),
                             convert_opt_state(cfg, flat_opt_state(state)) if opt else None)


# ----------------------------------------------------------------- (a) the mapping, through Adam's update


@pytest.mark.parametrize("group", list(PARAM_GROUP))
def test_port_adam_from_the_converted_state_matches_optax(trained, group):
    jtr, state, _, _, grads = trained
    pg = PARAM_GROUP[group]
    tx, js, jp = getattr(jtr.opts, group), getattr(state, f"{group}_opt_state"), state.params[pg]
    updates, new = jax.jit(tx.update)(grads[pg], js, jp)
    want_params, want = optax.apply_updates(jp, updates), adam_state(new, group)

    cfg = port_config()
    converted = convert_opt_state(cfg, flat_opt_state(state))[group]
    assert converted["count"] == int(adam_state(js, group).count) > 0
    params = port_tree(jp, group)
    got = make_optimizers(cfg)[group].update(port_tree(grads[pg], group), converted, params)
    assert got["count"] == int(want.count)
    assert any(float(v.abs().max()) > 0 for v in port_tree(grads[pg], group).values())
    for name, w in port_tree(want_params, group).items():
        assert_close(params[name], w, rtol=ADAM_RTOL, atol=1e-7)
    for moment in ("mu", "nu"):
        for name, w in port_tree(getattr(want, moment), group).items():
            assert_close(got[moment][name], w, rtol=ADAM_RTOL, atol=1e-6 * float(w.abs().max()))


# ----------------------------------------------------------------- (b) a whole step from the restored state


def flat_group(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v.detach() if torch.is_tensor(v) else v, dtype=np.float64).ravel()
                           for _, v in sorted(tree.items())])


def port_params(tr, state) -> dict:
    return {"nef": tr.nef_group(), "ode": tr.ode_group(), "autodecoder": state["autodecoder"],
            "meta_sgd_lrs": state["meta_sgd_lrs"]}


@pytest.mark.parametrize("kind,groups", [("nef", ("nef", "meta_sgd_lrs", "autodecoder")), ("ode", ("ode",)),
                                         ("dual", ("nef", "meta_sgd_lrs", "ode"))])
def test_a_step_from_the_restored_state_moves_the_groups_as_jaxs(trained, kind, groups):
    """The draws are JAX's from ``split(state.rng)[0]`` (``enf_pde_tpu/train/meta_sgd.py``'s steps)."""
    jtr, state, traj, steps, _ = trained
    loss_key = jax.random.split(state.rng)[0]
    before = convert_params(np_tree(state.params))
    want_loss, after = steps[kind](state, jnp.asarray(traj))
    after = convert_params(np_tree(after.params))
    if kind == "nef":
        k_sel, k_inner = jax.random.split(loss_key)
        draws = {"frame_idx": np.asarray(jax.random.permutation(k_sel, jtr.cfg.dataset.traj_len_train)[:2]),
                 "masks": inner_masks(jtr.cfg, k_inner, SIZE * SIZE)}
    else:
        draws = dict(zip(("masks", "ode_masks"), ode_draws(jtr, loss_key)))
    for opt, check in ((True, "restored"), (False, "fresh")):
        tr, st = restored_trainer(state, opt)
        got_before = {g: {k: v.detach().clone() for k, v in t.items()} for g, t in port_params(tr, st).items()}
        loss, st = getattr(tr, f"{kind}_train_step")(st, torch.from_numpy(traj), **draws)
        got_after = port_params(tr, st)
        for g in groups:
            want = flat_group(after[g]) - flat_group(before[g])
            got = flat_group(got_after[g]) - flat_group(got_before[g])
            assert np.abs(want).max() > 0, (kind, g)
            if check == "restored":
                assert rel(got, want) <= UPDATE_TOL, (kind, g, rel(got, want))
            else:
                assert rel(got, want) > FRESH_MIN, (kind, g, rel(got, want))
        if check == "restored":
            assert_close(loss, want_loss, rtol=LOSS_RTOL)
            assert st["opt"][{"nef": "nef", "ode": "ode", "dual": "ode"}[kind]]["count"] == 3


# ----------------------------------------------------------------- (c) the committed exports


def schedule_counts(cfg) -> dict:
    """Each optimizer's steps over the run's epochs: the steps of an epoch in each phase that runs it."""
    per_epoch = cfg.dataset.num_signals_train // cfg.dataset.batch_size
    phases = [phase_window(cfg.training, e) for e in range(1, cfg.training.num_epochs + 1)]
    nef = per_epoch * sum(n for n, _ in phases)
    return {"nef": nef, "ode": per_epoch * sum(o for _, o in phases), "meta_sgd": nef,
            "autodecoder": nef if cfg.optimizer.learning_rate_codes != 0 else 0}


@pytest.mark.parametrize("run", RUNS)
def test_committed_opt_state_loads_with_numpy_alone_and_converts(run):
    flat = npz(WEIGHTS / run / "opt_state.npz")
    assert flat["rng"].dtype == np.uint32 and flat["rng"].shape == (2,)
    assert flat["step"].dtype == np.int64 and flat["step"].shape == ()
    assert all(v.dtype == (np.int32 if k.endswith("/count") else np.float32)
               for k, v in flat.items() if k not in ("rng", "step"))
    cfg, params, record = load_jax_export(WEIGHTS / run)
    opt, step, rng = load_opt_state(WEIGHTS / run, cfg)
    assert step == record["metrics"]["step"] and rng == tuple(int(k) for k in flat["rng"])
    assert {g: s["count"] for g, s in opt.items()} == schedule_counts(cfg)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), np.zeros((4, cfg.nef.num_in), np.float32), device="cpu")
    state = tr.load_state(params, opt)  # every moment against its group's tensors
    kernel = next(k for k in state["opt"]["nef"]["mu"] if k.endswith("out_proj.weight"))
    assert torch.equal(state["opt"]["nef"]["mu"][kernel], torch.from_numpy(
        flat[f"nef/1/0/mu/params/{kernel.removesuffix('.weight').replace('.', '/')}/kernel"].T))


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("change", ["missing", "unexpected", "chain", "shape"])
def test_opt_state_with_a_leaf_too_few_or_too_many_is_refused(run, change):
    """Named as the port names it (group, moment, ``state_dict`` key or latent), or by its path."""
    flat = npz(WEIGHTS / run / "opt_state.npz")
    cfg = Config(json.loads((WEIGHTS / run / "config.json").read_text())["config"])
    del flat["rng"], flat["step"]
    if change == "missing":
        key = sorted(k for k in flat if k.startswith("ode/1/0/nu/") and k.endswith("/bias"))[-1]
        del flat[key]
        name = "missing ode moment nu " + ".".join(key.split("/")[5:])
    elif change == "unexpected":
        flat["nef/1/0/mu/params/Dense_9/bias"] = np.zeros(4, np.float32)
        name = "unexpected nef moment mu Dense_9.bias"
    elif change == "chain":  # the latent init's Adam state one place on, as a chain with a clip first would hold it
        flat = {re.sub(r"^autodecoder/0/", "autodecoder/1/0/", k): v for k, v in flat.items()}
        name = "unexpected leaf autodecoder/1/0/count"
    else:
        flat["meta_sgd/0/nu/a"] = np.zeros((3, *flat["meta_sgd/0/nu/a"].shape), np.float32)
        name = "meta_sgd moment nu a has shape"
    with pytest.raises(KeyError, match=re.escape(name)):
        convert_opt_state(cfg, flat)


@pytest.mark.parametrize("run", RUNS)
def test_fresh_export_rebuilds_the_committed_opt_state(run):
    if not (CKPT / run / "checkpoints").is_dir():
        pytest.skip(f"results/ckpt/{run} is not in this checkout (.gitattributes leaves it out of `git archive`)")
    _, _, _, state, _ = restore_run(CKPT / run)
    want, got = npz(WEIGHTS / run / "opt_state.npz"), flat_opt_state(state)
    assert sorted(got) == sorted(k for k in want if k not in ("rng", "step"))
    for key, arr in got.items():
        assert arr.dtype == want[key].dtype and np.array_equal(arr, want[key]), key
    assert np.array_equal(np.asarray(state.rng), want["rng"])
    counts = {g: int(adam_state(getattr(state, f"{g}_opt_state"), g).count) for g in PARAM_GROUP}
    cfg = load_jax_export(WEIGHTS / run)[0]
    assert counts == {g: s["count"] for g, s in load_opt_state(WEIGHTS / run, cfg)[0].items()}


# ----------------------------------------------------------------- (d) an autodecoding state


def test_autodecoding_opt_state_exports_and_converts(tmp_path):
    overrides = ["nef.num_hidden=16", "node.num_hidden=16", "node.basis_dim=8", "node.num_layers=1",
                 "dataset.num_signals_train=4", "training.max_num_sampled_points=256"]
    jcfg = jax_load_config("navier_stokes_nonmaml", overrides)
    jtr = JaxAutodecodingTrainer(jcfg, *jax_build_models(jcfg), planar_coords(64, 64), seed=0)
    state = jtr.init_state()
    assert state.meta_sgd_opt_state == ()
    run = tmp_path / "nonmaml"
    mgr = JaxCheckpointManager(str(run), every_n_epochs=1)
    mgr.save(1, state, jcfg.to_dict())
    mgr.wait()
    mgr.close()
    (run / "metrics.jsonl").write_text(json.dumps({"epoch": 1, "step": 2, "val_mse_in_t": 0.5, "val_mse_out_t": 0.7}) + "\n")
    out = export_run(run, tmp_path / "export", files=("config.json", "params.npz", "opt_state.npz"))
    assert sorted(p.name for p in out.iterdir()) == ["config.json", "opt_state.npz", "params.npz"]
    assert not any(k.startswith("meta_sgd") for k in npz(out / "opt_state.npz"))
    cfg, params, _ = load_jax_export(out)
    opt, step, _ = load_opt_state(out, cfg)
    assert sorted(opt) == ["autodecoder", "nef", "ode"] and step == 2
    assert opt["autodecoder"]["mu"]["a"].shape == (4, jcfg.nef.num_latents, jcfg.nef.latent_dim)
    tr = AutodecodingTrainer(cfg, *build_models(cfg), planar_coords(64, 64), device="cpu")
    got = tr.load_state(params, opt)["opt"]
    assert {g: s["count"] for g, s in got.items()} == {"nef": 0, "autodecoder": 0, "ode": 0}
    with pytest.raises(ValueError, match="autodecoding"):
        write_resume_checkpoint(out, tmp_path / "resume")


# ----------------------------------------------------------------- (e) a resume round trip on the CPU


def test_resume_from_a_jax_run_continues_its_epoch_step_and_counts(trained, tmp_path):
    """The fixture's state saved as JAX's epoch 2 of a run on 4 signals (batch 2: 2 steps an epoch)
    whose epoch 3 is an ode epoch; exported, written as the port's checkpoint, trained on for one epoch."""
    state = trained[1]
    extra = {"dataset.num_signals_train": 4, "dataset.num_signals_test": 2, "dataset.batch_size": BATCH,
             "training.num_epochs": 3, "training.nef.train_until_epoch": 1, "training.ode.train_from_epoch": 1,
             "training.ode.train_until_epoch": 3, "test.test_interval": 100, "test.test_dp_interval": 100,
             "logging.checkpoint_every_n_epochs": 1, "logging.keep_n_checkpoints": 2}
    jcfg = jax_load_config("navier_stokes", [f"{k}={v}" for k, v in {**OVERRIDES, **extra}.items()])
    run, data, log_dir = tmp_path / "jax_run", tmp_path / "data", tmp_path / "resumed"
    mgr = JaxCheckpointManager(str(run), every_n_epochs=1)
    mgr.save(2, state, jcfg.to_dict())
    mgr.wait()
    mgr.close()
    (run / "metrics.jsonl").write_text(json.dumps({"epoch": 2, "step": 4, "val_mse_in_t": 0.5, "val_mse_out_t": 0.7}) + "\n")
    out = export_run(run, tmp_path / "export", files=("config.json", "params.npz", "opt_state.npz"))
    cfg, params, _ = load_jax_export(out)
    opt, step, (k0, k1) = load_opt_state(out, cfg)
    assert Path(write_resume_checkpoint(out, log_dir)) == log_dir / "checkpoints" / "2"
    assert CheckpointManager(str(log_dir)).all_epochs() == [2]
    with pytest.raises(FileExistsError, match="already holds epoch 2"):
        write_resume_checkpoint(out, log_dir)

    fill_cache(data, "train", 4, seed=0)
    fill_cache(data, "test", 2, seed=100)
    cfg = load_experiment_config("navier_stokes", [f"{k}={v}" for k, v in {**OVERRIDES, **extra}.items()] + [
        f"dataset.path={data}", f"logging.log_dir={log_dir}", "logging.resume=true"])
    loop, got = run_experiment(cfg, device="cpu")
    records = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    resumed = next(r for r in records if "resumed_from_epoch" in r)
    assert resumed["resumed_from_epoch"] == 2 and resumed["step"] == 4
    assert [(r["epoch"], r["phase"]) for r in records if "train_mse_epoch" in r] == [(3, "ode")]
    assert loop.global_step == step + 2
    counts = {g: s["count"] for g, s in got["opt"].items()}
    restored = {g: s["count"] for g, s in opt.items()}
    assert counts == {**restored, "ode": restored["ode"] + 2}
    for k, v in loop.trainer.decoder.state_dict().items():  # the ode epoch leaves the decoder as JAX left it
        assert torch.equal(v, params["nef"][k]), k
    assert not any(torch.equal(v, params["ode"][k]) for k, v in loop.trainer.ode_model.state_dict().items()
                   if v.dtype.is_floating_point and v.numel() > 1)
    seeded = torch.Generator().manual_seed((k0 << 32) | k1).get_state()
    ckpt = torch.load(log_dir / "checkpoints" / "3" / "state.pt", weights_only=True)
    assert ckpt["global_step"] == 6 and not torch.equal(ckpt["generator"], seeded)  # drawn from since
    assert torch.equal(torch.load(log_dir / "checkpoints" / "2" / "state.pt", weights_only=True)["generator"], seeded)


def test_resume_checkpoint_needs_the_optimizer_states_and_the_step(tmp_path):
    for name in ("config.json", "params.npz"):
        (tmp_path / name).write_bytes((WEIGHTS / "ns8192_s0" / name).read_bytes())
    with pytest.raises(FileNotFoundError, match="opt_state.npz"):
        write_resume_checkpoint(tmp_path, tmp_path / "run")
    flat = npz(WEIGHTS / "ns8192_s0" / "opt_state.npz")
    del flat["step"]
    np.savez(tmp_path / "opt_state.npz", **flat)
    assert load_opt_state(tmp_path, load_jax_export(tmp_path)[0])[1] is None
    with pytest.raises(ValueError, match="no global step"):
        write_resume_checkpoint(tmp_path, tmp_path / "run")
    assert not (tmp_path / "run").exists()
