"""Checkpoints, resume, the equivariance check, figures and the ``fit`` CLI of the port.

On the CPU at a small width (decoder hidden 16, 1 PONITA layer of 16, 2 inner steps)
on the Navier-Stokes config. Checkpoint retention is compared with the JAX package's
orbax manager for the same saves; a checkpoint round trip and a resumed run are
compared bit for bit (the CPU is deterministic for one thread); the equivariance
functions are compared with JAX's on the same toy decoder within rtol 1e-5.
"""

import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.config import Config as JaxConfig
from enf_pde_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from enf_pde_tpu.train.loop import TrainLoop as JaxTrainLoop
from enf_pde_tpu.utils import equivariance as jeq

from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.data.cache import TrajectoryCache
from enf_pde_tpu_torch.data.navier_stokes import GaussianRF2D, default_forcing, navier_stokes_rollout
from enf_pde_tpu_torch.experiments.fit import main as fit_main
from enf_pde_tpu_torch.experiments.fit import run_experiment
from enf_pde_tpu_torch.geometry.invariants import (
    BallInvariant,
    BallLatInvariant,
    RelativePositionPeriodic,
    RelativePositionPolarPeriodic,
)
from enf_pde_tpu_torch.ops.layers import reset_parameters
from enf_pde_tpu_torch.train.checkpoint import CheckpointManager
from enf_pde_tpu_torch.train.loop import TrainLoop
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.utils import equivariance as teq

torch.set_num_threads(1)

SIZE, BATCH, FRAMES = 8, 2, 5
SMALL = {
    "nef.num_hidden": 16,
    "node.num_hidden": 16,
    "node.basis_dim": 8,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "training.max_num_sampled_points": 24,
    "dataset.traj_len_train": 3,
    "dataset.batch_size": BATCH,
    # epoch 1 nef, 2 dual, 3 ode
    "training.nef.train_until_epoch": 2,
    "training.ode.train_from_epoch": 1,
    "training.ode.train_until_epoch": 3,
    "test.test_dp_interval": 1000,
    "logging.log_every_n_steps": 1,
}


def small_config(tmp_path, **extra):
    cfg = load_experiment_config("navier_stokes")
    for k, v in {**SMALL, "logging.log_dir": str(tmp_path), **extra}.items():
        cfg.set_path(k, v)
    return cfg


def make_trainer(cfg, seed=0):
    return MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), seed=seed, device="cpu")


def ns_batches(n_batches: int, seed: int = 0) -> list:
    """Navier-Stokes trajectories on the 8 x 8 torus from the port's solver, [BATCH, FRAMES, 8, 8, 1]."""
    w0 = GaussianRF2D(SIZE).sample(range(seed, seed + n_batches * BATCH), "cpu")
    snaps, _ = navier_stokes_rollout(w0, default_forcing(SIZE, "cpu"), 1e-3, 1e-2, FRAMES, 20)
    data = snaps[..., None].numpy()
    return [data[i * BATCH:(i + 1) * BATCH] for i in range(n_batches)]


def read_metrics(log_dir) -> list:
    return [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]


def flat_tensors(x, prefix=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from flat_tensors(v, f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), x


def assert_same_training_state(tr_a, state_a, tr_b, state_b):
    for mod_a, mod_b in ((tr_a.decoder, tr_b.decoder), (tr_a.ode_model, tr_b.ode_model)):
        sd_a, sd_b = mod_a.state_dict(), mod_b.state_dict()
        assert sd_a.keys() == sd_b.keys()
        for k in sd_a:
            assert torch.equal(sd_a[k], sd_b[k]), k
    flat_a, flat_b = dict(flat_tensors(state_a)), dict(flat_tensors(state_b))
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_a.items():
        assert (torch.equal(v, flat_b[k]) if torch.is_tensor(v) else v == flat_b[k]), k
    assert torch.equal(tr_a.generator.get_state(), tr_b.generator.get_state())


# ----------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("every_n,keep_n,kept", [(3, 10, [1, 3, 6, 9]), (3, 2, [6, 9])])
def test_checkpoint_retention_matches_orbax(tmp_path, every_n, keep_n, kept):
    cfg = small_config(tmp_path)
    trainer = make_trainer(cfg)
    state = trainer.init_state()
    jax_mgr = JaxCheckpointManager(str(tmp_path / "jax"), every_n_epochs=every_n, keep_n=keep_n)
    port_mgr = CheckpointManager(str(tmp_path / "port"), every_n_epochs=every_n, keep_n=keep_n)
    saved = []
    for epoch in range(1, 11):
        jax_mgr.save(epoch, {"x": jnp.full((2,), float(epoch))}, {"epoch": epoch})
        saved.append(port_mgr.save(epoch, trainer, state, cfg.to_dict()))
    jax_mgr.wait()
    assert sorted(int(n) for n in os.listdir(tmp_path / "jax" / "checkpoints") if n.isdigit()) == kept
    jax_mgr.close()
    assert port_mgr.all_epochs() == kept and port_mgr.latest_epoch() == kept[-1]
    assert [e for e, s in zip(range(1, 11), saved) if s] == [1, 3, 6, 9]
    assert not port_mgr.save(9, trainer, state, cfg.to_dict())  # not later than the latest
    assert sorted(os.listdir(port_mgr.directory)) == [str(e) for e in kept]  # no temporary left


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    cfg = small_config(tmp_path)
    trainer = make_trainer(cfg)
    state = trainer.init_state()
    traj = torch.from_numpy(ns_batches(1)[0])
    _, state = trainer.nef_train_step(state, traj)
    _, state = trainer.dual_train_step(state, traj)  # every optimizer state moves
    mgr = CheckpointManager(str(tmp_path), every_n_epochs=1, keep_n=1)
    assert mgr.save(2, trainer, state, cfg.to_dict(), global_step=7)

    fresh = make_trainer(cfg, seed=5)
    fresh.init_state()
    restored, step = mgr.restore(fresh)
    assert step == 7
    assert any("rff" in k or "coeff" in k for k in dict(fresh.decoder.named_buffers()))
    assert_same_training_state(trainer, state, fresh, restored)
    assert mgr.restore_config() == json.loads(json.dumps(cfg.to_dict()))
    # The restored trainer draws what the live one draws next.
    assert torch.equal(torch.randperm(50, generator=fresh.generator),
                       torch.randperm(50, generator=trainer.generator))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)


def run_loop(cfg, batches, val, num_epochs, checkpoints=None):
    trainer = make_trainer(cfg)
    loop = TrainLoop(trainer, batches, val, checkpoints=checkpoints)
    state = loop.run(num_epochs)
    loop.logger.close()
    return trainer, state


def test_resume_equals_an_uninterrupted_run(tmp_path):
    data = ns_batches(3)
    train, val = data[:2], data[2:]
    full_dir, cut_dir = tmp_path / "full", tmp_path / "cut"
    extra = {"test.test_interval": 2, "logging.checkpoint_every_n_epochs": 1}
    tr_full, st_full = run_loop(small_config(full_dir, **extra), train, val, 3)
    cfg = small_config(cut_dir, **extra)
    run_loop(cfg, train, val, 2, CheckpointManager(str(cut_dir), every_n_epochs=1, keep_n=2))
    cfg.logging.resume = True
    tr_cut, st_cut = run_loop(cfg, train, val, 3,
                              CheckpointManager(str(cut_dir), every_n_epochs=1, keep_n=2))
    assert_same_training_state(tr_full, st_full, tr_cut, st_cut)

    def by_epoch(log_dir):
        return [{k: v for k, v in r.items() if k not in ("t", "train_wall_s", "step_time_s",
                                                         "steps_per_sec")}
                for r in read_metrics(log_dir) if "epoch" in r or "mse_step" in r]

    full, cut = by_epoch(full_dir), by_epoch(cut_dir)
    assert [r.get("phase") for r in full if "train_mse_epoch" in r] == ["nef", "nef+ode", "ode"]
    resumed = next(r for r in read_metrics(cut_dir) if "resumed_from_epoch" in r)
    assert resumed["resumed_from_epoch"] == 2 and resumed["resumed_config_differs"] == []
    assert full == cut  # every epoch's loss, the validation of epoch 2, the step counts


def test_check_resumed_config_names_a_changed_key_and_ignores_logging(tmp_path, capsys):
    cfg = small_config(tmp_path)
    trainer = make_trainer(cfg)
    mgr = CheckpointManager(str(tmp_path), every_n_epochs=1)
    mgr.save(4, trainer, trainer.init_state(), cfg.to_dict())
    cfg.training.ode.train_until_epoch = 9
    cfg.logging.log_dir = str(tmp_path / "elsewhere")
    cfg.logging.resume = True
    diffs = TrainLoop(trainer, [], [], checkpoints=mgr)._check_resumed_config(4)
    assert diffs == {"training.ode.train_until_epoch": (3, 9)}
    port_line = capsys.readouterr().out
    JaxTrainLoop._check_resumed_config(SimpleNamespace(checkpoints=mgr, cfg=JaxConfig(cfg.to_dict())), 4)
    assert port_line == capsys.readouterr().out != ""


# ----------------------------------------------------------------- equivariance


def toy_decoder(xp):
    """A decoder that is not equivariant (coordinates scaled by 1.3), in numpy-style ops."""
    def apply(x, p, a, w):
        d = min(x.shape[-1], p.shape[-1])
        phase = (1.3 * x[:, :, None, :d] - p[:, None, :, :d]).sum(-1)
        return (a[:, None, :, 0] * xp.cos(phase) * xp.exp(-w[:, None, :, 0])).sum(-1)[..., None]
    return apply


def toy_inputs(coord_dim: int, pose_dim: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.2, 2.8, (2, 16, coord_dim)).astype(np.float32)
    p = rng.uniform(0.2, 2.8, (2, 3, pose_dim)).astype(np.float32)
    a = rng.standard_normal((2, 3, 4)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (2, 3, 1)).astype(np.float32)
    return x, p, a, w


EQUIVARIANCE_CASES = [
    ("2d", 2, 2, {"has_orientation": False, "periodic": True}),
    ("2d", 2, 3, {"has_orientation": True, "periodic": False}),
    ("sphere", 2, 2, {"full_so3": True}),
    ("sphere", 2, 2, {"full_so3": False}),
    ("ball", 3, 4, {"euler_poses": True}),
    ("ball", 3, 4, {"euler_poses": False}),
]


@pytest.mark.parametrize("kind,coord_dim,pose_dim,flags", EQUIVARIANCE_CASES)
def test_equivariance_functions_match_jax(kind, coord_dim, pose_dim, flags):
    x, p, a, w = toy_inputs(coord_dim, pose_dim)
    jfn = getattr(jeq, f"equivariance_errors_{kind}")
    tfn = getattr(teq, f"equivariance_errors_{kind}")
    jdec = toy_decoder(jnp)
    want = jfn(lambda params, *args: jdec(*args), None, *map(jnp.asarray, (x, p, a, w)), **flags)
    got = tfn(toy_decoder(torch), *map(torch.from_numpy, (x, p, a, w)), **flags)
    assert got.keys() == want.keys() and want
    for k, v in want.items():
        assert v > 1e-3, k  # the toy decoder is flagged
        np.testing.assert_allclose(got[k], v, rtol=1e-5)


def test_decoder_is_torus_translation_equivariant():
    cfg = load_experiment_config("navier_stokes")
    cfg.nef.num_hidden = 16
    decoder, _ = build_models(cfg)
    reset_parameters(decoder, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(2, 32, 2, generator=gen) * 2 - 1
    p = torch.rand(2, 4, 2, generator=gen) * 2 - 1
    a = torch.randn(2, 4, cfg.nef.latent_dim, generator=gen)
    w = torch.full((2, 4, 1), 0.5)
    errs = teq.equivariance_errors(decoder, x, p, a, w, invariant=decoder.cross_attn_invariant,
                                   coordinate_system="cartesian")
    assert set(errs) == {"translation"} and errs["translation"] < 1e-4
    with torch.no_grad():  # a decode with the coordinates shifted and the poses not is flagged
        assert float((decoder(x + 0.3, p, a, w) - decoder(x, p, a, w)).abs().max()) > 1e-3
    # The sphere dispatches to the S^2 check: the longitude shift, and a rotation for the
    # SO(3)-invariant polar_periodic geometry. The ball dispatches to its check: the joint
    # rotation for the Euler-angle ball invariant, else the longitude shift (ball_lat).
    assert set(teq.equivariance_errors(decoder, x, p, a, w, RelativePositionPeriodic(2), "polar")) == {"longitude"}
    assert set(teq.equivariance_errors(decoder, x, p, a, w, RelativePositionPolarPeriodic(), "polar")) == {
        "longitude", "rotation"}
    xb = torch.cat([x, torch.rand(2, 32, 1, generator=gen)], dim=-1)  # (phi, theta, r)
    pb = torch.cat([p, torch.rand(2, 4, 2, generator=gen)], dim=-1)  # (alpha, beta, gamma, r)
    ball_dec, _ = build_models(load_experiment_config("ihc", ["nef.num_latents=4", "nef.latent_dim=16"]))
    reset_parameters(ball_dec, torch.Generator().manual_seed(5))
    assert set(teq.equivariance_errors(ball_dec, xb, pb, a, w, BallInvariant(), "ball")) == {"rotation"}
    assert set(teq.equivariance_errors(ball_dec, xb, pb, a, w, BallLatInvariant(), "ball")) == {"longitude"}


# ----------------------------------------------------------------- side fits, figures


def test_equivariance_check_and_figures_leave_the_training_draws_alone(tmp_path):
    """Two runs that differ only in the equivariance and figure settings train alike."""
    data = ns_batches(3, seed=10)
    epoch_mse = {}
    for side in (True, False):
        cfg = small_config(tmp_path / str(side), **{
            "test.test_interval": 1,
            "test.test_equiv_at_epoch": 0 if side else 400,
            "logging.visualize_every_n_epochs": 1 if side else 0,
        })
        run_loop(cfg, data[:2], data[2:], 3)
        records = read_metrics(tmp_path / str(side))
        epoch_mse[side] = [r["train_mse_epoch"] for r in records if "train_mse_epoch" in r]
        assert any("equivariance_err_translation" in r for r in records) == side
        assert len([r for r in records if "rollout_figure" in r]) == (3 if side else 0)
    assert len(epoch_mse[True]) == 3
    assert epoch_mse[True] == epoch_mse[False]


def test_visualize_epoch_writes_its_png(tmp_path):
    data = ns_batches(2, seed=20)
    cfg = small_config(tmp_path)
    trainer = make_trainer(cfg)
    loop = TrainLoop(trainer, data[:1], data[1:])
    path = loop.visualize_epoch(trainer.init_state(), epoch=7)
    assert path == str(tmp_path / "figures" / "rollout_epoch00007.png")
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    assert read_metrics(tmp_path)[-1]["rollout_figure"] == path


# ----------------------------------------------------------------- the fit CLI


def fill_cache(root, group: str, n: int, seed: int):
    """Short solver runs at the dataset's 64 x 64 grid and 20 frames, written by the cache."""
    cache = TrajectoryCache(os.path.join(root, "navier_stokes", group), None)
    w0 = GaussianRF2D(64).sample(range(seed, seed + n), "cpu")
    snaps, _ = navier_stokes_rollout(w0, default_forcing(64, "cpu"), 1e-3, 1e-2, 20, 2)
    for i, traj in enumerate(snaps[..., None].numpy()):
        cache.write(i, traj)


def test_fit_main_trains_checkpoints_and_resumes(tmp_path):
    data_dir, log_dir = tmp_path / "data", tmp_path / "run"
    fill_cache(data_dir, "train", 4, seed=0)
    fill_cache(data_dir, "test", 2, seed=100)
    over = [f"{k}={v}" for k, v in SMALL.items() if not k.startswith("training.")]
    over += ["training.max_num_sampled_points=256", "training.nef.train_until_epoch=1",
             "training.ode.train_from_epoch=1", "training.ode.train_until_epoch=2",
             "training.num_epochs=2", "dataset.num_signals_train=4", "dataset.num_signals_test=2",
             f"dataset.path={data_dir}", f"logging.log_dir={log_dir}", "test.test_interval=2",
             "test.test_equiv_at_epoch=0", "logging.checkpoint_every_n_epochs=1",
             "logging.keep_n_checkpoints=2"]
    fit_main(["navier_stokes", *over, "--device", "cpu"])
    records = read_metrics(log_dir)
    keys = set().union(*records)
    want = {"t", "step", "mse_step", "step_time_s", "steps_per_sec", "epoch", "train_mse_epoch",
            "phase", "train_backend", "eval_backend", "ode_backend", "train_wall_s",
            "val_mse_in_t", "val_mse_out_t", "train_mse_in_t", "train_mse_out_t",
            "equivariance_err_translation", "train_data_path", "val_data_path"}
    assert keys == want
    assert (records[0]["train_data_path"], records[0]["val_data_path"]) == ("device_cache", "device_cache")
    assert [r["phase"] for r in records if "phase" in r] == ["nef", "ode"]
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["1", "2"]
    assert all(np.isfinite(v) for r in records for k, v in r.items() if "mse" in k or "err" in k)

    fit_main(["navier_stokes", *over, "training.num_epochs=3", "training.ode.train_until_epoch=3",
              "logging.resume=true", "--device", "cpu"])
    resumed = read_metrics(log_dir)[len(records):]
    assert [(r["epoch"], r["phase"]) for r in resumed if "phase" in r] == [(3, "ode")]
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["2", "3"]

    cfg = load_experiment_config("navier_stokes", over)
    with pytest.raises(NotImplementedError, match="wandb"):
        run_experiment(load_experiment_config("navier_stokes", [*over, "logging.use_wandb=true"]), device="cpu")
    # meta.meta_sgd=false trains by autodecoding (tests/test_torch_autodecode.py): a latent
    # table with a row for each training signal, no meta-SGD learning rates.
    _, state = run_experiment(load_experiment_config(
        "navier_stokes", [*over, "meta.meta_sgd=false", f"logging.log_dir={tmp_path / 'ad'}"]), device="cpu")
    assert state["autodecoder"]["a"].shape == (4, cfg.nef.num_latents, cfg.nef.latent_dim)
    assert set(state) == {"autodecoder", "opt"}
    assert cfg.dataset.path == str(data_dir)
