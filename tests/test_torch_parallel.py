"""Data-parallel training and coordinate-sharded decode (``parallel/mesh.py``) on the CPU.

Worlds of 2 and 4 gloo processes (``torch.multiprocessing``, joined through a
``file://`` rendezvous in the test's directory, so parallel test workers never share a
port) run the port's steps and decodes; each world starts once per test and runs
several checks, whose results come back through files. They are held against:

- one process on the whole batch: the nef / ode / dual steps' losses and every
  gradient group (rtol 1e-5, atol 1e-7: f32 rounding of sums taken in another order),
  with the draws handed in and with the draws from the generator and the position
  noise on; the loop's validation MSEs;
- JAX's ``shard_train_step`` on a CPU mesh of the same size, with JAX's draws handed
  in: losses rtol 1e-4, gradients rtol 2e-4 / atol 2e-5, as ``test_torch_train.py``;
- each other: parameters, optimizer states and generators equal on every rank after
  three updates (nef, ode, dual, from the drawn comparison's gradients) and a dual step
  through ``shard_train_step``;
- the unsharded decode (atol 1e-6) and JAX's ``sharded_decode``; ``val_step`` with a
  coordinate mesh against the chunked one; ``Forecaster`` at W = 2 against W = 1;
- the fit CLI run in one process: ``fit.main`` in a world of 2 writes the same metrics
  (rtol 1e-5), one ``metrics.jsonl``, and checkpoints from rank 0 only.

The workers import this module, so JAX is imported inside the tests that use it.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from chip_smoke import smooth_trajectories
from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.experiments import fit
from enf_pde_tpu_torch.inference import Forecaster
from enf_pde_tpu_torch.parallel.mesh import (
    all_gather,
    data_sharding,
    make_mesh,
    mean_over_ranks,
    on_rank0,
    replicate,
    shard_batch,
    shard_train_step,
    sharded_decode,
)
from enf_pde_tpu_torch.train.checkpoint import CheckpointManager
from enf_pde_tpu_torch.train.logging import NullLogger
from enf_pde_tpu_torch.train.loop import TrainLoop
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer

torch.set_num_threads(1)

SIZE, BATCH, FRAMES = 8, 4, 5
NOISE = 0.05  # meta.noise_pos_inner_loop of the generator-drawn steps (cahn_hilliard's)
RTOL_W, ATOL_W = 1e-5, 1e-7
LOSS_RTOL, RTOL, ATOL = 1e-4, 2e-4, 2e-5
KINDS = ("nef", "ode", "dual")


# ----------------------------------------------------------------- worlds


def _world(rank, size, init_file, task, payload_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=size)
    try:
        result = _TASKS[task](make_mesh("cpu"), torch.load(payload_file, weights_only=False))
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(tmp_path, size: int, task: str, payload: dict) -> list:
    """Run ``task`` in a gloo world of ``size``; returns each rank's result."""
    run_dir = tmp_path / f"{task}_w{size}"
    run_dir.mkdir()
    torch.save(payload, run_dir / "payload.pt")
    mp.spawn(_world, args=(size, str(run_dir / "pg"), task, str(run_dir / "payload.pt"), str(run_dir)),
             nprocs=size, join=True)
    return [torch.load(run_dir / f"rank{r}.pt", weights_only=False) for r in range(size)]


def make_trainer(cfg_dict: dict, params: dict, **kw):
    cfg = Config(cfg_dict)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), seed=0, device="cpu", **kw)
    return tr, tr.load_state(params)


def step_grads(tr, state, x, draws) -> dict:
    """{kind: (loss, grads)} of the three steps, with ``draws`` handed in (or drawn)."""
    return {"nef": tr.nef_grads(state, x, draws.get("frame_idx"), draws.get("nef_masks")),
            "ode": tr.ode_grads(state, x, draws.get("masks"), draws.get("ode_masks")),
            "dual": tr.dual_grads(state, x, draws.get("masks"), draws.get("ode_masks"))}


def train_three(tr, state, x) -> dict:
    """The three steps' {kind: (loss, grads)} at one state with the generator's draws,
    then their three updates (nef, ode, dual) applied in turn. Gradients are compared
    at one state: after an Adam update a gradient's rounding moves the next state."""
    out = step_grads(tr, state, x, {})
    tr._update_nef(state, out["nef"][1])
    tr._update_ode(state, out["ode"][1])
    tr._update_nef(state, out["dual"][1])
    tr._update_ode(state, out["dual"][1])
    return out


def snapshot(tr, state) -> dict:
    flat = {f"nef.{k}": v for k, v in tr.nef_group().items()}
    flat.update({f"ode.{k}": v for k, v in tr.ode_group().items()})
    for g in ("autodecoder", "meta_sgd_lrs"):
        flat.update({f"{g}.{k}": v for k, v in state[g].items()})
    for g, opt in state["opt"].items():
        for part in ("mu", "nu"):
            flat.update({f"opt.{g}.{part}.{k}": v for k, v in opt.get(part, {}).items()})
    flat["generator"] = tr.generator.get_state()
    return {k: v.detach().clone() for k, v in flat.items()}


def _steps_task(mesh, pl):
    out = {}
    tr, state = make_trainer(pl["cfg"], pl["params"], mesh=mesh)
    x = shard_batch(torch.from_numpy(pl["traj"]), mesh)
    out["handed"] = step_grads(tr, state, x, pl["draws"])
    tr, state = make_trainer(pl["noise_cfg"], pl["params"], mesh=mesh)
    out["drawn"] = train_three(tr, state, x)
    out["step_loss"], state = shard_train_step(tr.dual_train_step, mesh)(state, torch.from_numpy(pl["traj"]))
    out["after"] = snapshot(tr, state)
    loop = TrainLoop(tr, [], [pl["traj"]], logger=NullLogger("unused"))
    out["val"] = loop._eval_loader(state, [pl["traj"]], tr.val_step, 7)
    try:
        shard_batch(torch.zeros(BATCH - 1, 2), mesh)
    except ValueError as e:
        out["ragged"] = str(e)
    return out


def _decode_task(mesh, pl):
    out = {}
    tr, state = make_trainer(pl["cfg"], pl["params"], coord_mesh=mesh)
    out["decode"] = tr.decode(pl["latent_traj"])
    with torch.no_grad():
        out["decode_eager"] = sharded_decode(tr.decoder, mesh)(*pl["decoder_args"])
    out["val"] = tr.val_step(state, torch.from_numpy(pl["traj"]), batch_idx=3)
    fc = Forecaster(Config(pl["cfg"]), planar_coords(SIZE, SIZE), pl["params"], device="cpu")
    out["forecast_sharded"] = fc.trainer.coord_mesh is not None
    out["forecast"] = fc.forecast(pl["traj"][:, 0], num_frames=FRAMES)
    return out


def _fit_task(mesh, pl):
    saves = []
    real_save = CheckpointManager.save
    CheckpointManager.save = lambda self, epoch, *a, **kw: saves.append(epoch) or real_save(self, epoch, *a, **kw)
    os.environ["WORLD_SIZE"] = str(mesh.size)
    fit.main(pl["argv"])
    return {"saves": saves}


_TASKS = {"steps": _steps_task, "decode": _decode_task, "fit": _fit_task}


# ----------------------------------------------------------------- references


def assert_close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def compare_steps(got: dict, want: dict, rtol, atol, loss_rtol):
    for kind in KINDS:
        (loss, grads), (want_loss, want_grads) = got[kind], want[kind]
        assert_close(loss, want_loss, rtol=loss_rtol, atol=0)
        assert set(grads) == set(want_grads), kind
        for g in want_grads:
            assert set(grads[g]) == set(want_grads[g]), (kind, g)
            for k, w in want_grads[g].items():
                assert_close(grads[g][k], np.asarray(w).reshape(grads[g][k].shape), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def setup():
    """The JAX trainer's initial state (ODE readouts scaled as in ``test_torch_train``),
    converted; the port's config; the draws JAX's steps take from their keys."""
    import jax

    from enf_pde_tpu.builders import build_models as jax_build_models
    from enf_pde_tpu.config import load_experiment_config as jax_load_config
    from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer
    from enf_pde_tpu_torch.convert import convert_params
    from tests.test_torch_modules import np_tree
    from tests.test_torch_train import OVERRIDES, inner_masks, ode_draws

    jcfg = jax_load_config("navier_stokes", [f"{k}={v}" for k, v in OVERRIDES.items()])
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), planar_coords(SIZE, SIZE), seed=0)
    jstate = jtr.init_state()
    ode = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if "Dense_3" in str(path) or "Dense_4" in str(path) else v,
        jstate.params["ode"])
    jparams = {**jstate.params, "ode": ode}
    cfg = load_experiment_config("navier_stokes")
    for k, v in OVERRIDES.items():
        cfg.set_path(k, v)
    noise_cfg = Config(cfg.to_dict())
    noise_cfg.set_path("meta.noise_pos_inner_loop", NOISE)
    # One key for the ode and the dual step, so that one set of draws serves both.
    keys = {"nef": jax.random.PRNGKey(5), "ode": jax.random.PRNGKey(6), "dual": jax.random.PRNGKey(6)}
    k_sel, k_inner = jax.random.split(keys["nef"])
    draws = {"frame_idx": np.asarray(jax.random.permutation(k_sel, cfg.dataset.traj_len_train)[:2]),
             "nef_masks": inner_masks(jtr.cfg, k_inner, SIZE * SIZE)}
    draws["masks"], draws["ode_masks"] = ode_draws(jtr, keys["ode"])
    return {"jtr": jtr, "jparams": jparams, "keys": keys, "draws": draws,
            "cfg": cfg.to_dict(), "noise_cfg": noise_cfg.to_dict(),
            "params": convert_params(np_tree(jparams)),
            "traj": smooth_trajectories(BATCH, FRAMES, SIZE, seed=7)}


def jax_sharded_steps(setup, size: int) -> dict:
    """JAX's three steps' (loss, grads) through ``shard_train_step`` on a CPU mesh of ``size``."""
    import jax
    import jax.numpy as jnp

    from enf_pde_tpu.parallel import make_mesh as jax_make_mesh
    from enf_pde_tpu.parallel import shard_train_step as jax_shard_train_step
    from enf_pde_tpu_torch.convert import flax_to_state_dict
    from tests.test_torch_modules import np_tree

    convert = {"nef": lambda t: flax_to_state_dict(np_tree(t)), "ode": lambda t: flax_to_state_dict(np_tree(t)),
               "meta_sgd_lrs": np_tree, "autodecoder": np_tree}
    jtr, params, keys = setup["jtr"], setup["jparams"], setup["keys"]
    mesh = jax_make_mesh(size)
    fns = {
        "nef": lambda prm, tr: jax.value_and_grad(jtr._nef_loss)(prm, tr, keys["nef"]),
        "ode": lambda prm, tr: jax.value_and_grad(
            lambda op: jtr._ode_loss(dict(prm, ode=op), tr, keys["ode"]))(prm["ode"]),
        "dual": lambda prm, tr: jax.value_and_grad(jtr._ode_loss)(prm, tr, keys["dual"]),
    }
    out = {}
    for kind, fn in fns.items():
        loss, grads = jax_shard_train_step(fn, mesh)(jax.tree.map(jnp.copy, params),
                                                     jnp.asarray(setup["traj"]))
        grads = {"ode": grads} if kind == "ode" else grads
        groups = {"nef": ("nef", "meta_sgd_lrs", "autodecoder"), "ode": ("ode",),
                  "dual": ("nef", "meta_sgd_lrs", "autodecoder", "ode")}[kind]
        out[kind] = (loss, {g: convert[g](grads[g]) for g in groups})
    return out


def single_process(setup) -> dict:
    tr, state = make_trainer(setup["cfg"], setup["params"])
    x = torch.from_numpy(setup["traj"])
    out = {"handed": step_grads(tr, state, x, setup["draws"])}
    tr, state = make_trainer(setup["noise_cfg"], setup["params"])
    out["drawn"] = train_three(tr, state, x)
    out["step_loss"], _ = tr.dual_train_step(state, x)
    out["val"] = TrainLoop(tr, [], [setup["traj"]], logger=NullLogger("unused"))._eval_loader(
        state, [setup["traj"]], tr.val_step, 7)
    return out


@pytest.fixture(scope="module")
def single(setup):
    return single_process(setup)


# ----------------------------------------------------------------- tests


def test_make_mesh_without_a_group_is_a_world_of_one():
    assert not dist.is_initialized()
    mesh = make_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device, mesh.is_main) == (None, 0, 1, torch.device("cpu"), True)
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(shard_batch(x.numpy(), mesh), x)
    assert data_sharding(mesh, 5) == slice(0, 5)
    decode = sharded_decode(lambda c, s: c * s, mesh)
    assert torch.equal(decode(x, 2.0), 2 * x)


def test_a_world_of_one_without_a_group_makes_no_collective_call():
    mesh = make_mesh("cpu")
    x, y = torch.ones(3), torch.arange(4.0)
    assert replicate({"x": x}, mesh)["x"] is x
    assert mean_over_ranks([x, y], mesh) == [x, y]
    assert all_gather(y, mesh, dim=0) is y
    assert on_rank0(lambda: 7, mesh) == 7 and on_rank0(lambda: 8, None) == 8
    step = shard_train_step(lambda state, batch, **kw: (batch.sum(), state), mesh)
    assert float(step({}, x)[0]) == 3.0


def test_a_trainer_shards_its_batches_or_its_coordinates_not_both():
    cfg = load_experiment_config("navier_stokes")
    mesh = make_mesh("cpu")
    with pytest.raises(ValueError, match="not both"):
        MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), device="cpu", mesh=mesh,
                       coord_mesh=mesh)


@pytest.mark.parametrize("size", [2, 4])
def test_data_parallel_steps_equal_one_process_and_jax(tmp_path, setup, single, size):
    ranks = run_world(tmp_path, size, "steps", {k: setup[k] for k in ("cfg", "noise_cfg", "params", "traj", "draws")})
    for r in ranks:  # every rank holds the global loss and gradients
        compare_steps(r["handed"], single["handed"], RTOL_W, ATOL_W, RTOL_W)
        compare_steps(r["drawn"], single["drawn"], RTOL_W, ATOL_W, RTOL_W)
        assert_close(torch.tensor(r["val"]), torch.tensor(single["val"]), rtol=RTOL_W, atol=0)
        # A fourth step through shard_train_step, which takes the global batch.
        assert_close(r["step_loss"], single["step_loss"], rtol=RTOL_W, atol=0)
        assert r["ragged"] == f"a batch of {BATCH - 1} does not divide over a world of {size} ranks"
    # The noise moves the drawn steps away from the handed-in ones, on every rank alike.
    assert float(ranks[0]["drawn"]["nef"][0]) != float(ranks[0]["handed"]["nef"][0])
    compare_steps(ranks[0]["handed"], jax_sharded_steps(setup, size), RTOL, ATOL, LOSS_RTOL)
    first = ranks[0]["after"]
    for r in ranks[1:]:
        assert set(r["after"]) == set(first)
        assert all(torch.equal(r["after"][k], first[k]) for k in first)
    assert any(k.startswith("opt.ode.mu") for k in first) and len(first) > 40


def test_coordinate_sharded_decode_equals_the_unsharded_and_jax(tmp_path, setup):
    import jax.numpy as jnp

    from enf_pde_tpu.parallel import make_mesh as jax_make_mesh
    from enf_pde_tpu.parallel import sharded_decode as jax_sharded_decode

    tr, state = make_trainer(setup["cfg"], setup["params"])
    gen = torch.Generator().manual_seed(3)
    b, T, Z = 2, 3, tr.cfg.nef.num_latents
    latent_traj = ((torch.rand(b, T, Z, 2, generator=gen) * 2 - 1),
                   1 + 0.5 * torch.randn(b, T, Z, tr.cfg.nef.latent_dim, generator=gen),
                   torch.full((b, T, Z, 1), 0.7))
    flat = [x.reshape(b * T, *x.shape[2:]) for x in latent_traj]
    coords = torch.from_numpy(planar_coords(SIZE, SIZE))[None].expand(b * T, -1, -1).contiguous()
    payload = {k: setup[k] for k in ("cfg", "params", "traj")}
    payload.update(latent_traj=latent_traj, decoder_args=(coords, *flat))
    ranks = run_world(tmp_path, 2, "decode", payload)

    with torch.no_grad():
        want = tr.decode(latent_traj)
        want_eager = tr.decoder(coords, *flat)
    want_val = tr.val_step(state, torch.from_numpy(setup["traj"]), batch_idx=3)
    fc = Forecaster(tr.cfg, planar_coords(SIZE, SIZE), setup["params"], device="cpu")
    want_fc = fc.forecast(setup["traj"][:, 0], num_frames=FRAMES)
    jtr, jparams = setup["jtr"], setup["jparams"]
    jax_out = jax_sharded_decode(jtr.decoder.apply, jax_make_mesh(2))(
        jparams["nef"], *(jnp.asarray(x.numpy()) for x in (coords, *flat)))
    for r in ranks:
        assert r["decode"].shape == want.shape == (b, T, SIZE * SIZE, 1)
        assert_close(r["decode"], want, rtol=0, atol=1e-6)
        assert_close(r["decode_eager"], want_eager, rtol=0, atol=1e-6)
        assert_close(r["decode_eager"], np.asarray(jax_out), rtol=1e-4, atol=2e-5)
        assert_close(torch.stack(r["val"]), torch.stack(want_val), rtol=1e-5, atol=0)
        assert r["forecast_sharded"] and fc.trainer.coord_mesh is None
        assert_close(r["forecast"], want_fc, rtol=0, atol=1e-6)


def test_fit_cli_in_a_world_of_two_equals_one_process(tmp_path):
    from tests.test_torch_fit import SMALL, fill_cache, read_metrics

    data_dir = tmp_path / "data"
    fill_cache(data_dir, "train", 4, seed=0)
    fill_cache(data_dir, "test", 2, seed=100)
    over = [f"{k}={v}" for k, v in SMALL.items() if not k.startswith("training.")]
    over += ["training.max_num_sampled_points=256", "training.nef.train_until_epoch=1",
             "training.ode.train_from_epoch=1", "training.ode.train_until_epoch=2",
             "training.num_epochs=2", "dataset.num_signals_train=4", "dataset.num_signals_test=2",
             f"dataset.path={data_dir}", "test.test_interval=2", "test.test_equiv_at_epoch=0",
             "logging.checkpoint_every_n_epochs=1", "logging.keep_n_checkpoints=2",
             "meta.noise_pos_inner_loop=0.05"]
    fit.main(["navier_stokes", *over, f"logging.log_dir={tmp_path / 'w1'}", "--device", "cpu"])
    ranks = run_world(tmp_path, 2, "fit", {"argv": ["navier_stokes", *over, f"logging.log_dir={tmp_path / 'w2'}",
                                                    "--device", "cpu"]})
    one, two = read_metrics(tmp_path / "w1"), read_metrics(tmp_path / "w2")
    assert [set(r) for r in two] == [set(r) for r in one]
    for a, b in zip(two, one):
        for k, v in b.items():
            if k.startswith("equivariance_err"):  # f32 rounding of the decode: its own scale
                assert abs(a[k] - v) < 1e-5, k
            elif k not in ("t", "step_time_s", "steps_per_sec", "train_wall_s") and isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=1e-5), k
    assert [r["phase"] for r in two if "phase" in r] == ["nef", "ode"]
    assert any("equivariance_err_translation" in r for r in two)  # rank 0 ran it
    assert [r["saves"] for r in ranks] == [[1, 2], []]
    assert sorted(os.listdir(tmp_path / "w2" / "checkpoints")) == ["1", "2"]
    assert sorted(os.listdir(tmp_path / "w2")) == ["checkpoints", "metrics.jsonl"]
    assert json.loads((tmp_path / "w2" / "metrics.jsonl").read_text().splitlines()[0])["train_data_path"] == \
        "device_cache"
