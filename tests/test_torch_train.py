"""The port's training path against the JAX package's, on the CPU.

The JAX trainer's initial state is converted into the port's trainer; both then see
the same trajectories and the same random draws: the JAX steps draw with
``jax.random`` from a key, so these tests recompute those draws from the key (frame
indices, inner-loop masks, the rollout loss's coordinate subsets, the dp subsets)
and hand them to the port. Gradients are compared, not parameters after a step:
Adam's first step is about ``sign(g) * lr``, so a near-zero gradient could flip it.
The port's rollout decode runs ``FusedDecode`` (``nef.ode_backend: pallas``), which
on the CPU runs the plain versions of K1 and K2; the JAX side runs its XLA
composition of the same math. Navier-Stokes config at small width (hidden 16,
8 x 8 grid, 3 training frames, 2 inner steps, 1 PONITA layer). Losses rtol 1e-4, gradients rtol 2e-4 / atol 2e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.train.inner_loop import sample_coordinate_masks
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer

from chip_smoke import smooth_trajectories
from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.convert import convert_params, flax_to_state_dict
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.train.loop import TrainLoop
from enf_pde_tpu_torch.train.meta_sgd import VAL_DP, MetaSGDTrainer
from enf_pde_tpu_torch.train.state import Adam, clip_by_global_norm, make_optimizers
from tests.test_torch_modules import assert_close, np_tree

torch.set_num_threads(1)

SIZE, BATCH, FRAMES = 8, 2, 5
LOSS_RTOL, RTOL, ATOL = 1e-4, 2e-4, 2e-5
OVERRIDES = {
    "nef.num_hidden": 16,
    "node.num_hidden": 16,
    "node.basis_dim": 8,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "training.max_num_sampled_points": 24,
    "dataset.traj_len_train": 3,
}


def port_config(**extra):
    cfg = load_experiment_config("navier_stokes")
    for k, v in {**OVERRIDES, **extra}.items():
        cfg.set_path(k, v)
    return cfg


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, its state, port trainer with that state, port state, trajectories)."""
    jcfg = jax_load_config("navier_stokes", [f"{k}={v}" for k, v in OVERRIDES.items()])
    coords = planar_coords(SIZE, SIZE)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    # Scale the ODE readouts (initialised at 1e-6) so the rollout moves the latents.
    ode = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if "Dense_3" in str(path) or "Dense_4" in str(path) else v,
        jstate.params["ode"])
    jstate = jstate.replace(params={**jstate.params, "ode": ode})
    cfg = port_config()
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    traj = smooth_trajectories(BATCH, FRAMES, SIZE, seed=7)
    return jtr, jstate, tr, state, traj


def inner_masks(cfg, key, num_coords):
    """The masks JAX's inner loop draws from ``key`` (K + 1 rows)."""
    _, k_mask, _ = jax.random.split(key, 3)
    return np.asarray(sample_coordinate_masks(
        k_mask, num_coords, cfg.meta.num_inner_steps + 1, cfg.training.max_num_sampled_points))


def port_grads(tree):
    """A JAX gradient tree of the trainer's params in the port's naming."""
    return {
        "nef": flax_to_state_dict(np_tree(tree["nef"])),
        "ode": flax_to_state_dict(np_tree(tree["ode"])),
        "meta_sgd_lrs": np_tree(tree["meta_sgd_lrs"]),
        "autodecoder": np_tree(tree["autodecoder"]),
    }


def compare_grads(got, want, groups):
    nonzero = 0
    for g in groups:
        assert set(got[g]) == set(want[g]), g
        for k, w in want[g].items():
            w = np.asarray(w)
            nonzero += bool(np.abs(w).max() > 0)
            assert_close(got[g][k], w.reshape(got[g][k].shape), rtol=RTOL, atol=ATOL)
    return nonzero


# ----------------------------------------------------------------- optimizers


@pytest.mark.parametrize("scale", [0.1, 10.0])  # the clip off / on
def test_adamw_with_clip_matches_optax(scale):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "coefficients": rng.standard_normal((2, 5)).astype(np.float32)}
    grads = [{"w": scale * rng.standard_normal((4, 3)).astype(np.float32),
              "coefficients": np.zeros((2, 5), np.float32)} for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2, weight_decay=0.5))
    jp, js = params, tx.init(params)
    opt = Adam(1e-2, weight_decay=0.5, clip_norm=1.0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for step, g in enumerate(grads):
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.update({"w": torch.from_numpy(g["w"])}, ts, tp)  # no gradient: the buffer
        for k in params:
            assert_close(tp[k], jp[k], rtol=1e-5, atol=1e-7)
        if step == 0:
            # The zero-gradient coefficients decay by lr * wd: (1 - 5e-3) * coeff.
            assert_close(tp["coefficients"], params["coefficients"] * (1 - 1e-2 * 0.5), rtol=1e-6)
    assert ts["count"] == 3


def test_adam_and_clip_match_optax():
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal(6).astype(np.float32)}
    tx, opt = optax.adam(1e-3), Adam(1e-3)
    jp, js = params, tx.init(params)
    tp = {"a": torch.from_numpy(params["a"].copy())}
    ts = opt.init(tp)
    for _ in range(3):
        g = {"a": rng.standard_normal(6).astype(np.float32)}
        upd, js = tx.update(g, js)
        jp = optax.apply_updates(jp, upd)
        ts = opt.update({"a": torch.from_numpy(g["a"])}, ts, tp)
    assert_close(tp["a"], jp["a"], rtol=1e-5, atol=1e-7)
    g = {"x": np.full(4, 3.0, np.float32), "y": np.full(2, 4.0, np.float32)}
    want = optax.clip_by_global_norm(1.0).update(g, None)[0]
    got = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    for k in g:
        assert_close(got[k], want[k], rtol=1e-6)


def test_optimizers_follow_the_config():
    opts = make_optimizers(port_config(**{"optimizer.weight_decay_ode": 3e-3}))
    assert (opts["nef"].lr, opts["nef"].weight_decay, opts["nef"].clip_norm) == (1e-4, 1e-4, 1.0)
    assert (opts["ode"].lr, opts["ode"].weight_decay, opts["ode"].clip_norm) == (1e-4, 3e-3, 1.0)
    assert (opts["meta_sgd"].lr, opts["meta_sgd"].weight_decay, opts["meta_sgd"].clip_norm) == (1e-4, 0.0, None)
    assert opts["autodecoder"].lr == 0.0


# ----------------------------------------------------------------- inner loop and losses


def test_train_inner_loop_query_loss_and_fit_match_jax(pair):
    """The training form's query loss (held-out row K) and fitted latents; its
    second-order gradients are held against JAX's by the nef-loss test below."""
    jtr, jstate, tr, state, traj = pair
    frames = traj[:, 0]
    key = jax.random.PRNGKey(3)
    masks = inner_masks(jtr.cfg, key, SIZE * SIZE)
    p = jstate.params
    want_loss, want_fit = jax.jit(jtr.inner_loop)(p["nef"], p["meta_sgd_lrs"], p["autodecoder"],
                                                 jnp.asarray(frames), key)
    lrs = {k: v.detach().requires_grad_(True) for k, v in state["meta_sgd_lrs"].items()}
    init = {k: v.detach().requires_grad_(True) for k, v in state["autodecoder"].items()}
    loss, fitted = tr.train_inner_loop(lrs, init, torch.from_numpy(frames), masks=masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    for k in want_fit:
        assert_close(fitted[k], want_fit[k], rtol=1e-3, atol=1e-5)  # as the forecast's fit
    # Second order: the graph reaches the decoder through the inner gradients too.
    assert loss.requires_grad and fitted["a"].grad_fn is not None


def test_nef_loss_and_grads_match_jax(pair):
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(5)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._nef_loss))(jstate.params, jnp.asarray(traj), rng)
    k_sel, k_inner = jax.random.split(rng)
    frame_idx = np.asarray(jax.random.permutation(k_sel, jtr.cfg.dataset.traj_len_train)[:2])
    masks = inner_masks(jtr.cfg, k_inner, SIZE * SIZE)
    loss, got = tr.nef_grads(state, torch.from_numpy(traj), frame_idx=frame_idx, masks=masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare_grads(got, port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder")) > 10


def ode_draws(jtr, rng):
    k_inner, k_mask = jax.random.split(rng)
    T, N, M = jtr.cfg.dataset.traj_len_train, SIZE * SIZE, jtr.cfg.training.max_num_sampled_points
    ode_masks = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, N)[:M])(jax.random.split(k_mask, T)))
    return inner_masks(jtr.cfg, k_inner, N), ode_masks


def test_ode_loss_and_ode_grads_match_jax(pair):
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(6)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda op: jtr._ode_loss(dict(jstate.params, ode=op), jnp.asarray(traj), rng)
    ))(jstate.params["ode"])
    masks, ode_masks = ode_draws(jtr, rng)
    loss, got = tr.ode_grads(state, torch.from_numpy(traj), masks=masks, ode_masks=ode_masks)
    assert set(got) == {"ode"}
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare_grads(got, {"ode": flax_to_state_dict(np_tree(want))}, ("ode",)) > 10
    assert all(q.requires_grad for q in tr.decoder.parameters())  # unfrozen again


def test_dual_loss_and_grads_match_jax(pair):
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(8)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._ode_loss))(jstate.params, jnp.asarray(traj), rng)
    masks, ode_masks = ode_draws(jtr, rng)
    loss, got = tr.dual_grads(state, torch.from_numpy(traj), masks=masks, ode_masks=ode_masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare_grads(got, port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder", "ode")) > 20


@pytest.mark.parametrize("dp", [0.0, 0.5])
def test_val_step_matches_jax(pair, dp):
    jtr, jstate, tr, state, traj = pair
    want_in, want_out = jtr.val_step_dp[dp](jstate, jnp.asarray(traj), 3) if dp else jtr.val_step(
        jstate, jnp.asarray(traj), 3)
    k_dp, k_mask, _ = jax.random.split(jax.random.fold_in(jstate.rng, 3), 3)
    keep = np.asarray(jax.random.permutation(k_dp, SIZE * SIZE)[:int(SIZE * SIZE * dp)]) if dp else None
    masks = np.asarray(sample_coordinate_masks(
        k_mask, len(keep) if dp else SIZE * SIZE, jtr.cfg.meta.num_inner_steps + 1,
        jtr.cfg.training.max_num_sampled_points))
    got_in, got_out = tr.val_step(state, torch.from_numpy(traj), dp=dp, masks=masks, keep=keep)
    assert float(want_out) > 0  # the out horizon (frames 3-4) is scored
    assert_close(got_in, want_in, rtol=1e-3, atol=1e-6)  # 3 inner steps + a rollout, as the forecast
    assert_close(got_out, want_out, rtol=1e-3, atol=1e-6)


def test_steps_update_their_groups(pair):
    """Each step moves what JAX's moves, and only that; the meta lrs stay clipped."""
    _, _, tr, _, traj = pair
    state = tr.init_state()
    snap = lambda: {k: v.detach().clone() for k, v in  # noqa: E731
                    {**{f"nef.{n}": t for n, t in tr.nef_group().items()},
                     **{f"ode.{n}": t for n, t in tr.ode_group().items()},
                     **{f"lrs.{n}": t for n, t in state["meta_sgd_lrs"].items()},
                     **{f"ad.{n}": t for n, t in state["autodecoder"].items()}}.items()}
    x = torch.from_numpy(traj)
    for step, moves in ((tr.nef_train_step, {"nef", "lrs"}), (tr.ode_train_step, {"ode"}),
                        (tr.dual_train_step, {"nef", "lrs", "ode"})):
        before = snap()
        loss, state = step(state, x)
        after = snap()
        assert loss.ndim == 0 and torch.isfinite(loss)
        moved = {k.split(".")[0] for k in before if not torch.equal(before[k], after[k])}
        assert moved == moves, step.__name__
        assert all(float(v.min()) >= np.float32(1e-6) for v in state["meta_sgd_lrs"].values())
    # The RFF coefficients (buffers) are in the decoder's AdamW group, as JAX's params.
    assert state["opt"]["nef"]["count"] == 2 and state["opt"]["ode"]["count"] == 2
    assert {k for k in state["opt"]["nef"]["mu"] if k.endswith("coefficients")} == {
        "cross_attention_block.attn.invariant_embedding_query.RFFEmbedding_0.coefficients",
        "cross_attention_block.attn.invariant_embedding_value.RFFEmbedding_0.coefficients"}


# ----------------------------------------------------------------- schedule and loop


@pytest.mark.parametrize("epoch", [1, 2, 3, 4])
def test_phase_schedule_matches_jax(pair, epoch):
    jtr, _, _, _, _ = pair
    over = {"training.nef.train_until_epoch": 2, "training.ode.train_from_epoch": 1,
            "training.ode.train_until_epoch": 3}
    jcfg = jax_load_config("navier_stokes", [f"{k}={v}" for k, v in {**OVERRIDES, **over}.items()])
    jt = JaxTrainer(jcfg, *jax_build_models(jcfg), planar_coords(SIZE, SIZE), seed=0)
    cfg = port_config(**over)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), seed=0, device="cpu")
    assert tr.phase_window(epoch) == jt.phase_window(epoch)
    assert tr.phase_active(epoch) == jt.phase_active(epoch)
    if not tr.phase_active(epoch):
        with pytest.raises(ValueError, match="No training phase"):
            tr.select_train_step(epoch)
        return
    fn, nef, ode = tr.select_train_step(epoch)
    jfn, jnef, jode = jt.select_train_step(epoch)
    assert (nef, ode) == (jnef, jode)
    assert fn.__name__ == {jt.nef_train_step: "nef_train_step", jt.ode_train_step: "ode_train_step",
                           jt.dual_train_step: "dual_train_step"}[jfn]


def test_train_loop_run_writes_jax_metric_names(tmp_path):
    over = {"training.nef.train_until_epoch": 2, "training.ode.train_from_epoch": 1,
            "training.ode.train_until_epoch": 3, "test.test_interval": 3,
            "test.test_dp_interval": 3, "logging.log_every_n_steps": 1,
            "logging.log_dir": str(tmp_path), "dataset.batch_size": BATCH}
    cfg = port_config(**over)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), seed=0, device="cpu")
    data = smooth_trajectories(3 * BATCH, FRAMES, SIZE, seed=9)
    loop = TrainLoop(tr, [data[:BATCH], data[BATCH:2 * BATCH]], [data[2 * BATCH:]])
    loop.run(4)  # epoch 4 has no phase: the loop stops cleanly after epoch 3
    records = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    keys = set().union(*records)
    tags = [""] + [f"_dp{int(dp * 100)}" for dp in VAL_DP]
    want = {"t", "step", "mse_step", "step_time_s", "steps_per_sec", "epoch", "train_mse_epoch",
            "phase", "train_backend", "eval_backend", "ode_backend", "schedule_exhausted_at_epoch",
            "train_wall_s"}
    want |= {f"{s}_mse_{io}_t{tag}" for s in ("val", "train") for io in ("in", "out") for tag in tags}
    assert keys == want
    assert [r["phase"] for r in records if "phase" in r] == ["nef", "nef+ode", "ode"]
    assert all(np.isfinite(v) for r in records for k, v in r.items() if "mse" in k)
    assert loop.global_step == 6


# ----------------------------------------------------------------- validation draws


def test_validation_leaves_the_training_draws_alone(tmp_path):
    """A run that validates every epoch trains exactly as a run that never validates."""
    over = {"training.nef.train_until_epoch": 2, "training.ode.train_from_epoch": 1,
            "training.ode.train_until_epoch": 3, "test.test_dp_interval": 1000,
            "dataset.batch_size": BATCH}
    data = smooth_trajectories(3 * BATCH, FRAMES, SIZE, seed=9)
    epoch_mse = {}
    for interval in (1, 1000):
        cfg = port_config(**over, **{"test.test_interval": interval,
                                     "logging.log_dir": str(tmp_path / str(interval))})
        tr = MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), seed=0, device="cpu")
        TrainLoop(tr, [data[:BATCH], data[BATCH:2 * BATCH]], [data[2 * BATCH:]]).run(3)
        records = [json.loads(ln) for ln in
                   (tmp_path / str(interval) / "metrics.jsonl").read_text().splitlines()]
        epoch_mse[interval] = [r["train_mse_epoch"] for r in records if "train_mse_epoch" in r]
        assert any("val_mse_in_t" in r for r in records) == (interval == 1)
    assert len(epoch_mse[1]) == 3
    assert epoch_mse[1] == epoch_mse[1000]


@pytest.mark.parametrize("dp", [0.0, 0.5])
def test_val_step_is_a_function_of_state_and_batch(pair, dp):
    """Two evaluations of one state at one (epoch, batch) agree, whatever ran between."""
    _, _, tr, state, traj = pair
    x = torch.from_numpy(traj)
    batch_idx = (3 << 20) + 1
    first = tr.val_step(state, x, dp=dp, batch_idx=batch_idx)
    tr.val_step(state, x, dp=dp, batch_idx=batch_idx + 1)
    torch.randperm(10, generator=tr.generator)  # a training draw in between
    second = tr.val_step(state, x, dp=dp, batch_idx=batch_idx)
    assert [float(v) for v in first] == [float(v) for v in second]
    assert float(first[0]) > 0


def test_clip_by_global_norm_does_not_depend_on_the_leaves_layout():
    """The same gradient values as autograd hands them back (some transposed, non-contiguous)
    and as a data mesh's all-reduce does (contiguous views at odd offsets of one flat buffer)
    give the same clipped bits: the norm's sum of squares does not follow the leaves' layout."""
    rng = np.random.default_rng(0)
    shapes = [(128, 256), (256,), (96, 130), (1,), (512, 64)]
    vals = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    as_autograd = {f"w{i}": v.t().contiguous().t() if v.dim() == 2 else v for i, v in enumerate(vals)}
    flat = torch.cat([torch.zeros(1)] + [v.reshape(-1) for v in vals])  # a loss first, as the mesh's mean
    views, off = {}, 1
    for i, v in enumerate(vals):
        views[f"w{i}"] = flat[off:off + v.numel()].view(v.shape)
        off += v.numel()
    assert any(not g.is_contiguous() for g in as_autograd.values())
    a, b = clip_by_global_norm(as_autograd, 1.0), clip_by_global_norm(views, 1.0)
    for k in a:
        assert torch.equal(a[k], b[k]), k
