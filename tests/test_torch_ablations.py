"""The paper's ablations in the port against the JAX package, on the CPU.

Covers the geometries of the ablation study on R^n (``rel_pos``: x - p; ``norm_rel_pos``:
||p - x||, I = 1; the non-equivariant ``abs_pos``: x itself) with their planar windows,
the kernel backend of the decoder (the plain version of K1 on the CPU) at Navier-Stokes
width with I = 1 and I = 2 against JAX's ``pallas_interpret``, the empty equivariance
check of ``abs_pos``, the MLP latent ODE (``node.name: mlp``), ``navier_stokes`` with
``nef.invariant_type=abs_pos`` through the nef / ode / dual losses and gradients (the
rollout decode on the kernel backend) and, with the MLP ODE, through the ``fit`` CLI, and
``utils/metrics``. Inputs are drawn with
numpy from fixed seeds. Tolerances: invariants and windows atol 1e-6; decodes rel-L2
1e-5; the vector field rtol 1e-5; losses rtol 1e-4, gradients rtol 2e-4 / atol 2e-5 (as
``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.dynamics.mlp_ode import MLPLatentODE as JaxMLPODE
from enf_pde_tpu.geometry import invariants as jinv
from enf_pde_tpu.models.decoder import EnfDecoder as JaxDecoder
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer
from enf_pde_tpu.utils import metrics as jmetrics

from chip_smoke import smooth_trajectories
from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.convert import convert_params, flax_to_state_dict
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.dynamics.mlp_ode import MLPLatentODE
from enf_pde_tpu_torch.experiments.fit import main as fit_main
from enf_pde_tpu_torch.geometry import invariants as tinv
from enf_pde_tpu_torch.models.decoder import EnfDecoder
from enf_pde_tpu_torch.train.logging import MetricLogger
from enf_pde_tpu_torch.train.loop import TrainLoop
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.utils import metrics
from enf_pde_tpu_torch.utils.equivariance import equivariance_errors
from tests.test_torch_fit import SMALL, fill_cache, read_metrics
from tests.test_torch_modules import assert_close, load_flax, np_tree, t, torus_inputs
from tests.test_torch_train import (
    LOSS_RTOL,
    OVERRIDES,
    SIZE,
    compare_grads,
    inner_masks,
    ode_draws,
    port_grads,
)

torch.set_num_threads(1)

ABLATIONS = {"rel_pos": ("RelativePositionND", 2), "norm_rel_pos": ("NormRelativePositionND", 1),
             "abs_pos": ("AbsolutePositionND", 2)}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ----------------------------------------------------------------- geometry


@pytest.mark.parametrize("name", sorted(ABLATIONS))
def test_ablation_invariant_and_window_match_jax(name):
    cls, dim = ABLATIONS[name]
    x, p, _, sigma = torus_inputs(3)
    cfg = Config({"invariant_type": name, "num_in": 2})
    inv = tinv.get_ca_invariant(cfg)
    assert isinstance(inv, getattr(tinv, cls)) and isinstance(tinv.get_sa_invariant(cfg), getattr(tinv, cls))
    want = getattr(jinv, cls)(2)
    assert (inv.dim, inv.num_z_pos_dims, inv.num_z_ori_dims, inv.is_periodic) == (dim, 2, 0, False)
    got = inv(t(x), t(p))
    assert got.shape == (2, x.shape[1], p.shape[1], dim)
    assert_close(got, want(x, p), atol=1e-6)
    # All three keep the planar log-domain window of the squared distance.
    assert_close(inv.gaussian_window(t(x), t(p), t(sigma)), want.gaussian_window(x, p, sigma), atol=1e-6)


def ablation_decoders(name):
    kw = dict(num_hidden=128, num_heads=2, num_layers=0, num_out=1, latent_dim=16,
              embedding_type="rff", condition_value_transform=True)
    cls, _ = ABLATIONS[name]
    jdec = JaxDecoder(cross_attn_invariant=getattr(jinv, cls)(2), self_attn_invariant=getattr(jinv, cls)(2),
                      embedding_freq_multiplier=(0.05, 0.1), backend="pallas_interpret", **kw)
    dec = EnfDecoder(cross_attn_invariant=getattr(tinv, cls)(2), embedding_freq_multiplier=(0.05, 0.1), **kw)
    return jdec, dec


@pytest.mark.parametrize("name", ["norm_rel_pos", "abs_pos"])
def test_kernel_backend_at_ns_width_matches_jax_pallas_interpret(name):
    """I = 1 (``norm_rel_pos``) and I = 2 (``abs_pos``; ``rel_pos`` has the same shapes)
    at hid = hidm = D = 128, H = 2, 4 latents of 16, with the window."""
    jdec, dec = ablation_decoders(name)
    x, p, a, sigma = torus_inputs(5, n=40, lat=16)
    params = jdec.init(jax.random.PRNGKey(1), x, p, a, sigma)
    load_flax(dec, params)
    want = jdec.apply(params, x, p, a, sigma)
    with torch.no_grad():
        args = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
        assert args[0].shape == (2, 4, 40, ABLATIONS[name][1])  # inv [b, z, c, I]
        got = dec(t(x), t(p), t(a), t(sigma), backend="kernel")
        eager = dec(t(x), t(p), t(a), t(sigma))
    assert got.shape == (2, 40, 1)
    assert rel_l2(got, want) <= 1e-5
    assert rel_l2(got, eager) <= 1e-5


def test_abs_pos_claims_no_equivariance_and_the_loop_logs_none(tmp_path):
    cfg = load_experiment_config("navier_stokes", [f"{k}={v}" for k, v in OVERRIDES.items()]
                                 + ["nef.invariant_type=abs_pos", f"logging.log_dir={tmp_path}"])
    trainer = MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), device="cpu")
    state = trainer.init_state()
    x, p, a, sigma = torus_inputs(6, lat=16)
    assert equivariance_errors(trainer.decoder, t(x), t(p), t(a), t(sigma),
                               invariant=trainer.decoder.cross_attn_invariant,
                               coordinate_system="cartesian") == {}
    logger = MetricLogger(str(tmp_path))
    TrainLoop(trainer, [], [smooth_trajectories(2, 5, SIZE, seed=3)], logger)._log_equivariance(state, 1)
    logger.close()
    assert (tmp_path / "metrics.jsonl").read_text() == ""
    # rel_pos claims translations: the same check has a translation error.
    rel = tinv.get_ca_invariant(Config({"invariant_type": "rel_pos", "num_in": 2}))
    assert set(equivariance_errors(trainer.decoder, t(x), t(p), t(a), t(sigma), rel, "cartesian")) == {"translation"}


# ----------------------------------------------------------------- the MLP latent ODE


def test_mlp_ode_matches_flax():
    rng = np.random.default_rng(8)
    p = rng.uniform(-1, 1, (2, 4, 2)).astype(np.float32)
    a = (1 + 0.5 * rng.standard_normal((2, 4, 16))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (2, 4, 1)).astype(np.float32)
    jmod = JaxMLPODE(num_hidden=32, num_layers=3, scalar_num_out=16, vec_num_out=1)
    params = jmod.init(jax.random.PRNGKey(2), (p, a, w))
    assert sorted(params["params"]) == [f"Dense_{i}" for i in range(8)]
    cfg = load_experiment_config("navier_stokes", ["node.name=mlp", "node.num_hidden=32"])
    _, ode = build_models(cfg)
    assert isinstance(ode, MLPLatentODE)
    load_flax(ode, params)  # strict
    want = jmod.apply(params, (p, a, w))
    with torch.no_grad():
        got = ode((t(p), t(a), t(w)))
    for g, wv in zip(got, want):
        assert_close(g, wv, rtol=1e-5, atol=1e-7)
    assert float(got[2].abs().max()) == 0.0 and got[0].shape == (2, 4, 2) and got[1].shape == (2, 4, 16)


# ----------------------------------------------------------------- navier_stokes with abs_pos


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, its state, port trainer with that state, port state, trajectories)."""
    over = [f"{k}={v}" for k, v in OVERRIDES.items()] + ["nef.invariant_type=abs_pos"]
    coords = planar_coords(SIZE, SIZE)
    jcfg = jax_load_config("navier_stokes", over)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    # As tests/test_torch_train.py: the PONITA readouts scaled so the rollout moves.
    ode = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if "Dense_3" in str(path) or "Dense_4" in str(path) else v,
        jstate.params["ode"])
    jstate = jstate.replace(params={**jstate.params, "ode": ode})
    cfg = load_experiment_config("navier_stokes", over)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    assert tr.ode_backend == "kernel"  # navier_stokes.yaml: ode_backend pallas
    return jtr, jstate, tr, state, smooth_trajectories(2, 5, SIZE, seed=7)


def test_abs_pos_nef_loss_and_grads_match_jax(pair):
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(5)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._nef_loss))(jstate.params, jnp.asarray(traj), rng)
    k_sel, k_inner = jax.random.split(rng)
    frame_idx = np.asarray(jax.random.permutation(k_sel, jtr.cfg.dataset.traj_len_train)[:2])
    masks = inner_masks(jtr.cfg, k_inner, SIZE * SIZE)
    loss, got = tr.nef_grads(state, torch.from_numpy(traj), frame_idx=frame_idx, masks=masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare_grads(got, port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder")) > 10


@pytest.mark.parametrize("kind", ["ode", "dual"])
def test_abs_pos_ode_and_dual_losses_and_grads_match_jax(pair, kind):
    """The rollout decode on the kernel backend (K1 + K2's plain versions) at I = 2."""
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(6)
    if kind == "ode":
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda op: jtr._ode_loss(dict(jstate.params, ode=op), jnp.asarray(traj), rng)
        ))(jstate.params["ode"])
        want, groups = {"ode": flax_to_state_dict(np_tree(want))}, ("ode",)
    else:
        want_loss, want = jax.jit(jax.value_and_grad(jtr._ode_loss))(jstate.params, jnp.asarray(traj), rng)
        want, groups = port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder", "ode")
    masks, ode_masks = ode_draws(jtr, rng)
    fn = tr.ode_grads if kind == "ode" else tr.dual_grads
    loss, got = fn(state, torch.from_numpy(traj), masks=masks, ode_masks=ode_masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare_grads(got, want, groups) > 10


def test_fit_cli_trains_abs_pos_with_the_mlp_ode_on_cpu(tmp_path):
    """``navier_stokes nef.invariant_type=abs_pos node.name=mlp`` through the CLI for 3
    epochs (nef, dual, ode) on a cache of short solver runs: finite metrics, no
    equivariance key although the check is due from epoch 0."""
    data_dir = tmp_path / "data"
    fill_cache(data_dir, "train", 4, seed=0)
    fill_cache(data_dir, "test", 2, seed=100)
    over = [f"{k}={v}" for k, v in SMALL.items() if not k.startswith("training.")]
    over += ["training.max_num_sampled_points=256", "training.nef.train_until_epoch=2",
             "training.ode.train_from_epoch=1", "training.ode.train_until_epoch=3",
             "training.num_epochs=3", "dataset.num_signals_train=4", "dataset.num_signals_test=2",
             "test.test_interval=3", "test.test_equiv_at_epoch=0", "logging.checkpoint=false",
             "nef.invariant_type=abs_pos", "node.name=mlp", f"dataset.path={data_dir}",
             f"logging.log_dir={tmp_path / 'run'}"]
    fit_main(["navier_stokes", *over, "--device", "cpu"])
    records = read_metrics(tmp_path / "run")
    assert [r["phase"] for r in records if "phase" in r] == ["nef", "nef+ode", "ode"]
    assert not any(k.startswith("equivariance_err") for r in records for k in r)
    assert {"val_mse_in_t", "train_mse_out_t"} <= set().union(*records)
    assert all(np.isfinite(v) for r in records for k, v in r.items() if "mse" in k)


# ----------------------------------------------------------------- metrics


def test_metrics_match_jax():
    rng = np.random.default_rng(10)
    a = rng.standard_normal((3, 8, 8, 2)).astype(np.float32)
    b = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32) + 1.5
    assert_close(metrics.mse(t(a), t(b)), jmetrics.mse(a, b), rtol=1e-6)
    assert_close(metrics.psnr(t(a), t(b)), jmetrics.psnr(a, b), rtol=1e-5)
    assert metrics.psnr(t(a), t(b)).shape == (3,)
    np.testing.assert_array_equal(metrics.iou(t(a), b), jmetrics.iou(a, b))
    assert metrics.iou(np.zeros((1, 4)) - 1, np.zeros((1, 4)) - 1)[0] == 0.0  # empty union
