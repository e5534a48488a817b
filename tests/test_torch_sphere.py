"""The port's S^2 modules (``polar_periodic`` geometry, ``diff_sphere``) against the JAX package, on the CPU.

Covers what the ``diff_sphere`` experiment adds to the planar paths: the
``RelativePositionPolarPeriodic`` invariant and its probability-domain window (the
clipped arccos included), polar latents and their window size, PONITA over the I = 1
invariant, the JAX package's initial parameters carried across by ``convert_params``,
the kernel backend of the decoder (plain version of K1 on the CPU) at the config's
widths (I = 1, hid = hidm = D = 16, H = 2) against JAX's ``pallas_interpret``, the
sphere equivariance check, and the nef / ode / dual losses and gradients at a few
latents. Inputs are drawn with numpy from fixed seeds. Tolerances: invariants and
windows atol 1e-6; latent grids exact; the vector field rtol 1e-5; decodes rel-L2 1e-5;
losses rtol 1e-4, gradients rtol 2e-4 / atol 2e-5 (as ``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.dynamics.ponita import PonitaLatentODE as JaxPonitaODE
from enf_pde_tpu.geometry.invariants import RelativePositionPolarPeriodic as JaxPolar
from enf_pde_tpu.geometry.latent_init import default_gaussian_window_size as jax_window_size
from enf_pde_tpu.geometry.latent_init import init_positions_polar as jax_init_polar
from enf_pde_tpu.models.decoder import EnfDecoder as JaxDecoder
from enf_pde_tpu.models.latents import init_latents as jax_init_latents
from enf_pde_tpu.train.inner_loop import sample_coordinate_masks
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer

from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.convert import convert_params, flax_to_state_dict
from enf_pde_tpu_torch.data import angular_coords
from enf_pde_tpu_torch.data.diffusion_sphere import generate_sphere_diffusion_trajectories
from enf_pde_tpu_torch.data.sphere_harmonics import SphereGrid
from enf_pde_tpu_torch.dynamics.ponita import PonitaLatentODE
from enf_pde_tpu_torch.geometry.invariants import (
    RelativePositionPolarPeriodic,
    get_ca_invariant,
    get_sa_invariant,
)
from enf_pde_tpu_torch.geometry.latent_init import default_gaussian_window_size, init_positions_polar
from enf_pde_tpu_torch.models.decoder import EnfDecoder
from enf_pde_tpu_torch.models.latents import init_latents, latents_to_pose, tile_latents
from enf_pde_tpu_torch.ops import fused_decode as fd
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.utils.equivariance import equivariance_errors
from tests.test_torch_modules import assert_close, load_flax, np_tree, t
from tests.test_torch_train import LOSS_RTOL, compare_grads, inner_masks, port_grads

torch.set_num_threads(1)

B = 2


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def sphere_inputs(seed=0, b=B, n=48, z=8, lat=4):
    """Query coordinates and poses as (phi, theta), contexts and window sizes; the first
    poses sit on queries (cos = 1, where the window's arccos clip binds) and on their
    antipodes (cos = -1)."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0, 2 * np.pi, (b, n)), rng.uniform(0.05, np.pi - 0.05, (b, n))], -1)
    p = np.stack([rng.uniform(0, 2 * np.pi, (b, z)), rng.uniform(0.05, np.pi - 0.05, (b, z))], -1)
    p[:, 0] = x[:, 0]
    p[:, 1] = np.stack([x[:, 1, 0] + np.pi, np.pi - x[:, 1, 1]], -1)
    a = (1 + 0.5 * rng.standard_normal((b, z, lat)))
    sigma = rng.uniform(0.3, 1.5, (b, z, 1))
    return tuple(v.astype(np.float32) for v in (x, p, a, sigma))


# ----------------------------------------------------------------- geometry


def test_polar_invariant_and_window_match_jax():
    x, p, _, sigma = sphere_inputs(1)
    port, jinv = RelativePositionPolarPeriodic(), JaxPolar()
    assert (port.dim, port.num_x_pos_dims, port.num_z_pos_dims, port.num_z_ori_dims, port.is_periodic) == (
        jinv.dim, jinv.num_x_pos_dims, jinv.num_z_pos_dims, jinv.num_z_ori_dims, jinv.is_periodic) == (
        1, 2, 2, 0, True)
    got = port(t(x), t(p))
    assert got.shape == (B, x.shape[1], p.shape[1], 1)
    assert_close(got, jinv(x, p), atol=1e-6)
    assert float(got[:, 0, 0].min()) > 1 - 1e-6 and float(got[:, 1, 1].max()) < -1 + 1e-6
    window = port.gaussian_window(t(x), t(p), t(sigma))
    assert_close(window, jinv.gaussian_window(x, p, sigma), atol=1e-6)
    # Probability domain, the distance clipped: exp(-arccos(1 - 1e-6)^2 / 2 sigma^2) at coincidence.
    d0 = np.arccos(np.float32(1 - 1e-6))
    assert_close(window[:, 0, 0, 0], np.exp(-d0**2 / (2 * sigma[:, 0, 0] ** 2)), atol=1e-6)
    assert float(window.min()) > 0 and float(window.max()) <= 1


def test_polar_periodic_builds_for_both_attentions():
    cfg = Config({"invariant_type": "polar_periodic", "num_in": 2})
    assert isinstance(get_ca_invariant(cfg), RelativePositionPolarPeriodic)
    assert isinstance(get_sa_invariant(cfg), RelativePositionPolarPeriodic)


# ----------------------------------------------------------------- latents


@pytest.mark.parametrize("num_latents", [2, 8, 18, 32])
def test_polar_latent_init_matches_jax(num_latents):
    got, want = init_positions_polar(3, num_latents, 2), np.asarray(jax_init_polar(3, num_latents, 2))
    assert got.dtype == torch.float32 and got.shape == (3, num_latents, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert default_gaussian_window_size("polar", num_latents, 2) == jax_window_size("polar", num_latents, 2)
    lat = init_latents(1, num_latents, 4, 2, 0, coordinate_system="polar", gaussian_window_size=-1)
    jlat = jax_init_latents(1, num_latents, 4, 2, 0, coordinate_system="polar", gaussian_window_size=-1)
    assert list(lat) == list(jlat) == ["p_pos", "a", "gaussian_window"]
    for k in jlat:
        np.testing.assert_array_equal(lat[k].numpy(), np.asarray(jlat[k]))
    p, a, w = latents_to_pose(tile_latents(lat, 2))
    assert p.shape == (2, num_latents, 2) and w.shape == (2, num_latents, 1)


# ----------------------------------------------------------------- PONITA over the polar invariant


def test_polar_ponita_field_matches_jax():
    """PONITA with the I = 1 invariant inv(p, p) and 2 position dims: JAX's parameters
    load strictly (no orientation gate, ``latent_dim`` readout), the field agrees."""
    _, p, a, w = sphere_inputs(8, z=8, lat=4)
    kw = dict(num_hidden=16, num_layers=2, scalar_num_out=4, vec_num_out=1, basis_dim=8, degree=3,
              widening_factor=2, kernel_size="global")
    jode = JaxPonitaODE(invariant=JaxPolar(), **kw)
    lat = (p, a, w)
    params = jode.init(jax.random.PRNGKey(8), lat)
    # Bring the readouts' 1e-6-scale initial weights up so that the field is not ~0.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if any(f"Dense_{i}" in str(path) for i in (3, 4)) else v, params)
    ode = load_flax(PonitaLatentODE(invariant=RelativePositionPolarPeriodic(), **kw), params)
    gen = ode.PonitaGen_0
    assert gen.Dense_0.weight.shape == (16, 1 + 1 + 1 + 1)  # polynomial features of I = 1, degree 3
    assert gen.Dense_4.weight.shape == (1, 1 + 16) and not hasattr(gen, "Dense_5")
    dp, da, dw = ode(tuple(t(v) for v in lat))
    jdp, jda, jdw = jode.apply(params, lat)
    assert dp.shape == (B, 8, 2) and da.shape == (B, 8, 4)
    assert float(dp.detach().abs().max()) > 1e-3 and float(da.detach().abs().max()) > 1e-3
    assert_close(dp, jdp, rtol=1e-5, atol=1e-6)
    assert_close(da, jda, rtol=1e-5, atol=1e-6)
    assert_close(dw, jdw, atol=0)


# ----------------------------------------------------------------- weights carried across


def test_converted_init_gives_the_same_decode_and_field():
    """JAX's initial parameters of the whole experiment (decoder, polar PONITA, latents,
    inner learning rates), converted, give the same decode and vector field."""
    over = ["node.num_layers=1", "nef.num_latents=8"]
    jcfg = jax_load_config("diff_sphere", over)
    coords = angular_coords(SphereGrid(16, 8, device="cpu").phi, SphereGrid(16, 8, device="cpu").theta)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    cfg = load_experiment_config("diff_sphere", over)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    assert tr.coordinate_system == "polar"
    assert set(state["autodecoder"]) == set(state["meta_sgd_lrs"]) == {"p_pos", "a", "gaussian_window"}
    np.testing.assert_array_equal(state["autodecoder"]["p_pos"].numpy(),
                                  np.asarray(jstate.params["autodecoder"]["p_pos"]))
    _, p, a, sigma = sphere_inputs(3, z=8, lat=4)
    x = np.broadcast_to(coords, (B, *coords.shape)).copy()
    want = jtr.decoder.apply(jstate.params["nef"], x, p, a, sigma)
    with torch.no_grad():
        assert rel_l2(tr.decoder(t(x), t(p), t(a), t(sigma)), want) <= 1e-5
        field = tr.ode_model((t(p), t(a), t(sigma)))
    for got, w in zip(field, jtr.ode_model.apply(jstate.params["ode"], (p, a, sigma))):
        assert_close(got, w, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- K1 backend at the sphere widths


def sphere_decoders(use_window: bool):
    kw = dict(num_hidden=16, num_heads=2, num_layers=0, num_out=1, latent_dim=4, embedding_type="rff",
              condition_value_transform=True, use_gaussian_window=use_window)
    jdec = JaxDecoder(cross_attn_invariant=JaxPolar(), self_attn_invariant=JaxPolar(),
                      embedding_freq_multiplier=(0.01, 0.01), backend="pallas_interpret", **kw)
    dec = EnfDecoder(cross_attn_invariant=RelativePositionPolarPeriodic(), embedding_freq_multiplier=(0.01, 0.01),
                     **kw)
    return jdec, dec


@pytest.mark.parametrize("z,use_window", [(18, False), (8, True), (2, False)])
def test_kernel_backend_at_sphere_widths_matches_jax_pallas_interpret(z, use_window):
    """I = 1, hid = hidm = D = 16, H = 2: z = 18 runs latent groups 4, 4, 4, 4, 2; the
    YAML's decode has no window, the window's case adds the probability-domain bias."""
    jdec, dec = sphere_decoders(use_window)
    x, p, a, sigma = sphere_inputs(z, n=40, z=z)
    params = jdec.init(jax.random.PRNGKey(z), x, p, a, sigma)
    load_flax(dec, params)
    want = jdec.apply(params, x, p, a, sigma)
    with torch.no_grad():
        args = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
        assert args[0].shape == (B, z, 40, 1)  # inv [b, z, c, I]: I = 1
        assert args[4].shape == (B, z, 16, 32)  # G [b, z, hid, H * hidm]
        assert bool((args[1] == 0).all()) != use_window  # the window bias
        got = dec(t(x), t(p), t(a), t(sigma), backend="kernel")
        eager = dec(t(x), t(p), t(a), t(sigma))
    assert got.shape == (B, 40, 1)
    assert rel_l2(got, want) <= 1e-5
    assert rel_l2(got, eager) <= 1e-5


def test_flop_count_and_shared_memory_at_sphere_widths():
    # Per latent: RFF projection 2 I hid/2, three hid^2 layers, logits hid H, G hid H hidm,
    # mixer H hidm D; the tail 3 (HD)^2 + HD hid + hid^2 + hid; 2 FLOPs a multiply-add.
    per_latent = 2 * (2 * 1 * 8 + 3 * 16 * 16 + 16 * 2 + 16 * 2 * 16 + 2 * 16 * 16)
    tail = 2 * (3 * 32 * 32 + 32 * 16 + 16 * 16 + 16)
    assert fd.decode_flops_per_point(2, 16, 16, 16, 18, 1, 1) == 18 * per_latent + tail == 73_952
    # The width class 16: X, Y [256 x 20]; acc [32 x 36]; the shared weights resident, 8 KB.
    assert fd.k1_width_class(16, 16, 16) == 16
    assert fd.k1_smem_bytes(18, 1, 16, 2, 16, 16) == 57_600


# ----------------------------------------------------------------- equivariance


def test_decoder_is_so3_equivariant_and_the_check_reports_both():
    jdec, dec = sphere_decoders(True)
    x, p, a, sigma = sphere_inputs(4, n=64, z=8)
    load_flax(dec, jdec.init(jax.random.PRNGKey(1), x, p, a, sigma))
    errs = equivariance_errors(dec, t(x), t(p), t(a), t(sigma), invariant=dec.cross_attn_invariant,
                               coordinate_system="polar")
    assert set(errs) == {"longitude", "rotation"}
    assert errs["longitude"] < 1e-4 and errs["rotation"] < 1e-4  # f32 rounding
    with torch.no_grad():  # shifting the coordinates' longitude without the poses' is flagged
        xs = t(x) + torch.tensor([0.83, 0.0])
        assert float((dec(xs, t(p), t(a), t(sigma)) - dec(t(x), t(p), t(a), t(sigma))).abs().max()) > 1e-3


# ----------------------------------------------------------------- training parity


OVERRIDES = {
    "nef.num_latents": 8,
    "node.num_hidden": 16,
    "node.basis_dim": 8,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "training.max_num_sampled_points": 24,
    "training.nef.fit_on_num_steps": 2,
    "dataset.traj_len_train": 4,
}
NPHI, NTHETA, FRAMES = 8, 4, 6


@pytest.fixture(scope="module")
def pair():
    """(JAX diff_sphere trainer, its state, port trainer with that state, port state,
    trajectories) at 8 latents on an 8 x 4 sphere grid."""
    over = [f"{k}={v}" for k, v in OVERRIDES.items()]
    jcfg = jax_load_config("diff_sphere", over)
    grid = SphereGrid(NPHI, NTHETA, device="cpu")
    coords = angular_coords(grid.phi, grid.theta)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    # Scale the ODE readouts (initialised at 1e-6) so the rollout moves the latents.
    ode = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if any(f"Dense_{i}" in str(path) for i in (3, 4)) else v,
        jstate.params["ode"])
    jstate = jstate.replace(params={**jstate.params, "ode": ode})
    cfg = load_experiment_config("diff_sphere", over)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    traj = generate_sphere_diffusion_trajectories([3, 4], num_frames=FRAMES, grid=grid)
    return jtr, jstate, tr, state, traj


def ode_draws(jtr, rng):
    k_inner, k_mask = jax.random.split(rng)
    T, N, M = jtr.cfg.dataset.traj_len_train, NPHI * NTHETA, jtr.cfg.training.max_num_sampled_points
    ode_masks = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, N)[:M])(jax.random.split(k_mask, T)))
    return inner_masks(jtr.cfg, k_inner, N), ode_masks


def test_nef_loss_and_grads_match_jax(pair):
    """The window is not read (``use_gaussian_window: false``): its gradients are zero in
    both, the inner loop's included."""
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(5)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._nef_loss))(jstate.params, jnp.asarray(traj), rng)
    k_sel, k_inner = jax.random.split(rng)
    fos = jtr.cfg.training.nef.fit_on_num_steps
    frame_idx = np.asarray(jax.random.permutation(k_sel, jtr.cfg.dataset.traj_len_train)[:fos])
    masks = inner_masks(jtr.cfg, k_inner, NPHI * NTHETA)
    loss, got = tr.nef_grads(state, torch.from_numpy(traj), frame_idx=frame_idx, masks=masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert float(np.abs(np.asarray(want["autodecoder"]["gaussian_window"])).max()) == 0
    assert compare_grads(got, port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder")) > 10


def test_ode_loss_and_ode_grads_match_jax(pair):
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(6)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda op: jtr._ode_loss(dict(jstate.params, ode=op), jnp.asarray(traj), rng)
    ))(jstate.params["ode"])
    masks, ode_masks = ode_draws(jtr, rng)
    assert tr.ode_backend == "eager"  # no ode_backend in the YAML: the rollout decode is eager
    loss, got = tr.ode_grads(state, torch.from_numpy(traj), masks=masks, ode_masks=ode_masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare_grads(got, {"ode": flax_to_state_dict(np_tree(want))}, ("ode",)) > 10


def test_dual_loss_and_grads_match_jax(pair):
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(8)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._ode_loss))(jstate.params, jnp.asarray(traj), rng)
    masks, ode_masks = ode_draws(jtr, rng)
    loss, got = tr.dual_grads(state, torch.from_numpy(traj), masks=masks, ode_masks=ode_masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare_grads(got, port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder", "ode")) > 20


def test_val_step_matches_jax(pair):
    """Validation decodes through the kernel backend (``eval_backend: pallas``; its plain
    version on the CPU): in-t and out-t MSE against JAX's, from the same draws."""
    jtr, jstate, tr, state, traj = pair
    assert tr.eval_backend == "kernel"
    want_in, want_out = jtr.val_step(jstate, jnp.asarray(traj), 3)
    _, k_mask, _ = jax.random.split(jax.random.fold_in(jstate.rng, 3), 3)
    masks = np.asarray(sample_coordinate_masks(k_mask, NPHI * NTHETA, jtr.cfg.meta.num_inner_steps + 1,
                                               jtr.cfg.training.max_num_sampled_points))
    got_in, got_out = tr.val_step(state, torch.from_numpy(traj), masks=masks)
    assert float(want_out) > 0
    assert_close(got_in, want_in, rtol=1e-3, atol=1e-6)  # 2 inner steps + a rollout, as the NS test
    assert_close(got_out, want_out, rtol=1e-3, atol=1e-6)
