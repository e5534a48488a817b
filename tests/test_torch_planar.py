"""The port's SE(2) planar modules (``ponita`` geometry) against the JAX package, on the CPU.

Covers what the ``diffusion_plane`` and ``cahn_hilliard`` experiments add to the
Navier-Stokes path: the ``PonitaPos2D`` / ``Ponita2D`` invariants and their windows,
oriented latents, oriented PONITA (with the angle's derivative and the orientation
gate), the JAX package's initial parameters carried across by ``convert_params``, the
kernel backend of the decoder (plain version of K1 on the CPU) at the planar widths
against JAX's ``pallas_interpret``, the decoder's rotation and translation equivariance,
and the nef / ode / dual losses and gradients of ``diffusion_plane`` at a narrow width.
Inputs are drawn with numpy from fixed seeds. Tolerances: invariants and windows atol
1e-6; the vector field rtol 1e-5; decodes rtol 1e-4 / atol 2e-5 (as
``tests/test_torch_fused_decode.py``); losses rtol 1e-4, gradients rtol 2e-4 / atol 2e-5
(as ``tests/test_torch_train.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.dynamics.ponita import PonitaLatentODE as JaxPonitaODE
from enf_pde_tpu.geometry.invariants import Ponita2D as JaxPonita2D
from enf_pde_tpu.geometry.invariants import PonitaPos2D as JaxPonitaPos2D
from enf_pde_tpu.geometry.latent_init import init_orientations_grid as jax_init_orientations
from enf_pde_tpu.models.decoder import EnfDecoder as JaxDecoder
from enf_pde_tpu.models.decoder import embed_pose_angles as jax_embed
from enf_pde_tpu.models.latents import init_latents as jax_init_latents
from enf_pde_tpu.models.latents import latents_to_pose as jax_latents_to_pose
from enf_pde_tpu.ops import pallas_decode as jpd
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer

from chip_smoke import smooth_trajectories
from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.convert import convert_params, flax_to_state_dict
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.dynamics.ponita import PonitaLatentODE
from enf_pde_tpu_torch.geometry.invariants import (
    Ponita2D,
    PonitaPos2D,
    get_ca_invariant,
    get_sa_invariant,
)
from enf_pde_tpu_torch.geometry.latent_init import init_orientations_grid
from enf_pde_tpu_torch.models.decoder import EnfDecoder, embed_pose_angles
from enf_pde_tpu_torch.models.latents import init_latents, latents_to_pose, tile_latents
from enf_pde_tpu_torch.ops import cuda_lib
from enf_pde_tpu_torch.ops import fused_decode as fd
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.utils.equivariance import equivariance_errors
from tests.test_torch_modules import assert_close, load_flax, np_tree, t
from tests.test_torch_train import (
    ATOL,
    LOSS_RTOL,
    RTOL,
    compare_grads,
    inner_masks,
    ode_draws,
    port_grads,
)

torch.set_num_threads(1)

B = 2


def se2_inputs(seed=0, b=B, n=48, z=4, lat=8):
    """Query coordinates, poses (x, y, angle), contexts and window sizes."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)
    p = np.concatenate([rng.uniform(-1, 1, (b, z, 2)), rng.uniform(-4, 4, (b, z, 1))], -1).astype(np.float32)
    a = (1 + 0.5 * rng.standard_normal((b, z, lat))).astype(np.float32)
    sigma = rng.uniform(0.5, 1.5, (b, z, 1)).astype(np.float32)
    return x, p, a, sigma


# ----------------------------------------------------------------- geometry


def test_ponita_invariants_and_windows_match_jax():
    x, p, _, sigma = se2_inputs(1)
    pe = np.asarray(jax_embed(jnp.asarray(p), JaxPonitaPos2D()))  # (x, y, cos, sin)
    assert_close(embed_pose_angles(t(p), PonitaPos2D()), pe, atol=1e-6)
    for port, jax_inv, query in ((PonitaPos2D(), JaxPonitaPos2D(), x), (Ponita2D(), JaxPonita2D(), pe)):
        assert (port.dim, port.num_z_pos_dims, port.num_z_ori_dims, port.is_periodic) == (
            jax_inv.dim, jax_inv.num_z_pos_dims, jax_inv.num_z_ori_dims, False)
        got = port(t(query), t(pe))
        assert got.shape == (B, query.shape[1], p.shape[1], port.dim)
        assert_close(got, jax_inv(query, pe), atol=1e-6)
        # The base class's log-domain planar window -(1/sigma^2) d^2.
        assert_close(port.gaussian_window(t(query), t(pe), t(sigma)),
                     jax_inv.gaussian_window(query, pe, sigma), atol=1e-6)
    # Ponita2D of a pose with itself: the origin in its own frame, cos 0 = 1.
    self_inv = Ponita2D()(t(pe), t(pe))
    diag = self_inv[:, range(p.shape[1]), range(p.shape[1])]
    assert_close(diag, np.broadcast_to([0.0, 0.0, 1.0], diag.shape), atol=1e-6)


def test_ponita_builds_the_position_invariant_for_cross_attention():
    cfg = Config({"invariant_type": "ponita", "num_in": 2})
    assert isinstance(get_ca_invariant(cfg), PonitaPos2D)
    assert isinstance(get_sa_invariant(cfg), Ponita2D)
    with pytest.raises(ValueError, match="2D"):
        get_ca_invariant(Config({"invariant_type": "ponita", "num_in": 3}))


# ----------------------------------------------------------------- latents


@pytest.mark.parametrize("num_latents", [4, 9])
def test_oriented_latent_init_matches_jax(num_latents):
    assert_close(init_orientations_grid(2, num_latents), jax_init_orientations(2, num_latents), atol=1e-6)
    got = init_latents(1, num_latents, 16, 2, 1, gaussian_window_size=-1)
    want = jax_init_latents(1, num_latents, 16, 2, 1, gaussian_window_size=-1)
    assert list(got) == list(want) == ["p_pos", "p_ori", "a", "gaussian_window"]
    for k in want:
        assert_close(got[k], want[k], atol=1e-6)
    p, a, w = latents_to_pose(tile_latents(got, 3))
    jp, _, _ = jax_latents_to_pose(want)
    assert p.shape == (3, num_latents, 3) and a.shape == (3, num_latents, 16) and w.shape == (3, num_latents, 1)
    assert_close(p[:1], jp, atol=1e-6)


# ----------------------------------------------------------------- oriented PONITA


def oriented_ponita_pair(kernel_size, seed=8, lat=6, z=5, readout_scale=300):
    rng = np.random.default_rng(seed)
    p = np.concatenate([rng.uniform(-1, 1, (B, z, 2)), rng.uniform(-4, 4, (B, z, 1))], -1).astype(np.float32)
    a = (1 + 0.5 * rng.standard_normal((B, z, lat))).astype(np.float32)
    w = np.ones((B, z, 1), np.float32)
    kw = dict(num_hidden=16, num_layers=2, scalar_num_out=lat, vec_num_out=1, basis_dim=8,
              degree=3, widening_factor=2, kernel_size=kernel_size)
    jode = JaxPonitaODE(invariant=JaxPonita2D(), **kw)
    params = jode.init(jax.random.PRNGKey(seed), (p, a, w))
    # Bring the readouts' 1e-6-scale initial weights up so that the field is not ~0.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * readout_scale if any(f"Dense_{i}" in str(path) for i in (3, 4, 5)) else v,
        params)
    ode = load_flax(PonitaLatentODE(invariant=Ponita2D(), **kw), params)  # strict: every name and shape
    return jode, params, ode, (p, a, w)


@pytest.mark.parametrize("kernel_size", ["global", 0.2])
def test_oriented_ponita_field_matches_jax(kernel_size):
    jode, params, ode, lat = oriented_ponita_pair(kernel_size)
    gen = ode.PonitaGen_0
    # Contexts keep latent_dim features; only the scalar readout widens, for the angle.
    assert gen.Dense_2.weight.shape == (16, lat[1].shape[-1])
    assert gen.Dense_3.weight.shape == (lat[1].shape[-1] + 1, 16)
    assert gen.Dense_5.weight.shape == gen.Dense_4.weight.shape == (1, 3 + 16)
    dp, da, dw = ode(tuple(t(v) for v in lat))
    jdp, jda, jdw = jode.apply(params, lat)
    assert dp.shape == (B, 5, 3) and da.shape == lat[1].shape
    assert float(dp[..., 2].detach().abs().max()) > 1e-2 and float(dp[..., :2].detach().abs().max()) > 1e-2
    assert_close(dp, jdp, rtol=1e-5, atol=1e-6)
    assert_close(da, jda, rtol=1e-5, atol=1e-6)
    assert_close(dw, jdw, atol=0)


def test_oriented_ponita_field_is_se2_equivariant():
    """Rotating and translating every pose (angles shifted) rotates the position part of
    the field and leaves the contexts' and the angle's derivatives unchanged."""
    _, _, ode, (p, a, w) = oriented_ponita_pair(0.2)
    ang = 0.7
    R = torch.tensor([[math.cos(ang), -math.sin(ang)], [math.sin(ang), math.cos(ang)]])
    p = t(p)
    p_g = torch.cat([p[..., :2] @ R.T + torch.tensor([0.3, -0.2]), p[..., 2:] + ang], -1)
    with torch.no_grad():
        dp, da, _ = ode((p, t(a), t(w)))
        dp_g, da_g, _ = ode((p_g, t(a), t(w)))
    assert_close(dp_g[..., :2], dp[..., :2] @ R.T, rtol=1e-4, atol=1e-5)
    assert_close(dp_g[..., 2:], dp[..., 2:], rtol=1e-4, atol=1e-5)
    assert_close(da_g, da, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- weights carried across


@pytest.mark.parametrize("name", ["diffusion_plane", "cahn_hilliard"])
def test_converted_init_gives_the_same_decode_and_field(name):
    """JAX's initial parameters of the whole experiment (decoder, oriented PONITA, latents,
    inner learning rates), converted, give the same decode and vector field."""
    over = {"nef.num_hidden": 32, "node.num_hidden": 32, "node.basis_dim": 16, "node.num_layers": 1}
    jcfg = jax_load_config(name, [f"{k}={v}" for k, v in over.items()])
    coords = planar_coords(16, 16)  # JAX's init decodes 128 of them
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    cfg = load_experiment_config(name, [f"{k}={v}" for k, v in over.items()])
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    assert set(state["autodecoder"]) == {"p_pos", "p_ori", "a", "gaussian_window"}
    assert set(state["meta_sgd_lrs"]) == {"p_pos", "p_ori", "a", "gaussian_window"}
    assert "PonitaGen_0.Dense_5.weight" in tr.ode_model.state_dict()
    z, lat = cfg.nef.num_latents, cfg.nef.latent_dim
    _, p, a, sigma = se2_inputs(3, z=z, lat=lat)
    x = np.broadcast_to(coords, (B, *coords.shape)).copy()
    want = jtr.decoder.apply(jstate.params["nef"], x, p, a, sigma)
    with torch.no_grad():
        assert_close(tr.decoder(t(x), t(p), t(a), t(sigma)), want)
        field = tr.ode_model((t(p), t(a), t(sigma)))
    jfield = jtr.ode_model.apply(jstate.params["ode"], (p, a, sigma))
    for got, w in zip(field, jfield):
        assert_close(got, w, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- K1 backend at planar widths


def planar_decoders(lat, seed):
    kw = dict(num_hidden=64, num_heads=2, num_layers=0, num_out=1, latent_dim=lat,
              embedding_type="rff", condition_value_transform=True)
    jdec = JaxDecoder(cross_attn_invariant=JaxPonitaPos2D(), self_attn_invariant=JaxPonita2D(),
                      embedding_freq_multiplier=(0.05, 0.2), backend="pallas_interpret", **kw)
    dec = EnfDecoder(cross_attn_invariant=PonitaPos2D(), embedding_freq_multiplier=(0.05, 0.2), **kw)
    return jdec, dec


@pytest.mark.parametrize("z,lat", [(4, 16), (9, 32), (5, 16)])
def test_kernel_backend_at_planar_widths_matches_jax_pallas_interpret(z, lat):
    """I = 2, hid = hidm = D = 64, H = 2; z = 9 and 5 end in a group of one latent."""
    jdec, dec = planar_decoders(lat, z)
    x, p, a, sigma = se2_inputs(z, n=40, z=z, lat=lat)
    params = jdec.init(jax.random.PRNGKey(z), x, p, a, sigma)
    load_flax(dec, params)
    want = jdec.apply(params, x, p, a, sigma)
    with torch.no_grad():
        args = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
        assert args[0].shape == (B, z, 40, 2)  # inv [b, z, c, I]: I = 2
        assert args[4].shape == (B, z, 64, 128)  # G [b, z, hid, H * hidm]
        got = dec(t(x), t(p), t(a), t(sigma), backend="kernel")
        eager = dec(t(x), t(p), t(a), t(sigma))
    assert got.shape == (B, 40, 1)
    assert_close(got, want)
    assert_close(got, eager)


def test_flop_count_at_planar_widths():
    # Per latent: RFF projections 2 I hid/2, three hid^2 layers, logits hid H, G hid H hidm,
    # mixer H hidm D; the tail 3 (HD)^2 + HD hid + hid^2 + hid; 2 FLOPs a multiply-add.
    per_latent = 2 * (2 * 2 * 32 + 3 * 64 * 64 + 64 * 2 + 64 * 2 * 64 + 2 * 64 * 64)
    tail = 2 * (3 * 128 * 128 + 128 * 64 + 64 * 64 + 64)
    for z in (4, 9):
        folded = fd.decode_flops_per_point(2, 64, 64, 64, z, 2, 1)
        assert folded == z * per_latent + tail == {4: 354_432, 9: 643_712}[z]
        assert folded < jpd.decode_flops_per_point(2, 64, 64, z, 2, 1)  # the unfolded model count


def test_k1_shared_memory_at_planar_widths():
    """The mirror of K1's ``layout`` (``fused_decode.k1_smem_bytes``): the source header's
    231,168 B at Navier-Stokes width, under the 232,448 B a block may have, and at the planar
    widths the width class 64 (X, Y [128 x 68], acc [32 x 132], a ring of 3 narrow blocks of
    the shared weights: two blocks an SM), the same for z = 4 and 9 (the softmax runs online
    over groups)."""
    assert fd.k1_smem_bytes(4, 4, 128, 2, 128, 128) == 231_168
    assert "231,168 B" in (cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE).read_text()
    assert fd.k1_width_class(64, 64, 64) == 64
    assert fd.k1_smem_bytes(4, 2, 64, 2, 64, 64) == 114_944
    assert fd.k1_smem_bytes(9, 2, 64, 2, 64, 64) == 114_944


# ----------------------------------------------------------------- equivariance


def test_decoder_is_se2_equivariant_and_the_check_reports_rotation():
    jdec, dec = planar_decoders(16, 1)
    x, p, a, sigma = se2_inputs(4, n=64, z=4, lat=16)
    load_flax(dec, jdec.init(jax.random.PRNGKey(1), x, p, a, sigma))
    errs = equivariance_errors(dec, t(x), t(p), t(a), t(sigma), invariant=dec.cross_attn_invariant,
                               coordinate_system="cartesian")
    assert set(errs) == {"translation", "rotation"}
    assert errs["translation"] < 1e-4 and errs["rotation"] < 1e-4  # f32 rounding
    with torch.no_grad():  # rotating the coordinates without the poses is flagged
        xr = t(x) @ torch.tensor([[0.0, -1.0], [1.0, 0.0]]).T
        assert float((dec(xr, t(p), t(a), t(sigma)) - dec(t(x), t(p), t(a), t(sigma))).abs().max()) > 1e-3


# ----------------------------------------------------------------- training parity


OVERRIDES = {
    "nef.num_hidden": 16,
    "node.num_hidden": 16,
    "node.basis_dim": 8,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "training.max_num_sampled_points": 24,
    "dataset.traj_len_train": 4,
}
SIZE, FRAMES = 8, 6


@pytest.fixture(scope="module")
def pair():
    """(JAX diffusion_plane trainer, its state, port trainer with that state, port state,
    trajectories) at a narrow width."""
    over = [f"{k}={v}" for k, v in OVERRIDES.items()]
    jcfg = jax_load_config("diffusion_plane", over)
    coords = planar_coords(SIZE, SIZE)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    # Scale the ODE readouts (initialised at 1e-6) so the rollout moves the latents.
    ode = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if any(f"Dense_{i}" in str(path) for i in (3, 4, 5)) else v,
        jstate.params["ode"])
    jstate = jstate.replace(params={**jstate.params, "ode": ode})
    cfg = load_experiment_config("diffusion_plane", over)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    traj = smooth_trajectories(B, FRAMES, SIZE, seed=7)
    return jtr, jstate, tr, state, traj


def test_train_inner_loop_updates_orientations_with_the_position_rate(pair):
    jtr, jstate, tr, state, traj = pair
    key = jax.random.PRNGKey(3)
    masks = inner_masks(jtr.cfg, key, SIZE * SIZE)
    prm = jstate.params
    want_loss, want_fit = jax.jit(jtr.inner_loop)(prm["nef"], prm["meta_sgd_lrs"], prm["autodecoder"],
                                                 jnp.asarray(traj[:, 0]), key)
    loss, fitted = tr.train_inner_loop(state["meta_sgd_lrs"], state["autodecoder"],
                                       torch.from_numpy(traj[:, 0]), masks=masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert fitted["p_ori"].shape == (B, 4, 1)
    assert float((fitted["p_ori"] - state["autodecoder"]["p_ori"]).detach().abs().max()) > 1e-4  # it moved
    for k in want_fit:
        assert_close(fitted[k], want_fit[k], rtol=1e-3, atol=1e-5)


def test_inner_loop_noise_moves_positions_only():
    """``noise_pos_inner_loop`` (cahn_hilliard: 0.05) perturbs p_pos, never p_ori."""
    cfg = load_experiment_config("cahn_hilliard", [f"{k}={v}" for k, v in OVERRIDES.items()])
    tr = MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), seed=0, device="cpu")
    state = tr.init_state()
    zero = {k: torch.zeros_like(v) for k, v in state["meta_sgd_lrs"].items()}
    frames = torch.from_numpy(smooth_trajectories(B, 1, SIZE, seed=2)[:, 0])
    fitted = tr.inner_loop(zero, state["autodecoder"], frames, generator=torch.Generator().manual_seed(0))
    tiled = tile_latents(state["autodecoder"], B)
    moved = (fitted["p_pos"] - tiled["p_pos"]).abs()
    assert 0.001 < float(moved.max()) < 0.5
    for k in ("p_ori", "a", "gaussian_window"):
        assert torch.equal(fitted[k], tiled[k]), k


def test_nef_loss_and_grads_match_jax(pair):
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(5)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._nef_loss))(jstate.params, jnp.asarray(traj), rng)
    k_sel, k_inner = jax.random.split(rng)
    fos = jtr.cfg.training.nef.fit_on_num_steps
    frame_idx = np.asarray(jax.random.permutation(k_sel, jtr.cfg.dataset.traj_len_train)[:fos])
    masks = inner_masks(jtr.cfg, k_inner, SIZE * SIZE)
    loss, got = tr.nef_grads(state, torch.from_numpy(traj), frame_idx=frame_idx, masks=masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert float(np.abs(np.asarray(want["meta_sgd_lrs"]["p_ori"])).max()) > 0  # reaches the angle rate
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
    want = {"ode": flax_to_state_dict(np_tree(want))}
    assert float(want["ode"]["PonitaGen_0.Dense_5.weight"].abs().max()) > 0  # the orientation gate
    assert compare_grads(got, want, ("ode",)) > 10


def test_dual_loss_and_grads_match_jax(pair):
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(8)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._ode_loss))(jstate.params, jnp.asarray(traj), rng)
    masks, ode_masks = ode_draws(jtr, rng)
    loss, got = tr.dual_grads(state, torch.from_numpy(traj), masks=masks, ode_masks=ode_masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare_grads(got, port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder", "ode")) > 20
