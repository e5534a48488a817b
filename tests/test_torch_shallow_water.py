"""The port's ``shallow_water`` model path (``latitude_periodic`` geometry) against the JAX package, on the CPU.

Covers what the shallow-water experiment adds to the sphere's paths: the longitude-only
``RelativeLatitudePeriodic`` invariant (I = 4) and its window, for both attentions;
PONITA over I = 4 (340 polynomial features at degree 3); the JAX package's whole initial
state at the config's full width, loaded strictly; the kernel backend of the decoder
(plain version of K1 on the CPU) with z = 8, the window on and three output channels at
a ragged point count against JAX's ``pallas_interpret``; the chunked decode on the
96 x 48 grid, whose last chunk is padded; the longitude-only equivariance check; and
the nef / ode / dual losses and gradients and ``val_step`` at a small config, with the
rollout decode on the kernel backend (``nef.ode_backend: pallas``), and ``val_step`` on
the 192 x 96 super-resolution grid. Inputs are drawn with numpy from fixed seeds.
Tolerances: invariants and windows atol 1e-6; the vector field rtol 1e-5; decodes rel-L2
1e-5; losses rtol 1e-4, gradients rtol 2e-4 / atol 2e-5 (as ``tests/test_torch_train.py``);
validation MSE rtol 1e-3 (as the sphere's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.dynamics.ponita import PonitaLatentODE as JaxPonitaODE
from enf_pde_tpu.geometry.invariants import RelativeLatitudePeriodic as JaxLatitude
from enf_pde_tpu.models.decoder import EnfDecoder as JaxDecoder
from enf_pde_tpu.train.inner_loop import sample_coordinate_masks
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer

from chip_smoke import TIE_MARGIN, decode_inputs, relu_ties, shape_config
from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.convert import convert_params, flax_to_state_dict
from enf_pde_tpu_torch.data import angular_coords
from enf_pde_tpu_torch.data.registry import dataset_spec
from enf_pde_tpu_torch.data.sphere_harmonics import SphereGrid
from enf_pde_tpu_torch.dynamics.ponita import PonitaLatentODE
from enf_pde_tpu_torch.geometry.invariants import RelativeLatitudePeriodic, get_ca_invariant, get_sa_invariant
from enf_pde_tpu_torch.models.decoder import EnfDecoder
from enf_pde_tpu_torch.ops import fused_decode as fd
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.utils.equivariance import equivariance_errors
from tests.test_torch_modules import assert_close, load_flax, np_tree, t
from tests.test_torch_sphere import rel_l2, sphere_inputs
from tests.test_torch_train import LOSS_RTOL, compare_grads, inner_masks, port_grads

torch.set_num_threads(1)

B, OUT = 2, 3  # (h, u_phi, u_theta)


# ----------------------------------------------------------------- geometry


def test_latitude_invariant_and_window_match_jax():
    """The first poses sit on queries (dphi = 0, the window's arccos clip binds) and on
    their antipodes (cos = -1)."""
    x, p, _, sigma = sphere_inputs(2)
    port, jinv = RelativeLatitudePeriodic(), JaxLatitude()
    assert (port.dim, port.num_x_pos_dims, port.num_z_pos_dims, port.num_z_ori_dims, port.is_periodic) == (
        jinv.dim, jinv.num_x_pos_dims, jinv.num_z_pos_dims, jinv.num_z_ori_dims, jinv.is_periodic) == (
        4, 2, 2, 0, True)
    got = port(t(x), t(p))
    assert got.shape == (B, x.shape[1], p.shape[1], 4)
    assert_close(got, jinv(x, p), atol=1e-6)
    assert_close(got[:, 0, 0], np.stack([x[:, 0, 1], x[:, 0, 1], np.ones(B), np.zeros(B)], -1), atol=1e-6)
    window = port.gaussian_window(t(x), t(p), t(sigma))
    assert window.shape == (B, x.shape[1], p.shape[1], 1)
    assert_close(window, jinv.gaussian_window(x, p, sigma), atol=1e-6)
    d0 = np.arccos(np.float32(1 - 1e-6))  # probability domain, the distance clipped at coincidence
    assert_close(window[:, 0, 0, 0], np.exp(-d0**2 / (2 * sigma[:, 0, 0] ** 2)), atol=1e-6)
    dpi = np.arccos(np.float32(-1 + 1e-6))  # and at the antipode
    assert_close(window[:, 1, 1, 0], np.exp(-dpi**2 / (2 * sigma[:, 1, 0] ** 2)), atol=1e-6)


def test_latitude_periodic_builds_for_both_attentions():
    cfg = Config({"invariant_type": "latitude_periodic", "num_in": 2})
    assert isinstance(get_ca_invariant(cfg), RelativeLatitudePeriodic)
    assert isinstance(get_sa_invariant(cfg), RelativeLatitudePeriodic)
    dec, ode = build_models(load_experiment_config("shallow_water"))
    assert isinstance(dec.cross_attn_invariant, RelativeLatitudePeriodic)
    assert isinstance(ode.PonitaGen_0.invariant, RelativeLatitudePeriodic)


# ----------------------------------------------------------------- PONITA over I = 4


def test_latitude_ponita_field_matches_jax():
    _, p, a, w = sphere_inputs(9, z=8, lat=8)
    kw = dict(num_hidden=32, num_layers=2, scalar_num_out=8, vec_num_out=1, basis_dim=16, degree=3,
              widening_factor=2, kernel_size="global")
    jode = JaxPonitaODE(invariant=JaxLatitude(), **kw)
    lat = (p, a, w)
    params = jode.init(jax.random.PRNGKey(9), lat)
    # Bring the readouts' 1e-6-scale initial weights up so that the field is not ~0.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if any(f"Dense_{i}" in str(path) for i in (3, 4)) else v, params)
    ode = load_flax(PonitaLatentODE(invariant=RelativeLatitudePeriodic(), **kw), params)
    gen = ode.PonitaGen_0
    assert gen.Dense_0.weight.shape == (32, 4 + 16 + 64 + 256)  # polynomial features of I = 4, degree 3
    assert gen.Dense_4.weight.shape == (1, 4 + 32) and not hasattr(gen, "Dense_5")
    dp, da, dw = ode(tuple(t(v) for v in lat))
    jdp, jda, jdw = jode.apply(params, lat)
    assert dp.shape == (B, 8, 2) and da.shape == (B, 8, 8)
    assert float(dp.detach().abs().max()) > 1e-3 and float(da.detach().abs().max()) > 1e-3
    assert_close(dp, jdp, rtol=1e-5, atol=1e-6)
    assert_close(da, jda, rtol=1e-5, atol=1e-6)
    assert_close(dw, jdw, atol=0)


# ----------------------------------------------------------------- weights carried across


def test_converted_full_width_init_gives_the_same_decode_and_field():
    """JAX's initial parameters of the whole experiment at its published width (decoder
    hidden 128, 8 latents of 32, three outputs; PONITA 3 layers, hidden 256, basis 128
    over I = 4), loaded strictly, give the same decode and vector field."""
    over = ["nef.num_out=3"]
    jcfg = jax_load_config("shallow_water", over)
    grid = SphereGrid(16, 8, device="cpu")
    coords = angular_coords(grid.phi, grid.theta)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    cfg = load_experiment_config("shallow_water", over)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    assert tr.coordinate_system == "polar" and tr.ode_backend == tr.eval_backend == "kernel"
    assert tr.ode_model.PonitaGen_0.Dense_0.weight.shape == (256, 340)
    assert set(state["autodecoder"]) == set(state["meta_sgd_lrs"]) == {"p_pos", "a", "gaussian_window"}
    np.testing.assert_array_equal(state["autodecoder"]["p_pos"].numpy(),
                                  np.asarray(jstate.params["autodecoder"]["p_pos"]))
    _, p, a, sigma = sphere_inputs(5, z=8, lat=32)
    x = np.broadcast_to(coords, (B, *coords.shape)).copy()
    want = jtr.decoder.apply(jstate.params["nef"], x, p, a, sigma)
    with torch.no_grad():
        got = tr.decoder(t(x), t(p), t(a), t(sigma))
        assert got.shape == (B, coords.shape[0], OUT)
        assert rel_l2(got, want) <= 1e-5
        field = tr.ode_model((t(p), t(a), t(sigma)))
    for got, w in zip(field, jtr.ode_model.apply(jstate.params["ode"], (p, a, sigma))):
        assert_close(got, w, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- K1 backend at z = 8, three outputs


def latitude_decoders(hid: int = 16, lat: int = 8):
    kw = dict(num_hidden=hid, num_heads=2, num_layers=0, num_out=OUT, latent_dim=lat, embedding_type="rff",
              condition_value_transform=True, use_gaussian_window=True)
    jdec = JaxDecoder(cross_attn_invariant=JaxLatitude(), self_attn_invariant=JaxLatitude(),
                      embedding_freq_multiplier=(0.05, 0.2), backend="pallas_interpret", **kw)
    dec = EnfDecoder(cross_attn_invariant=RelativeLatitudePeriodic(), embedding_freq_multiplier=(0.05, 0.2), **kw)
    return jdec, dec


@pytest.mark.parametrize("n", [40, 72])
def test_kernel_backend_matches_jax_pallas_interpret(n):
    """I = 4, hid = hidm = D = 16, H = 2, z = 8 (latent groups 4, 4), the window on,
    num_out = 3, ``n`` points (not a multiple of K1's 32-point tile)."""
    jdec, dec = latitude_decoders()
    x, p, a, sigma = sphere_inputs(n, n=n, z=8, lat=8)
    params = jdec.init(jax.random.PRNGKey(n), x, p, a, sigma)
    load_flax(dec, params)
    want = jdec.apply(params, x, p, a, sigma)
    with torch.no_grad():
        args = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
        assert args[0].shape == (B, 8, n, 4)  # inv [b, z, c, I]: I = 4
        assert bool((args[1] != 0).all())  # the window bias
        assert args[7][-2].shape == (16, OUT)  # h_w3 [hid, num_out]
        got = dec(t(x), t(p), t(a), t(sigma), backend="kernel")
        eager = dec(t(x), t(p), t(a), t(sigma))
    assert got.shape == (B, n, OUT)
    assert rel_l2(got, want) <= 1e-5
    assert rel_l2(got, eager) <= 1e-5


def test_flop_counts_and_shared_memory_at_shallow_water_widths():
    """K1 and K2 at the published widths: I = 4, hid = hidm = D = 128, H = 2, z = 8,
    num_out = 3. Per latent: RFF projection 2 I hid/2, three hid^2 layers, logits hid H,
    G hid H hidm, mixer H hidm D; the tail 3 (HD)^2 + HD hid + hid^2 + hid num_out; 2
    FLOPs a multiply-add. K2's counts are the port's own (about 5.21 and 7.01 MFLOP a
    point); K1's shared memory does not depend on z."""
    per_latent = 2 * (2 * 4 * 64 + 3 * 128 * 128 + 128 * 2 + 128 * 256 + 2 * 128 * 128)
    tail = 2 * (3 * 256 * 256 + 256 * 128 + 128 * 128 + 128 * 3)
    assert fd.decode_flops_per_point(2, 128, 128, 128, 8, 4, 3) == 8 * per_latent + tail
    without = fd.decode_bwd_flops_per_point(2, 128, 128, 128, 8, 4, 3, False)
    with_w = fd.decode_bwd_flops_per_point(2, 128, 128, 128, 8, 4, 3, True)
    assert 5.2e6 < without < 5.22e6 and 7.0e6 < with_w < 7.02e6
    assert fd.k1_smem_bytes(8, 4, 128, 2, 128, 128) == fd.k1_smem_bytes(4, 4, 128, 2, 128, 128) == 231_168


def test_chunked_decode_pads_the_last_chunk_of_the_low_res_grid():
    """The 96 x 48 grid's 4,608 points decode in chunks of 2,048 (the last one padded by
    1,536 points at the pole) on the kernel backend, as validation decodes them; the
    result equals one eager decode of all points."""
    cfg = load_experiment_config("shallow_water", ["nef.num_hidden=16", "nef.latent_dim=8", "nef.num_out=3",
                                                   "node.num_hidden=16", "node.basis_dim=8", "node.num_layers=1"])
    coords = dataset_spec("shallow_water_low_res", device="cpu").coords
    assert coords.shape == (4608, 2) and 4608 % cfg.training.max_num_sampled_points == 512
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    tr.init_state()
    _, p, a, sigma = sphere_inputs(6, b=1, z=8, lat=8)
    traj = tuple(t(v)[:, None].expand(-1, 2, *v.shape[1:]) for v in (p, a, sigma))  # [1, 2 frames, ...]
    got = tr.decode(traj)
    assert got.shape == (1, 2, 4608, OUT)
    with torch.no_grad():
        want = tr.decoder(tr.coords[None].expand(2, -1, -1), *(v[0] for v in traj))
    assert rel_l2(got[0], want) <= 1e-5


# ----------------------------------------------------------------- equivariance


def test_decoder_is_longitude_equivariant_and_the_check_reports_longitude_only():
    jdec, dec = latitude_decoders()
    x, p, a, sigma = sphere_inputs(4, n=64, z=8, lat=8)
    load_flax(dec, jdec.init(jax.random.PRNGKey(2), x, p, a, sigma))
    errs = equivariance_errors(dec, t(x), t(p), t(a), t(sigma), invariant=dec.cross_attn_invariant,
                               coordinate_system="polar")
    assert set(errs) == {"longitude"}  # the geometry claims no other rotation
    assert errs["longitude"] < 1e-4  # f32 rounding
    with torch.no_grad():  # a shift of the colatitude is not a symmetry: the decode moves
        xs, ps = t(x) + torch.tensor([0.0, 0.2]), t(p) + torch.tensor([0.0, 0.2])
        assert float((dec(xs, ps, t(a), t(sigma)) - dec(t(x), t(p), t(a), t(sigma))).abs().max()) > 1e-3


# ----------------------------------------------------------------- training parity


OVERRIDES = {
    "nef.num_hidden": 16,
    "nef.latent_dim": 8,
    "nef.num_out": OUT,
    "node.num_hidden": 32,
    "node.basis_dim": 16,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "training.max_num_sampled_points": 24,
    "training.nef.fit_on_num_steps": 2,
    "dataset.traj_len_train": 4,
    "dataset.traj_len_out_horizon": 2,
}
NPHI, NTHETA, FRAMES = 8, 4, 6


def smooth_sphere_trajectories(n: int, frames: int, grid: SphereGrid, seed: int) -> np.ndarray:
    """Seeded smooth fields on a sphere grid drifting in longitude, [n, frames, nphi, ntheta, 3]."""
    rng = np.random.default_rng(seed)
    phi, theta = grid.phi[:, None], grid.theta[None, :]
    out = np.zeros((n, frames, grid.nphi, grid.ntheta, OUT))
    for i in range(n):
        for c in range(OUT):
            for m in range(3):
                amp, ph, om = rng.standard_normal(), rng.uniform(0, 2 * np.pi), rng.uniform(-0.3, 0.3)
                for f in range(frames):
                    out[i, f, ..., c] += amp * np.cos(m * phi + ph + om * f) * np.sin(theta) ** m
    return out.astype(np.float32)


def trainer_pair(coords: np.ndarray, *extra: str):
    """(JAX shallow_water trainer, its state, port trainer with that state, port state)."""
    over = [f"{k}={v}" for k, v in OVERRIDES.items()] + list(extra)
    jcfg = jax_load_config("shallow_water", over)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    # Scale the ODE readouts (initialised at 1e-6) so the rollout moves the latents.
    ode = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if any(f"Dense_{i}" in str(path) for i in (3, 4)) else v,
        jstate.params["ode"])
    jstate = jstate.replace(params={**jstate.params, "ode": ode})
    cfg = load_experiment_config("shallow_water", over)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    return jtr, jstate, tr, tr.load_state(convert_params(np_tree(jstate.params)))


@pytest.fixture(scope="module")
def pair():
    """The trainers at 8 latents on an 8 x 4 sphere grid, and two trajectories."""
    grid = SphereGrid(NPHI, NTHETA, device="cpu")
    return (*trainer_pair(angular_coords(grid.phi, grid.theta)),
            smooth_sphere_trajectories(B, FRAMES, grid, seed=11))


def ode_draws(jtr, rng, num_coords: int):
    k_inner, k_mask = jax.random.split(rng)
    T, M = jtr.cfg.dataset.traj_len_train, jtr.cfg.training.max_num_sampled_points
    ode_masks = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, num_coords)[:M])(
        jax.random.split(k_mask, T)))
    return inner_masks(jtr.cfg, k_inner, num_coords), ode_masks


def test_nef_loss_and_grads_match_jax(pair):
    """``inner_learning_rate_p: 0``: the poses do not move in the inner loop, their
    outer gradient still flows through the invariant and the window."""
    jtr, jstate, tr, state, traj = pair
    assert tr.cfg.meta.inner_learning_rate_p == 0.0
    rng = jax.random.PRNGKey(5)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._nef_loss))(jstate.params, jnp.asarray(traj), rng)
    k_sel, k_inner = jax.random.split(rng)
    fos = jtr.cfg.training.nef.fit_on_num_steps
    frame_idx = np.asarray(jax.random.permutation(k_sel, jtr.cfg.dataset.traj_len_train)[:fos])
    masks = inner_masks(jtr.cfg, k_inner, NPHI * NTHETA)
    loss, got = tr.nef_grads(state, torch.from_numpy(traj), frame_idx=frame_idx, masks=masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert float(np.abs(np.asarray(want["autodecoder"]["p_pos"])).max()) > 0
    assert compare_grads(got, port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder")) > 10


def test_ode_loss_and_ode_grads_match_jax_on_the_kernel_backend(pair):
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(6)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda op: jtr._ode_loss(dict(jstate.params, ode=op), jnp.asarray(traj), rng)
    ))(jstate.params["ode"])
    masks, ode_masks = ode_draws(jtr, rng, NPHI * NTHETA)
    assert tr.ode_backend == "kernel"  # ode_backend: pallas -> FusedDecode (K1 + K2; plain here)
    launches = fd.fused_decode_fwd.launches, fd.fused_decode_bwd.launches
    loss, got = tr.ode_grads(state, torch.from_numpy(traj), masks=masks, ode_masks=ode_masks)
    assert (fd.fused_decode_fwd.launches, fd.fused_decode_bwd.launches) == launches  # no card: no launch
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare_grads(got, {"ode": flax_to_state_dict(np_tree(want))}, ("ode",)) > 10


def test_dual_loss_and_grads_match_jax_on_the_kernel_backend(pair):
    """The rollout decode's gradients reach the decoder, the inner learning rates, the
    latent init (poses included, through the latitude invariant and the sphere window)
    and the ODE."""
    jtr, jstate, tr, state, traj = pair
    rng = jax.random.PRNGKey(8)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._ode_loss))(jstate.params, jnp.asarray(traj), rng)
    masks, ode_masks = ode_draws(jtr, rng, NPHI * NTHETA)
    loss, got = tr.dual_grads(state, torch.from_numpy(traj), masks=masks, ode_masks=ode_masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert float(got["autodecoder"]["p_pos"].abs().max()) > 0
    assert compare_grads(got, port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder", "ode")) > 20


def check_val_step(jtr, jstate, tr, state, traj, batch_idx: int) -> None:
    """``val_step`` on the kernel backend (its plain version here) against JAX's, from
    the draws JAX folds from ``batch_idx``."""
    assert tr.eval_backend == "kernel"
    want_in, want_out = jtr.val_step(jstate, jnp.asarray(traj), batch_idx)
    _, k_mask, _ = jax.random.split(jax.random.fold_in(jstate.rng, batch_idx), 3)
    masks = np.asarray(sample_coordinate_masks(k_mask, tr.coords.shape[0], jtr.cfg.meta.num_inner_steps + 1,
                                               jtr.cfg.training.max_num_sampled_points))
    got_in, got_out = tr.val_step(state, torch.from_numpy(traj), masks=masks)
    assert float(want_out) > 0
    assert_close(got_in, want_in, rtol=1e-3, atol=1e-6)  # 2 inner steps + a rollout, as the NS test
    assert_close(got_out, want_out, rtol=1e-3, atol=1e-6)


def test_val_step_matches_jax(pair):
    jtr, jstate, tr, state, traj = pair
    check_val_step(jtr, jstate, tr, state, traj, 3)


def test_superres_val_step_on_the_full_grid_matches_jax():
    """The super-resolution eval's step: ``val_step`` of one signal decoded at the 192 x 96
    grid's 18,432 points (9 chunks of 2,048 on the kernel backend)."""
    coords = dataset_spec("shallow_water", device="cpu").coords
    assert coords.shape == (192 * 96, 2)
    jtr, jstate, tr, state = trainer_pair(coords, "training.max_num_sampled_points=2048")  # the chunk
    traj = smooth_sphere_trajectories(1, FRAMES, SphereGrid(192, 96, device="cpu"), seed=12)
    check_val_step(jtr, jstate, tr, state, traj, 1)


# ----------------------------------------------------------------- K2's check at a ReLU's kink


def test_relu_ties_find_the_points_at_a_kink():
    """``chip_smoke.relu_ties`` flags the points where some latent's RFF ReLU sits within
    rounding of its kink, where two right f32 VJPs may differ by a whole unit's share (so
    the card's K2 check zeroes the cotangent there): a pre-activation put at 0 in float64 is
    found, and away from the flagged points the f32 VJP agrees with the float64 one."""
    cfg = shape_config("shallow_water", "nef.num_hidden=16")
    coords = dataset_spec("shallow_water_low_res", device="cpu").coords
    args = decode_inputs(cfg, coords, torch.device("cpu"), 2, 64, 3)
    inv, ws = args[0], list(args[6])
    b0, z0, c0, unit = 1, 5, 17, 3
    proj = 2 * np.pi * (inv[b0, z0, c0].double() @ ws[0].double())
    feats = torch.cat([torch.sin(proj), torch.cos(proj)])
    ws[2] = ws[2].clone()
    ws[2][unit] = float(-(feats @ ws[1].double())[unit])  # q_b1: the unit's pre-activation ~0 there
    args = (*args[:6], tuple(ws), args[7])
    ties = relu_ties(args)
    assert ties.shape == (2, 64) and bool(ties[b0, c0])
    assert int(ties.sum()) <= 8  # a handful: the margin is far below the pre-activations' spread
    assert TIE_MARGIN == 1e-6
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 64, OUT)).astype(np.float32))
    gk = g * (~ties)[..., None]
    got = fd.fused_decode_bwd_plain(*args, gk, 2, 16, True)
    want = fd.fused_decode_bwd_plain(*(x.double() for x in args[:6]), tuple(w.double() for w in args[6]),
                                     tuple(w.double() for w in args[7]), gk.double(), 2, 16, True)
    for a, b in zip(got[:6], want[:6]):
        assert rel_l2(a, b) <= 1e-5
