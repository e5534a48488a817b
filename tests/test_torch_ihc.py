"""The port's ``ihc`` model path (``ball`` and ``ball_lat`` geometries) against the JAX package, on the CPU.

Covers what the convection-in-the-ball experiment adds: the SO(3) ``BallInvariant`` (the
query direction rotated into the latent's Z-Y-X Euler frame and both radii, I = 5) and the
longitude-only ``BallLatInvariant`` (I = 6) with their sphere windows; the Fibonacci
Euler-angle latents and their window size; PONITA over I = 5 (780 polynomial features at
degree 3) with 4 pose dims; the JAX package's whole initial state at the config's full
width, loaded strictly; the kernel backend of the decoder (plain version of K1 on the CPU)
at H = 3 and I = 5 with z = 4 and z = 25 against JAX's ``pallas_interpret``; the ball
equivariance check of both invariants against JAX's; and the nef / ode / dual losses and
gradients and ``val_step`` at a small config. Inputs are drawn with numpy from fixed
seeds. Tolerances: invariants and windows rtol 1e-6 (atol 1e-6); latents exact but alpha
(arccos in f32: 2.4e-7); the vector field rtol 1e-5; decodes rel-L2 1e-5; the unwindowed
rotation error 1e-4, the windowed one JAX's within rtol 1e-3; losses rtol 1e-4, gradients
rtol 2e-4 / atol 2e-5 (as ``tests/test_torch_train.py``); validation MSE rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.dynamics.ponita import PonitaLatentODE as JaxPonitaODE
from enf_pde_tpu.geometry.invariants import BallInvariant as JaxBall
from enf_pde_tpu.geometry.invariants import BallLatInvariant as JaxBallLat
from enf_pde_tpu.geometry.latent_init import default_gaussian_window_size as jax_window_size
from enf_pde_tpu.geometry.latent_init import init_positions_ball as jax_init_ball
from enf_pde_tpu.models.decoder import EnfDecoder as JaxDecoder
from enf_pde_tpu.models.latents import init_latents as jax_init_latents
from enf_pde_tpu.train.inner_loop import sample_coordinate_masks
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer
from enf_pde_tpu.utils.equivariance import equivariance_errors as jax_equivariance_errors

from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.convert import convert_params, flax_to_state_dict
from enf_pde_tpu_torch.data import ball_coords
from enf_pde_tpu_torch.dynamics.ponita import PonitaLatentODE
from enf_pde_tpu_torch.geometry.invariants import BallInvariant, BallLatInvariant, get_ca_invariant, get_sa_invariant
from enf_pde_tpu_torch.geometry.latent_init import default_gaussian_window_size, init_positions_ball
from enf_pde_tpu_torch.models.decoder import EnfDecoder
from enf_pde_tpu_torch.models.latents import init_latents
from enf_pde_tpu_torch.ops import fused_decode as fd
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.utils.equivariance import equivariance_errors
from tests.test_torch_modules import assert_close, load_flax, np_tree, t
from tests.test_torch_sphere import rel_l2
from tests.test_torch_train import LOSS_RTOL, compare_grads, inner_masks, port_grads

torch.set_num_threads(1)

B = 2
INVARIANTS = {"ball": (BallInvariant, JaxBall), "ball_lat": (BallLatInvariant, JaxBallLat)}


def ball_inputs(seed=0, b=B, n=48, z=8, lat=4):
    """Queries (phi, theta, r), poses (alpha, beta, gamma, r) and contexts and window
    sizes; the first pose's (alpha, beta) sits on the first query's (phi, theta), where
    the window's arccos clip binds."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0, 2 * np.pi, (b, n)), rng.uniform(0.05, np.pi - 0.05, (b, n)),
                  rng.uniform(0, 1, (b, n))], -1)
    p = np.stack([rng.uniform(0, 2 * np.pi, (b, z)), rng.uniform(0.05, np.pi - 0.05, (b, z)),
                  rng.uniform(0, 2 * np.pi, (b, z)), rng.uniform(0.3, 1.0, (b, z))], -1)
    p[:, 0, :2] = x[:, 0, :2]
    a = 1 + 0.5 * rng.standard_normal((b, z, lat))
    sigma = rng.uniform(0.5, 1.5, (b, z, 1))
    return tuple(v.astype(np.float32) for v in (x, p, a, sigma))


# ----------------------------------------------------------------- geometry


@pytest.mark.parametrize("name", ["ball", "ball_lat"])
def test_ball_invariants_and_windows_match_jax(name):
    cls, jcls = INVARIANTS[name]
    port, jinv = cls(), jcls()
    x, p, _, sigma = ball_inputs(1)
    assert (port.dim, port.num_x_pos_dims, port.num_z_pos_dims, port.num_z_ori_dims, port.is_periodic) == (
        jinv.dim, jinv.num_x_pos_dims, jinv.num_z_pos_dims, jinv.num_z_ori_dims, jinv.is_periodic) == (
        5 if name == "ball" else 6, 3, 4, 0, False)
    got = port(t(x), t(p))
    assert got.shape == (B, x.shape[1], p.shape[1], port.dim)
    assert_close(got, jinv(x, p), rtol=1e-6, atol=1e-6)
    assert_close(got[..., -2], np.broadcast_to(x[:, :, None, 2], got.shape[:3]), atol=0)  # r_x
    assert_close(got[..., -1], np.broadcast_to(p[:, None, :, 3], got.shape[:3]), atol=0)  # r_p
    if name == "ball":  # a rotated unit vector
        np.testing.assert_allclose(torch.linalg.vector_norm(got[..., :3], dim=-1).numpy(), 1.0, atol=1e-6)
    window = port.gaussian_window(t(x), t(p), t(sigma))
    assert window.shape == (B, x.shape[1], p.shape[1], 1)
    assert_close(window, jinv.gaussian_window(x, p, sigma), rtol=1e-6, atol=1e-6)
    d0 = np.arccos(np.float32(1 - 1e-6))  # (alpha, beta) read as (phi, theta): the clip binds
    assert_close(window[:, 0, 0, 0], np.exp(-d0**2 / (2 * sigma[:, 0, 0] ** 2)), atol=1e-6)


@pytest.mark.parametrize("name", ["ball", "ball_lat"])
def test_ball_invariants_build_for_both_attentions(name):
    cfg = Config({"invariant_type": name, "num_in": 3})
    cls = INVARIANTS[name][0]
    assert isinstance(get_ca_invariant(cfg), cls) and isinstance(get_sa_invariant(cfg), cls)
    dec, ode = build_models(load_experiment_config("ihc", [f"nef.invariant_type={name}"]))
    assert isinstance(dec.cross_attn_invariant, cls) and isinstance(ode.PonitaGen_0.invariant, cls)


# ----------------------------------------------------------------- latents


@pytest.mark.parametrize("num_latents", [4, 25])
def test_ball_latent_init_matches_jax(num_latents):
    """Fibonacci Euler angles: gamma, beta and the radius equal JAX's; alpha, an f32
    arccos, within two units in the last place (2.4e-7)."""
    got, want = init_positions_ball(3, num_latents, 3), np.asarray(jax_init_ball(3, num_latents, 3))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, num_latents, 4)
    np.testing.assert_array_equal(got[..., 1:].numpy(), want[..., 1:])
    np.testing.assert_allclose(got[..., 0].numpy(), want[..., 0], rtol=0, atol=2.4e-7)
    assert default_gaussian_window_size("ball", num_latents, 4) == jax_window_size("ball", num_latents, 4) == 1.0
    lat = init_latents(1, num_latents, 8, 4, 0, coordinate_system="ball", gaussian_window_size=-1)
    jlat = jax_init_latents(1, num_latents, 8, 4, 0, coordinate_system="ball", gaussian_window_size=-1)
    assert list(lat) == list(jlat) == ["p_pos", "a", "gaussian_window"]
    for k in ("a", "gaussian_window"):
        np.testing.assert_array_equal(lat[k].numpy(), np.asarray(jlat[k]))
    assert_close(lat["p_pos"], jlat["p_pos"], atol=2.4e-7)


# ----------------------------------------------------------------- PONITA over I = 5


def test_ball_ponita_field_matches_jax():
    """inv(p, p) reads the poses (alpha, beta, gamma) as (phi, theta, r), the reference's
    quirk; the vector readout covers the 4 pose dims."""
    _, p, a, w = ball_inputs(9, z=8, lat=8)
    kw = dict(num_hidden=32, num_layers=2, scalar_num_out=8, vec_num_out=1, basis_dim=16, degree=3,
              widening_factor=2, kernel_size="global")
    jode = JaxPonitaODE(invariant=JaxBall(), **kw)
    lat = (p, a, w)
    params = jode.init(jax.random.PRNGKey(9), lat)
    # Bring the readouts' 1e-6-scale initial weights up so that the field is not ~0.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if any(f"Dense_{i}" in str(path) for i in (3, 4)) else v, params)
    ode = load_flax(PonitaLatentODE(invariant=BallInvariant(), **kw), params)
    gen = ode.PonitaGen_0
    assert gen.Dense_0.weight.shape == (32, 5 + 25 + 125 + 625)  # polynomial features of I = 5, degree 3
    assert gen.Dense_4.weight.shape == (1, 5 + 32) and not hasattr(gen, "Dense_5")
    dp, da, dw = ode(tuple(t(v) for v in lat))
    jdp, jda, jdw = jode.apply(params, lat)
    assert dp.shape == (B, 8, 4) and da.shape == (B, 8, 8)
    assert float(dp.detach().abs().max()) > 1e-3 and float(da.detach().abs().max()) > 1e-3
    assert_close(dp, jdp, rtol=1e-5, atol=1e-6)
    assert_close(da, jda, rtol=1e-5, atol=1e-6)
    assert_close(dw, jdw, atol=0)


# ----------------------------------------------------------------- weights carried across


@pytest.mark.parametrize("name", ["ball", "ball_lat"])
def test_converted_full_width_init_gives_the_same_decode_and_field(name):
    """JAX's initial parameters of the whole experiment at its published width (decoder
    hidden 32, 3 heads, 25 latents of 32, RFF over I = 5 or 6; PONITA 3 layers, hidden 128,
    basis 64 over 4 pose dims), loaded strictly, give the same decode and vector field."""
    over = [f"nef.invariant_type={name}"]
    jcfg = jax_load_config("ihc", over)
    coords = ball_coords(8, 4, 4)  # 128 points: JAX's init decodes 128
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    cfg = load_experiment_config("ihc", over)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    dim = 5 if name == "ball" else 6
    assert tr.coordinate_system == "ball" and tr.ode_backend == "eager" and tr.eval_backend == "kernel"
    assert tr.decoder.cross_attn_invariant.dim == dim
    assert tr.ode_model.PonitaGen_0.Dense_0.weight.shape == (128, sum(dim ** k for k in range(1, 5)))
    assert set(state["autodecoder"]) == set(state["meta_sgd_lrs"]) == {"p_pos", "a", "gaussian_window"}
    assert state["autodecoder"]["p_pos"].shape == (1, 25, 4)
    assert_close(state["autodecoder"]["p_pos"], jstate.params["autodecoder"]["p_pos"], atol=0)
    _, p, a, sigma = ball_inputs(5, z=25, lat=32)
    x = np.broadcast_to(coords, (B, *coords.shape)).copy()
    want = jtr.decoder.apply(jstate.params["nef"], x, p, a, sigma)
    with torch.no_grad():
        got = tr.decoder(t(x), t(p), t(a), t(sigma))
        assert got.shape == (B, coords.shape[0], 1)
        assert rel_l2(got, want) <= 1e-5
        field = tr.ode_model((t(p), t(a), t(sigma)))
    for got, w in zip(field, jtr.ode_model.apply(jstate.params["ode"], (p, a, sigma))):
        assert_close(got, w, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- K1 backend at H = 3, I = 5


def ball_decoders(use_window: bool = True, hid: int = 16, lat: int = 8, name: str = "ball"):
    kw = dict(num_hidden=hid, num_heads=3, num_layers=0, num_out=1, latent_dim=lat, embedding_type="rff",
              condition_value_transform=True, use_gaussian_window=use_window)
    cls, jcls = INVARIANTS[name]
    jdec = JaxDecoder(cross_attn_invariant=jcls(), self_attn_invariant=jcls(), embedding_freq_multiplier=(0.2, 0.5),
                      backend="pallas_interpret", **kw)
    dec = EnfDecoder(cross_attn_invariant=cls(), embedding_freq_multiplier=(0.2, 0.5), **kw)
    return jdec, dec


@pytest.mark.parametrize("z", [4, 25])
def test_kernel_backend_at_three_heads_matches_jax_pallas_interpret(z):
    """I = 5, H = 3 (the mixer's odd head), hid = hidm = D = 16, the window on; z = 25 runs
    latent groups 4 x 6 and a last group of one latent; 40 points, not a multiple of K1's
    32-point tile."""
    jdec, dec = ball_decoders()
    x, p, a, sigma = ball_inputs(z, n=40, z=z, lat=8)
    params = jdec.init(jax.random.PRNGKey(z), x, p, a, sigma)
    load_flax(dec, params)
    want = jdec.apply(params, x, p, a, sigma)
    with torch.no_grad():
        args = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
        assert args[0].shape == (B, z, 40, 5)  # inv [b, z, c, I]: I = 5
        assert args[2].shape == (B, z, 16, 3) and args[4].shape == (B, z, 16, 48)  # A, G: H = 3
        assert bool((args[1] != 0).all())  # the window bias
        got = dec(t(x), t(p), t(a), t(sigma), backend="kernel")
        eager = dec(t(x), t(p), t(a), t(sigma))
    assert got.shape == (B, 40, 1)
    assert rel_l2(got, want) <= 1e-5
    assert rel_l2(got, eager) <= 1e-5


def test_flop_count_and_shared_memory_at_ihc_widths():
    """K1 at the published widths: I = 5, hid = hidm = D = 32, H = 3, z = 25, num_out = 1.
    Per latent: RFF projection 2 I hid/2, three hid^2 layers, logits hid H, G hid H hidm,
    mixer H hidm D; the tail 3 (HD)^2 + HD hid + hid^2 + hid; 2 FLOPs a multiply-add. The
    shared memory of the width class 32 (X, Y [128 x 36], acc [32 x 100], the four shared
    weights resident, 32 KB, the softmax state of 3 heads and a group's A) does not depend on
    z and leaves room for two blocks an SM; ``chip_smoke.py`` holds it against the built
    library's ``layout``."""
    per_latent = 2 * (2 * 5 * 16 + 3 * 32 * 32 + 32 * 3 + 32 * 96 + 3 * 32 * 32)
    tail = 2 * (3 * 96 * 96 + 96 * 32 + 32 * 32 + 32)
    assert fd.decode_flops_per_point(3, 32, 32, 32, 25, 5, 1) == 25 * per_latent + tail == 537_152
    assert fd.k1_smem_bytes(25, 5, 32, 3, 32, 32) == fd.k1_smem_bytes(4, 5, 32, 3, 32, 32) == 93_824
    assert fd.k1_width_class(32, 32, 32) == 32 and 2 * (93_824 + 1024) <= 233_472


# ----------------------------------------------------------------- equivariance


@pytest.mark.parametrize("name,use_window", [("ball", False), ("ball", True), ("ball_lat", True)])
def test_ball_equivariance_check_matches_jax(name, use_window):
    """``ball`` without the window: the joint rotation (poses R -> R Q^T) is exact to f32
    rounding. With the window (which reads (alpha, beta) as sphere angles) it is not, by
    design, and the value equals JAX's. ``ball_lat``: the longitude shift is exact."""
    jdec, dec = ball_decoders(use_window, name=name)
    x, p, a, sigma = ball_inputs(4, n=64, z=8, lat=8)
    params = jdec.init(jax.random.PRNGKey(2), x, p, a, sigma)
    load_flax(dec, params)
    jinv = INVARIANTS[name][1]()
    want = jax_equivariance_errors(jdec.clone(backend="xla").apply, params,
                                   *(jnp.asarray(v) for v in (x, p, a, sigma)), invariant=jinv,
                                   coordinate_system="ball")
    got = equivariance_errors(dec, t(x), t(p), t(a), t(sigma), invariant=dec.cross_attn_invariant,
                              coordinate_system="ball")
    key = "rotation" if name == "ball" else "longitude"
    assert set(got) == set(want) == {key}
    if use_window and name == "ball":
        assert got[key] > 1e-3  # the window's quirk
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3)
    else:
        assert got[key] <= 1e-4 and want[key] <= 1e-4


# ----------------------------------------------------------------- training parity


OVERRIDES = {
    "nef.num_hidden": 16,
    "nef.latent_dim": 8,
    "nef.num_latents": 9,
    "node.num_hidden": 32,
    "node.basis_dim": 16,
    "node.num_layers": 1,
    "meta.num_inner_steps": 2,
    "training.max_num_sampled_points": 24,
    "dataset.traj_len_train": 4,
    "dataset.traj_len_out_horizon": 2,
}
NPHI, NTHETA, NR, FRAMES = 8, 4, 3, 6


def smooth_ball_trajectories(n: int, frames: int, seed: int) -> np.ndarray:
    """Seeded smooth fields on the (phi, theta, r) grid drifting in longitude,
    [n, frames, nphi, ntheta, nr, 1], on the conductive profile 1 - r^2."""
    rng = np.random.default_rng(seed)
    c = ball_coords(NPHI, NTHETA, NR).reshape(NPHI, NTHETA, NR, 3)
    phi, theta, r = c[..., 0], c[..., 1], c[..., 2]
    out = np.zeros((n, frames, NPHI, NTHETA, NR))
    for i in range(n):
        for m in range(3):
            amp, ph, om = rng.standard_normal(), rng.uniform(0, 2 * np.pi), rng.uniform(-0.3, 0.3)
            for f in range(frames):
                out[i, f] += 0.3 * amp * r * np.cos(m * phi + ph + om * f) * np.sin(theta) ** m
        out[i] += 1 - r**2
    return out[..., None].astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX ihc trainer, its state, port trainer with that state, port state, two
    trajectories) at 9 latents on an 8 x 4 x 3 ball grid."""
    over = [f"{k}={v}" for k, v in OVERRIDES.items()]
    jcfg = jax_load_config("ihc", over)
    coords = ball_coords(NPHI, NTHETA, NR)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    # Scale the ODE readouts (initialised at 1e-6) so the rollout moves the latents.
    ode = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if any(f"Dense_{i}" in str(path) for i in (3, 4)) else v,
        jstate.params["ode"])
    jstate = jstate.replace(params={**jstate.params, "ode": ode,
                                    "autodecoder": {**jstate.params["autodecoder"], "p_pos": drawn_poses()}})
    cfg = load_experiment_config("ihc", over)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    return jtr, jstate, tr, state, smooth_ball_trajectories(B, FRAMES, seed=11)


def drawn_poses(z: int = OVERRIDES["nef.num_latents"]) -> jnp.ndarray:
    """Seeded Euler angles in [0, 2 pi) x (0.3, pi - 0.3) x [0, 2 pi) at radius 0.75, in
    place of the Fibonacci init, whose beta = pi (1 + sqrt 5) i reaches 91 rad at 9 latents:
    the f32 spacing of such angles leaves the ODE gradients undetermined to 2e-4 (see
    ``test_fibonacci_poses_leave_jax_ode_gradients_to_rounding``)."""
    rng = np.random.default_rng(21)
    p = np.stack([rng.uniform(0, 2 * np.pi, z), rng.uniform(0.3, np.pi - 0.3, z), rng.uniform(0, 2 * np.pi, z),
                  np.full(z, 0.75)], -1)
    return jnp.asarray(p[None].astype(np.float32))


def ode_draws(jtr, rng):
    k_inner, k_mask = jax.random.split(rng)
    T, N, M = jtr.cfg.dataset.traj_len_train, NPHI * NTHETA * NR, jtr.cfg.training.max_num_sampled_points
    ode_masks = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, N)[:M])(jax.random.split(k_mask, T)))
    return inner_masks(jtr.cfg, k_inner, N), ode_masks


def test_fibonacci_poses_leave_jax_ode_gradients_to_rounding(pair):
    """Why the parity tests draw their poses: at the Fibonacci init's (beta up to 91 rad,
    where f32 is spaced 7.6e-6) a nudge of the poses by 1e-7 of themselves moves JAX's own
    ODE gradients by more than 1e-3 (8.6e-3 measured), five times the 2e-4 that the port is
    held to; at the drawn poses the same nudge moves them by less than 2e-4."""
    jtr, jstate, _, _, traj = pair
    rng = jax.random.PRNGKey(6)
    fib = jnp.asarray(jax_init_ball(1, OVERRIDES["nef.num_latents"], 3))
    assert float(jnp.abs(fib[..., 1]).max()) > 90

    @jax.jit
    def grads(p):
        params = dict(jstate.params, autodecoder={**jstate.params["autodecoder"], "p_pos": p})
        return jax.grad(lambda op: jtr._ode_loss(dict(params, ode=op), jnp.asarray(traj), rng))(params["ode"])

    def moved(p_pos):
        nudge = 1 + 1e-7 * np.random.default_rng(0).standard_normal(p_pos.shape)
        a, b = (flax_to_state_dict(np_tree(g)) for g in (grads(p_pos), grads(p_pos * nudge.astype(np.float32))))
        return max(rel_l2(b[k], a[k]) for k in a)

    assert moved(fib) > 1e-3
    assert moved(drawn_poses()) < 2e-4


def test_nef_loss_and_grads_match_jax(pair):
    """``inner_learning_rate_p: 0``: the poses do not move in the inner loop; their outer
    gradient flows through the Euler rotation and the window."""
    jtr, jstate, tr, state, traj = pair
    assert tr.cfg.meta.inner_learning_rate_p == 0.0
    rng = jax.random.PRNGKey(5)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._nef_loss))(jstate.params, jnp.asarray(traj), rng)
    k_sel, k_inner = jax.random.split(rng)
    fos = jtr.cfg.training.nef.fit_on_num_steps
    frame_idx = np.asarray(jax.random.permutation(k_sel, jtr.cfg.dataset.traj_len_train)[:fos])
    masks = inner_masks(jtr.cfg, k_inner, NPHI * NTHETA * NR)
    loss, got = tr.nef_grads(state, torch.from_numpy(traj), frame_idx=frame_idx, masks=masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert float(np.abs(np.asarray(want["autodecoder"]["p_pos"])).max()) > 0
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
    assert float(got["autodecoder"]["p_pos"].abs().max()) > 0
    assert compare_grads(got, port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder", "ode")) > 20


def test_val_step_matches_jax(pair):
    """Validation decodes through the kernel backend (``eval_backend: pallas``; its plain
    version on the CPU): in-t and out-t MSE against JAX's, from the same draws."""
    jtr, jstate, tr, state, traj = pair
    assert tr.eval_backend == "kernel"
    want_in, want_out = jtr.val_step(jstate, jnp.asarray(traj), 3)
    _, k_mask, _ = jax.random.split(jax.random.fold_in(jstate.rng, 3), 3)
    masks = np.asarray(sample_coordinate_masks(k_mask, NPHI * NTHETA * NR, jtr.cfg.meta.num_inner_steps + 1,
                                               jtr.cfg.training.max_num_sampled_points))
    got_in, got_out = tr.val_step(state, torch.from_numpy(traj), masks=masks)
    assert float(want_out) > 0
    assert_close(got_in, want_in, rtol=1e-3, atol=1e-6)  # 2 inner steps + a rollout, as the NS test
    assert_close(got_out, want_out, rtol=1e-3, atol=1e-6)
