"""The PyTorch port's modules against their JAX counterparts, on the CPU.

Inputs are drawn with numpy from fixed seeds; flax parameters go through
``enf_pde_tpu_torch.convert``. Tolerances are f32 (the conftest pins JAX's matmul
precision to "highest"): rtol 1e-4 / atol 2e-5 unless a test says otherwise.
"""

import jax
import numpy as np
import pytest
import torch

from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.dynamics.ponita import PonitaLatentODE as JaxPonitaODE
from enf_pde_tpu.dynamics.solvers import solve_latent_ode as jax_solve
from enf_pde_tpu.geometry.invariants import RelativePositionPeriodic as JaxPeriodic
from enf_pde_tpu.geometry.latent_init import default_gaussian_window_size as jax_window_size
from enf_pde_tpu.models.decoder import EnfDecoder as JaxDecoder
from enf_pde_tpu.models.latents import init_latents as jax_init_latents
from enf_pde_tpu.models.latents import tile_latents as jax_tile_latents
from enf_pde_tpu.ops.attention import EquivariantCrossAttention as JaxAttention
from enf_pde_tpu.ops.attention import PointwiseFFN as JaxPointwiseFFN
from enf_pde_tpu.ops.embeddings import RFFNet as JaxRFFNet
from enf_pde_tpu.ops.embeddings import polynomial_features as jax_poly
from enf_pde_tpu.train.inner_loop import init_meta_sgd_lrs as jax_init_lrs

from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.convert import flax_to_state_dict
from enf_pde_tpu_torch.dynamics.ponita import PonitaLatentODE
from enf_pde_tpu_torch.dynamics.solvers import solve_latent_ode
from enf_pde_tpu_torch.geometry.invariants import (
    BaseInvariant,
    RelativePositionPeriodic,
    get_ca_invariant,
)
from enf_pde_tpu_torch.geometry.latent_init import default_gaussian_window_size
from enf_pde_tpu_torch.models.decoder import EnfDecoder
from enf_pde_tpu_torch.models.latents import init_latents, latents_to_pose, tile_latents
from enf_pde_tpu_torch.ops.attention import EquivariantCrossAttention, PointwiseFFN
from enf_pde_tpu_torch.ops.embeddings import RFFNet, polynomial_features
from enf_pde_tpu_torch.ops.layers import reset_parameters
from enf_pde_tpu_torch.train.inner_loop import init_meta_sgd_lrs, sample_coordinate_masks

torch.set_num_threads(1)

B, N, Z, D, H, LAT = 2, 64, 4, 32, 2, 8
RTOL, ATOL = 1e-4, 2e-5


def to_np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def assert_close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=rtol, atol=atol)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load_flax(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    module.load_state_dict(flax_to_state_dict(np_tree(flax_params)), strict=True)
    return module


def torus_inputs(seed=0, b=B, n=N, z=Z, lat=LAT):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)
    p = rng.uniform(-1, 1, (b, z, 2)).astype(np.float32)
    a = (1 + 0.5 * rng.standard_normal((b, z, lat))).astype(np.float32)
    sigma = rng.uniform(0.5, 1.5, (b, z, 1)).astype(np.float32)
    return x, p, a, sigma


def t(x):
    return torch.from_numpy(np.asarray(x))


# ----------------------------------------------------------------- config


def test_config_equals_yaml():
    assert load_experiment_config("navier_stokes").to_dict() == jax_load_config("navier_stokes").to_dict()


def test_config_attribute_access_and_unported_name():
    cfg = load_experiment_config("navier_stokes")
    assert isinstance(cfg.nef, Config) and cfg.nef.num_hidden == 128
    cfg.set_path("nef.num_hidden", 32)
    assert cfg.get_path("nef.num_hidden") == 32
    assert load_experiment_config("navier_stokes").nef.num_hidden == 128  # a fresh copy
    # Every shipped experiment is ported (ihc last); an unknown name raises.
    assert load_experiment_config("ihc").nef.invariant_type == "ball"
    with pytest.raises(ValueError, match="no_such_experiment"):
        load_experiment_config("no_such_experiment")


# ----------------------------------------------------------------- geometry


def test_periodic_invariant_and_window():
    x, p, _, sigma = torus_inputs()
    jinv = JaxPeriodic(2)
    inv = RelativePositionPeriodic(2)
    assert (inv.dim, inv.num_z_pos_dims, inv.is_periodic) == (4, 2, True)
    assert_close(inv(t(x), t(p)), jinv(x, p), atol=1e-6)
    # The torus window is +(1/sigma^2) sum cos^2(pi d), not the planar -d^2/sigma^2.
    got = inv.gaussian_window(t(x), t(p), t(sigma))
    assert_close(got, jinv.gaussian_window(x, p, sigma), atol=1e-6)
    assert (to_np(got) >= 0).all()


def test_base_window_is_planar_log_domain():
    x, p, _, sigma = torus_inputs(1)
    base = BaseInvariant(dim=2, num_x_pos_dims=2, num_z_pos_dims=2)
    want = -(1 / sigma[:, None] ** 2) * ((p[:, None] - x[:, :, None]) ** 2).sum(-1, keepdims=True)
    assert_close(base.gaussian_window(t(x), t(p), t(sigma)), want, atol=1e-6)


def test_unported_invariant_raises():
    """Every invariant name of the JAX package builds (the ball ones last); an unknown name
    raises ``ValueError``, as JAX's ``_build`` does."""
    assert get_ca_invariant(Config({"invariant_type": "ball", "num_in": 3})).dim == 5
    cfg = Config({"invariant_type": "no_such_invariant", "num_in": 2})
    with pytest.raises(ValueError, match="no_such_invariant"):
        get_ca_invariant(cfg)


# ----------------------------------------------------------------- latents


def test_init_latents_matches_jax():
    for num_latents in (4, 9, 16):
        got = init_latents(1, num_latents, LAT, 2, 0, gaussian_window_size=-1)
        want = jax_init_latents(1, num_latents, LAT, 2, 0, gaussian_window_size=-1)
        assert set(got) == set(want)
        for k in want:
            assert_close(got[k], want[k], atol=1e-7)
        assert default_gaussian_window_size("cartesian", num_latents, 2) == jax_window_size(
            "cartesian", num_latents, 2)


def test_tile_latents_and_pose():
    lat = init_latents(1, Z, LAT, 2, 0, gaussian_window_size=0.3)
    tiled = tile_latents(lat, 3)
    want = jax_tile_latents({k: np.asarray(v) for k, v in lat.items()}, 3)
    for k in want:
        assert_close(tiled[k], want[k], atol=0)
    p, a, w = latents_to_pose(tiled)
    assert p.shape == (3, Z, 2) and a.shape == (3, Z, LAT) and w.shape == (3, Z, 1)
    assert float(w[0, 0, 0]) == pytest.approx(0.3)


def test_meta_sgd_lrs_and_masks():
    got, want = init_meta_sgd_lrs(LAT, 1.0, 5.0, 0.0, False), jax_init_lrs(LAT, 1.0, 5.0, 0.0, False)
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], atol=0)
    masks = sample_coordinate_masks(torch.Generator().manual_seed(0), 100, 4, 64)
    assert masks.shape == (4, 64)
    assert all(len(set(m.tolist())) == 64 and int(m.max()) < 100 for m in masks)
    assert sample_coordinate_masks(None, 10, 2, 64).shape == (2, 10)  # capped at num_coords


# ----------------------------------------------------------------- embeddings and attention


def test_rffnet_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (B, N, Z, 4)).astype(np.float32)
    jnet = JaxRFFNet(in_dim=4, output_dim=D, hidden_dim=D, std=0.5)
    params = jnet.init(jax.random.PRNGKey(0), x)
    net = load_flax(RFFNet(4, D, D, std=0.5), params)
    assert not any("coefficients" in n for n, _ in net.named_parameters())  # a buffer
    assert_close(net(t(x)), jnet.apply(params, x))


def test_polynomial_features_match_jax():
    x = np.random.default_rng(4).standard_normal((B, Z, Z, 4)).astype(np.float32)
    got = polynomial_features(t(x), 3)
    assert got.shape[-1] == 4 + 16 + 64 + 256
    assert_close(got, jax_poly(x, 3))


def test_pointwise_ffn_matches_jax():
    x = np.random.default_rng(5).standard_normal((B, N, D)).astype(np.float32)
    jffn = JaxPointwiseFFN(num_in=D, num_hidden=D, num_out=2 * D)
    params = jffn.init(jax.random.PRNGKey(1), x)
    ffn = load_flax(PointwiseFFN(D, D, 2 * D), params)
    assert ffn.LayerNorm_0.eps == 1e-6
    assert_close(ffn(t(x)), jffn.apply(params, x))


@pytest.mark.parametrize("project_heads", [True, False])
def test_cross_attention_eager_matches_jax(project_heads):
    x, p, a, sigma = torus_inputs(6, lat=D)
    jattn = JaxAttention(
        num_hidden=D, num_heads=H, invariant=JaxPeriodic(2), embedding_type="rff",
        embedding_freq_multiplier=(0.5, 2.0), condition_value_transform=True,
        condition_invariant_embedding=False, project_heads=project_heads,
    )
    params = jattn.init(jax.random.PRNGKey(2), x, p, a, sigma)
    attn = load_flax(EquivariantCrossAttention(
        D, H, RelativePositionPeriodic(2), (0.5, 2.0), True, project_heads), params)
    assert_close(attn(t(x), t(p), t(a), t(sigma)), jattn.apply(params, x, p, a, sigma))


def jax_decoder(backend="xla", hidden=D, heads=H, lat=LAT):
    return JaxDecoder(
        num_hidden=hidden, num_heads=heads, num_layers=0, num_out=1, latent_dim=lat,
        cross_attn_invariant=JaxPeriodic(2), self_attn_invariant=JaxPeriodic(2),
        embedding_type="rff", embedding_freq_multiplier=(0.05, 0.1),
        condition_value_transform=True, backend=backend,
    )


def port_decoder(hidden=D, heads=H, lat=LAT):
    return EnfDecoder(
        num_hidden=hidden, num_heads=heads, num_layers=0, num_out=1, latent_dim=lat,
        cross_attn_invariant=RelativePositionPeriodic(2), embedding_type="rff",
        embedding_freq_multiplier=(0.05, 0.1), condition_value_transform=True,
    )


def decoder_pair(seed=7):
    """(jax decoder, its params, port decoder with those params, inputs)."""
    x, p, a, sigma = torus_inputs(seed)
    jdec = jax_decoder()
    params = jdec.init(jax.random.PRNGKey(seed), x, p, a, sigma)
    return jdec, params, load_flax(port_decoder(), params), (x, p, a, sigma)


def test_decoder_eager_matches_jax():
    jdec, params, dec, (x, p, a, sigma) = decoder_pair()
    want = jdec.apply(params, x, p, a, sigma)
    assert want.shape == (B, N, 1)
    assert_close(dec(t(x), t(p), t(a), t(sigma)), want)


def test_decoder_unported_options_raise():
    """Self attention and the ffn / polynomial embeddings are ported (their parity with JAX
    is in tests/test_torch_self_attention.py); what the decoder still refuses is a
    self-attention stack without its invariant, an unknown embedding, and the fused
    kernels on a decoder they do not compute."""
    with pytest.raises(ValueError, match="self_attn_invariant"):
        EnfDecoder(16, 2, 1, 1, 8, RelativePositionPeriodic(2), "rff", (0.1, 0.1), True)
    with pytest.raises(ValueError, match="Unknown embedding"):
        EnfDecoder(16, 2, 0, 1, 8, RelativePositionPeriodic(2), "fourier", (0.1, 0.1), True)
    dec = EnfDecoder(16, 2, 1, 1, 8, RelativePositionPeriodic(2), "ffn", (0.1, 0.1), True,
                     self_attn_invariant=RelativePositionPeriodic(2))
    reset_parameters(dec, torch.Generator().manual_seed(0))
    x, p, a, sigma = (t(v) for v in torus_inputs(3, lat=8))
    assert dec(x, p, a, sigma).shape == (B, N, 1) and not dec.kernel_eligible
    with pytest.raises(ValueError, match="backend='eager'"):
        dec(x, p, a, sigma, backend="kernel")


def test_reset_parameters_is_seeded_and_flax_like():
    dec_a, dec_b = port_decoder(hidden=128), port_decoder(hidden=128)
    reset_parameters(dec_a, torch.Generator().manual_seed(0))
    reset_parameters(dec_b, torch.Generator().manual_seed(0))
    for (n, pa), pb in zip(dec_a.state_dict().items(), dec_b.state_dict().values()):
        assert torch.equal(pa, pb), n
    sd = dec_a.state_dict()
    # lecun-normal kernel: std 1/sqrt(fan_in); RFF coefficients: normal(std=0.05).
    assert float(sd["latent_stem.weight"].std()) == pytest.approx(1 / np.sqrt(LAT), rel=0.2)
    coeff = sd["cross_attention_block.attn.invariant_embedding_query.RFFEmbedding_0.coefficients"]
    assert float(coeff.std()) == pytest.approx(0.05, rel=0.2)
    assert float(sd["cross_attention_block.attn.a_to_k.bias"].abs().max()) == 0.0


# ----------------------------------------------------------------- PONITA and solvers


def ponita_pair(kernel_size="global", seed=8, readout_scale=1e5):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (B, Z, 2)).astype(np.float32)
    a = (1 + 0.5 * rng.standard_normal((B, Z, LAT))).astype(np.float32)
    w = np.ones((B, Z, 1), np.float32)
    kw = dict(num_hidden=16, num_layers=2, scalar_num_out=LAT, vec_num_out=1, basis_dim=8,
              degree=3, widening_factor=2, kernel_size=kernel_size)
    jode = JaxPonitaODE(invariant=JaxPeriodic(2), **kw)
    params = jode.init(jax.random.PRNGKey(seed), (p, a, w))
    # Bring the readouts' 1e-6-scale initial weights up so the comparison exercises
    # them (a zero field would pass trivially).
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * readout_scale if "Dense_3" in str(path) or "Dense_4" in str(path) else v, params)
    ode = load_flax(PonitaLatentODE(invariant=RelativePositionPeriodic(2), **kw), params)
    return jode, params, ode, (p, a, w)


@pytest.mark.parametrize("kernel_size", ["global", 0.5])
def test_ponita_ode_matches_jax(kernel_size):
    jode, params, ode, lat = ponita_pair(kernel_size)
    dp, da, dw = ode(tuple(t(v) for v in lat))
    jdp, jda, jdw = jode.apply(params, lat)
    assert float(da.detach().abs().max()) > 1e-2  # a non-trivial field
    assert_close(dp, jdp)
    assert_close(da, jda)
    assert_close(dw, jdw, atol=0)


def test_ponita_ode_distance_grad_is_finite():
    _, _, ode, lat = ponita_pair(0.5)
    p = t(lat[0]).requires_grad_(True)
    dp, da, _ = ode((p, t(lat[1]), t(lat[2])))
    (g,) = torch.autograd.grad(da.sum() + dp.sum(), p)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_solve_latent_ode_matches_jax(method):
    jode, params, ode, lat = ponita_pair(readout_scale=300)  # a field that moves the state but stays O(1)
    want = jax_solve(lambda z, _: jode.apply(params, z), lat, t0=0, tf=4, h=1, method=method)
    with torch.no_grad():
        got = solve_latent_ode(lambda z, _: ode(z), tuple(t(v) for v in lat), 0, 4, 1, method)
    assert float((got[1][:, -1] - got[1][:, 0]).abs().max()) > 1e-2  # the state moved
    for g, w in zip(got, want):
        assert g.shape == (B, 5) + g.shape[2:]
        assert_close(g, w)
