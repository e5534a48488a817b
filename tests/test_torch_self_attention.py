"""The rest of the decoder family against the JAX package, on the CPU.

The ``ffn`` and ``polynomial`` embeddings, the attention's ``x_h`` conditioning of its
value-side invariant embedding, the decoder's latent self-attention stack
(``num_layers`` 1 and 2) for ``rel_pos_periodic`` and for the oriented ``ponita`` poses,
the kernel backend behind that stack (the plain version of K1 on the CPU) against JAX's
``pallas_interpret`` decode, its first-order gradients against the eager backend's, the
``EquivariantTransformer``, and JAX states of each kind converted and loaded strictly.
Flax parameters go through ``enf_pde_tpu_torch.convert``. Inputs are drawn with numpy from
fixed seeds. Tolerances: embeddings rtol 1e-5 / atol 1e-6; the attention, decoders and the
transformer rtol 1e-4 / atol 2e-5 (as ``tests/test_torch_modules.py``: the RFF value
embedding at frequency 2 rounds to 1e-5 of O(1) values); gradients rtol 2e-4 / atol 2e-5
(as ``tests/test_torch_fused_decode_bwd.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.geometry.invariants import RelativePositionPeriodic as JaxPeriodic
from enf_pde_tpu.geometry.invariants import Ponita2D as JaxPonita2D
from enf_pde_tpu.models.transformer import EquivariantTransformer as JaxTransformer
from enf_pde_tpu.ops.attention import EquivariantCrossAttention as JaxAttention
from enf_pde_tpu.ops.embeddings import get_embedding as jax_get_embedding
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer

from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.convert import convert_params
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.geometry.invariants import Ponita2D, RelativePositionPeriodic
from enf_pde_tpu_torch.models.transformer import EquivariantTransformer
from enf_pde_tpu_torch.ops.attention import EquivariantCrossAttention
from enf_pde_tpu_torch.ops.embeddings import get_embedding
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from tests.test_torch_modules import assert_close, load_flax, np_tree, t

torch.set_num_threads(1)

B, N, Z, HID, HEADS, LAT = 2, 24, 4, 16, 2, 8
EMB_RTOL, EMB_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
# The polynomial embedding's degree is int(freq_multiplier): 2 reaches the outer
# products; at the shipped 0.05 / 0.1 it is 0 and the embedding is the ffn one.
EMBEDDINGS = [("rff", (0.5, 2.0)), ("ffn", (0.05, 0.1)), ("polynomial", (2.0, 2.0))]


def inputs(seed, oriented=False, b=B, n=N, z=Z, lat=LAT):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)
    p = rng.uniform(-1, 1, (b, z, 2)).astype(np.float32)
    if oriented:
        p = np.concatenate([p, rng.uniform(-np.pi, np.pi, (b, z, 1)).astype(np.float32)], -1)
    a = (1 + 0.5 * rng.standard_normal((b, z, lat))).astype(np.float32)
    sigma = rng.uniform(0.5, 1.5, (b, z, 1)).astype(np.float32)
    return x, p, a, sigma


def configs(name, *overrides):
    over = [f"nef.num_hidden={HID}", f"nef.latent_dim={LAT}", f"nef.num_latents={Z}", *overrides]
    return jax_load_config(name, over), load_experiment_config(name, over)


def decoders(name, *overrides, seed=0, jax_backend="xla"):
    """(JAX decoder, its params, the port's decoder loaded strictly with them, inputs)."""
    jcfg, cfg = configs(name, f"nef.backend={jax_backend}", *overrides)
    jdec, dec = jax_build_models(jcfg)[0], build_models(cfg)[0]
    x, p, a, sigma = inputs(seed, oriented=dec.cross_attn_invariant.num_z_ori_dims > 0)
    params = jdec.init(jax.random.PRNGKey(seed), x, p, a, sigma)
    return jdec, params, load_flax(dec, params), (x, p, a, sigma)


# ----------------------------------------------------------------- embeddings, attention


@pytest.mark.parametrize("kind,freq", [("ffn", 0.1), ("polynomial", 2.0), ("polynomial", 3.0),
                                       ("polynomial", 0.05)])
def test_embeddings_match_jax(kind, freq):
    x = np.random.default_rng(1).uniform(-1, 1, (B, N, Z, 3)).astype(np.float32)
    jemb = jax_get_embedding(kind, num_in=3, num_hidden=HID, num_emb_dim=HID, freq_multiplier=freq)
    params = jemb.init(jax.random.PRNGKey(1), x)
    emb = load_flax(get_embedding(kind, 3, HID, HID, freq), params)
    if kind == "polynomial":  # the first dense reads I (1 + I + ... + I^degree) features
        assert emb.Dense_0.weight.shape[1] == sum(3 ** (k + 1) for k in range(int(freq) + 1))
    assert_close(emb(t(x)), jemb.apply(params, x), rtol=EMB_RTOL, atol=EMB_ATOL)


def test_polynomial_at_the_shipped_multipliers_is_the_ffn_embedding():
    """Degree int(0.05) = 0: the features are x alone, so the two embeddings have the same
    parameters and, loaded with the same ones, the same output."""
    x = t(np.random.default_rng(2).uniform(-1, 1, (B, N, 2)).astype(np.float32))
    poly, ffn = get_embedding("polynomial", 2, HID, HID, 0.05), get_embedding("ffn", 2, HID, HID, 0.05)
    torch.manual_seed(0)
    for m in (poly.Dense_0, poly.Dense_1):
        torch.nn.init.normal_(m.weight), torch.nn.init.normal_(m.bias)
    assert {k: v.shape for k, v in poly.state_dict().items()} == {k: v.shape for k, v in ffn.state_dict().items()}
    ffn.load_state_dict(poly.state_dict(), strict=True)
    assert torch.equal(poly(x), ffn(x))


@pytest.mark.parametrize("kind,freq", EMBEDDINGS)
def test_attention_with_x_h_conditioning_matches_jax(kind, freq):
    """condition_invariant_embedding: the value-side invariant embedding is FiLM'd by x_h."""
    x, p, a, sigma = inputs(3, lat=HID)
    x_h = np.random.default_rng(4).standard_normal((B, N, HID)).astype(np.float32)
    kw = dict(num_hidden=HID, num_heads=HEADS, embedding_freq_multiplier=freq,
              condition_value_transform=True, project_heads=True)
    jattn = JaxAttention(invariant=JaxPeriodic(2), embedding_type=kind, condition_invariant_embedding=True, **kw)
    params = jattn.init(jax.random.PRNGKey(3), x, p, a, sigma, x_h)
    attn = load_flax(EquivariantCrossAttention(invariant=RelativePositionPeriodic(2), embedding_type=kind,
                                               condition_invariant_embedding=True, **kw), params)
    want = jattn.apply(params, x, p, a, sigma, x_h)
    assert_close(attn(t(x), t(p), t(a), t(sigma), x_h=t(x_h)), want)
    with pytest.raises(ValueError, match="x_h"):
        attn(t(x), t(p), t(a), t(sigma))


# ----------------------------------------------------------------- the decoder


@pytest.mark.parametrize("name,layers,kind", [
    ("navier_stokes", 1, "rff"), ("navier_stokes", 2, "rff"), ("navier_stokes", 2, "ffn"),
    ("navier_stokes", 1, "polynomial"), ("diffusion_plane", 1, "rff"), ("diffusion_plane", 2, "rff"),
])
def test_decoder_with_self_attention_matches_jax(name, layers, kind):
    """rel_pos_periodic, and ponita's oriented poses: its self-attention invariant (Ponita2D)
    reads the poses with their angles already on the circle, as JAX's does."""
    freq = dict(EMBEDDINGS)[kind]
    jdec, params, dec, (x, p, a, sigma) = decoders(
        name, f"nef.num_layers={layers}", f"nef.embedding_type={kind}",
        f"nef.embedding_freq_multiplier_invariant={freq[0]}", f"nef.embedding_freq_multiplier_value={freq[1]}",
        seed=layers)
    assert sorted(n for n in params["params"] if n.startswith("self_attention")) == \
        [f"self_attention_blocks_{i}" for i in range(layers)]
    want = jdec.apply(params, x, p, a, sigma)
    got = dec(t(x), t(p), t(a), t(sigma))
    assert got.shape == (B, N, 1)
    assert_close(got, want)
    if name == "diffusion_plane":
        assert isinstance(dec.self_attention_blocks_0.attn.invariant, Ponita2D)


@pytest.mark.parametrize("name", ["navier_stokes", "diffusion_plane"])
def test_kernel_backend_behind_self_attention_matches_jax_pallas_interpret(name):
    """num_layers = 2: the blocks run before the weight folds; the plain K1 then decodes,
    against JAX's fused decode in interpret mode on the same attended latents."""
    jdec, params, dec, (x, p, a, sigma) = decoders(name, "nef.num_layers=2", seed=5,
                                                   jax_backend="pallas_interpret")
    want = jdec.apply(params, x, p, a, sigma)
    with torch.no_grad():
        got = dec(t(x), t(p), t(a), t(sigma), backend="kernel")
        eager = dec(t(x), t(p), t(a), t(sigma))
    assert_close(got, want)
    assert_close(got, eager)


def test_kernel_backend_gradients_behind_self_attention_equal_eager():
    """K2's gradients of the folded inputs flow back through the folds and the blocks to
    the latents and every parameter, as eager autograd's."""
    _, _, dec, (x, p, a, sigma) = decoders("navier_stokes", "nef.num_layers=2", seed=6)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal((B, N, 1)).astype(np.float32))
    params = list(dec.parameters())
    grads = {}
    for backend in ("eager", "kernel"):
        lat = [t(v).requires_grad_(True) for v in (p, a, sigma)]
        grads[backend] = torch.autograd.grad(dec(t(x), *lat, backend=backend), lat + params, g)
    names = ["p", "a", "sigma"] + [n for n, _ in dec.named_parameters()]
    assert any(n.startswith("self_attention_blocks_1.") for n in names)
    for n, ge, gk in zip(names, grads["eager"], grads["kernel"]):
        assert float(ge.abs().max()) > 0, n
        assert_close(gk, ge, rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ----------------------------------------------------------------- the transformer


@pytest.mark.parametrize("pooling,oriented", [(False, False), (True, False), (False, True), (True, True)])
def test_transformer_matches_jax(pooling, oriented):
    """Self attention conditioned on the latents' own features, no window; oriented poses
    (x, y, theta) through Ponita2D with JAX's p[:, :, :2] split."""
    x, p, a, sigma = inputs(8, oriented=oriented)
    kw = dict(num_hidden=HID, num_heads=HEADS, num_layers=2, num_out=3, embedding_type="rff",
              embedding_freq_multiplier=(0.5, 2.0), condition_value_transform=True,
              global_pooling=pooling)
    jinv, inv = (JaxPonita2D(), Ponita2D()) if oriented else (JaxPeriodic(2), RelativePositionPeriodic(2))
    jtr = JaxTransformer(self_attn_invariant=jinv, **kw)
    params = jtr.init(jax.random.PRNGKey(8), (p, a, sigma))
    tr = load_flax(EquivariantTransformer(latent_dim=LAT, self_attn_invariant=inv, **kw), params)
    want = jtr.apply(params, (p, a, sigma))
    got = tr((t(p), t(a), t(sigma)))
    assert got.shape == ((B, 3) if pooling else (B, Z, 3))
    assert_close(got, want)


# ----------------------------------------------------------------- JAX states


@pytest.mark.parametrize("overrides", [
    ("nef.num_layers=2",),
    ("nef.num_layers=1", "nef.embedding_type=ffn"),
    ("nef.embedding_type=polynomial", "nef.embedding_freq_multiplier_invariant=2",
     "nef.embedding_freq_multiplier_value=2"),
    ("nef.num_layers=1", "nef.invariant_type=ponita"),
])
def test_jax_state_converts_and_loads_strictly(overrides):
    """A JAX trainer's initial state through ``convert_params`` into the port's trainer
    (``load_state_dict`` strict), then the same decode of its latent init."""
    over = ["node.num_hidden=8", "node.basis_dim=4", "node.num_layers=1",
            "training.max_num_sampled_points=24", *overrides]
    jcfg, cfg = configs("navier_stokes", *over)
    coords = planar_coords(8, 8)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    lat = jstate.params["autodecoder"]
    p = jnp.concatenate([lat["p_pos"]] + ([jnp.asarray(lat["p_ori"])] if "p_ori" in lat else []), -1)
    x = jnp.asarray(coords)[None]
    want = jtr.decoder.apply(jstate.params["nef"], x, p, lat["a"], lat["gaussian_window"])
    got = tr.decoder(t(np.asarray(x)), t(np.asarray(p)), state["autodecoder"]["a"],
                     state["autodecoder"]["gaussian_window"])
    assert_close(got, want)
    # The YAML's nef.backend: xla, ode_backend: pallas; the kernels compute rff decoders only.
    eligible = not any(o.startswith("nef.embedding_type=") for o in overrides)
    assert (tr.train_backend, tr.ode_backend) == ("eager", "kernel" if eligible else "eager")
