"""Construction of decoder + latent-ODE models from an experiment config.

Counterpart of ``enf_pde_tpu/builders.py``. The config keeps the JAX package's
decoder backend names: ``xla`` is the port's eager decoder, ``pallas`` its fused kernels
(``kernel``: bf16 operands on the card, as the JAX kernel runs on its chip; f32 on the CPU)
and ``pallas_interpret`` the kernels' strict-f32 programs (``kernel_f32``, JAX's
``compute_dtype=float32``) (``decoder_backend``). The kernels compute only a decoder with the
RFF embedding and the value conditioning; for any other, ``resolve_backend`` resolves
``pallas`` (and ``pallas_interpret``) to the eager decoder, as the JAX decoder takes its XLA
path there, and says so.
"""

from __future__ import annotations

from typing import Tuple, Union

from enf_pde_tpu_torch.dynamics.mlp_ode import MLPLatentODE
from enf_pde_tpu_torch.dynamics.ponita import PonitaLatentODE
from enf_pde_tpu_torch.geometry.invariants import get_ca_invariant, get_sa_invariant
from enf_pde_tpu_torch.models.decoder import EnfDecoder

__all__ = ["build_models", "coordinate_system_for", "decoder_backend", "resolve_backend"]

_BACKENDS = {"xla": "eager", "pallas": "kernel", "pallas_interpret": "kernel_f32"}


def decoder_backend(name: str) -> str:
    """The port's decoder backend for a config's ``nef.*backend`` value."""
    if name not in _BACKENDS:
        raise ValueError(f"Decoder backend {name!r} has no counterpart in the port ({sorted(_BACKENDS)}).")
    return _BACKENDS[name]


def resolve_backend(name: str, decoder: EnfDecoder, key: str = "nef.backend") -> str:
    """The backend that decodes for config value ``name`` (of ``key``): ``decoder_backend``,
    except that a kernel backend on a decoder the kernels do not compute
    (``not decoder.kernel_eligible``) resolves to ``'eager'``, with a line that says so.
    The trainers call it once per backend key, at construction."""
    backend = decoder_backend(name)
    if backend != "eager" and not decoder.kernel_eligible:
        print(f"[builders] {key}: {name} resolves to eager: the fused kernels compute the rff "
              f"embedding with condition_value_transform, this decoder has embedding_type="
              f"{decoder.embedding_type!r}, condition_value_transform={decoder.condition_value_transform}")
        return "eager"
    return backend


def coordinate_system_for(dataset_name: str) -> str:
    """Latent coordinate system per dataset (the cartesian and polar ones are ported)."""
    if dataset_name in ("diff_sphere", "shallow_water", "shallow_water_low_res"):
        return "polar"
    if dataset_name == "ihc":
        return "ball"
    return "cartesian"


def build_models(cfg) -> Tuple[EnfDecoder, Union[PonitaLatentODE, MLPLatentODE]]:
    """Build the ENF decoder and the latent ODE model (``node.name``: ``ponita``, or the
    ``mlp`` baseline) from a config.

    Their parameters are left uninitialised (see ``MetaSGDTrainer.init_state``).
    """
    sa_invariant = get_sa_invariant(cfg.nef)
    ca_invariant = get_ca_invariant(cfg.nef)
    decoder = EnfDecoder(
        num_hidden=cfg.nef.num_hidden,
        num_heads=cfg.nef.num_heads,
        num_layers=cfg.nef.num_layers,
        num_out=cfg.nef.num_out,
        latent_dim=cfg.nef.latent_dim,
        cross_attn_invariant=ca_invariant,
        embedding_type=cfg.nef.embedding_type,
        embedding_freq_multiplier=(
            cfg.nef.embedding_freq_multiplier_invariant,
            cfg.nef.embedding_freq_multiplier_value,
        ),
        condition_value_transform=cfg.nef.condition_value_transform,
        use_gaussian_window=cfg.nef.use_gaussian_window,
        self_attn_invariant=sa_invariant,
    )
    if cfg.node.name == "mlp":
        pose_dim = sa_invariant.num_z_pos_dims + sa_invariant.num_z_ori_dims
        return decoder, MLPLatentODE(
            num_in=pose_dim + cfg.nef.latent_dim,
            num_hidden=cfg.node.num_hidden,
            scalar_num_out=cfg.nef.latent_dim,
            vec_num_out=1,
        )
    if cfg.node.name != "ponita":
        raise ValueError(f"Unknown ODE model: {cfg.node.name!r}")
    ode_model = PonitaLatentODE(
        num_hidden=cfg.node.num_hidden,
        num_layers=cfg.node.num_layers,
        scalar_num_out=cfg.nef.latent_dim,
        vec_num_out=1,
        invariant=sa_invariant,
        basis_dim=cfg.node.basis_dim,
        degree=cfg.node.degree,
        widening_factor=cfg.node.widening_factor,
        kernel_size=cfg.node.kernel_size,
        global_pool=False,
    )
    return decoder, ode_model
