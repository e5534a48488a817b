"""enf-pde-tpu in PyTorch: the port of ``enf_pde_tpu`` to PyTorch and CUDA on Hopper.

The JAX package stays the reference; each module here names its counterpart there.
This package imports only ``torch``, ``numpy`` and the standard library. Its entry
points run on the card (``device="cuda"``) unless the caller asks for the CPU.

Ported so far (ROADMAP.md): the Navier-Stokes forecast path -- config, the torus
invariant, the decoder (eager, and the fused decode kernels: forward
``csrc/fused_decode_fwd.cu``, backward ``csrc/fused_decode_bwd.cu``), the PONITA
latent ODE, the meta-SGD latent fit, and ``inference.Forecaster``; its training
path -- optimizers, the nef / ode / dual steps, validation and ``train.loop.TrainLoop``
with checkpoints, resume, the equivariance check and figures; its data -- the
spectral solver, the trajectory cache and loader (``data``); and the experiment CLI
``experiments.fit``. ``convert`` loads the JAX package's parameters. Then the SE(2)
planar experiments ``diffusion_plane`` and ``cahn_hilliard`` (the ``ponita`` invariants,
oriented latents and PONITA, their solvers), and the heat equation on the sphere,
``diff_sphere`` (the ``polar_periodic`` invariant, polar latents, spherical-harmonic
transforms in ``data.sphere_harmonics``); shallow water, the paper's baselines and
convection in the ball; and the whole decoder family -- latent self attention, the
``ffn`` and ``polynomial`` embeddings, ``models.transformer``, second order through the
kernels, ``Forecaster.from_checkpoint`` and ``utils.profiling``; and the last modules --
data-parallel training and the coordinate-sharded decode on ``torch.distributed``
(``parallel``), the solvers' ``remat`` / ``stop_gradient`` and ``solve_ode``, the native
trajectory prefetcher (``data.native_loader``, ``csrc/trajloader.cc``) and the split-DFT
Navier-Stokes path (``data.splitfft``). Everything the JAX package does but wandb.
"""

__version__ = "0.1.0"
