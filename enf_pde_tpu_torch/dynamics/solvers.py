"""Fixed-step latent ODE solvers.

Counterpart of ``enf_pde_tpu/dynamics/solvers.py``: a forward Python loop over the
steps, where JAX scans. A latent state is a tuple of tensors ``(p, a, window)``.
Training rollouts rematerialize each step in the backward pass (``remat``, on by
default as in JAX's ``jax.checkpoint``), so backpropagation through a long horizon keeps
one step's inputs a step instead of every activation; ``stop_gradient`` cuts the
gradient between steps.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["euler_step", "rk4_step", "solve_latent_ode", "solve_ode"]

State = Tuple[torch.Tensor, ...]
VectorField = Callable[[State, float], State]


def _axpy(x: State, d: State, h) -> State:
    return tuple(xi + h * di for xi, di in zip(x, d))


def euler_step(f: VectorField, x: State, t, h) -> State:
    return _axpy(x, f(x, t), h)


def rk4_step(f: VectorField, x: State, t, h) -> State:
    k1 = f(x, t)
    k2 = f(_axpy(x, k1, 0.5 * h), t + 0.5 * h)
    k3 = f(_axpy(x, k2, 0.5 * h), t + 0.5 * h)
    k4 = f(_axpy(x, k3, h), t + h)
    return tuple(
        xi + (h / 6.0) * (a + 2 * b + 2 * c + d) for xi, a, b, c, d in zip(x, k1, k2, k3, k4)
    )


_STEPPERS = {"euler": euler_step, "rk4": rk4_step}


def solve_latent_ode(f: VectorField, latents: State, t0: float, tf: float, h: float,
                     method: str = "euler", stop_gradient: bool = False, remat: bool = True,
                     unroll: int = 1) -> State:
    """Roll a latent set ``(p, a, window)`` forward with a fixed-step integrator.

    Args:
        f: latent vector field, ``f(latents, t) -> d latents``.
        latents: the initial ``(p [b, z, *], a [b, z, *], window [b, z, 1])``.
        t0 / tf / h: start time, end time, step size; ``num_steps = int((tf - t0) / h)``.
        method: 'euler' | 'rk4'.
        stop_gradient: detach the carried state at the start of each step, so each
            step's gradient reaches ``f``'s parameters only through that step.
        remat: run each step under ``torch.utils.checkpoint`` (recomputed in the
            backward pass). It applies under grad mode only, so a rollout under
            ``torch.no_grad`` runs plain (``train.steps.latent_rollout`` also turns it
            off when nothing of the rollout requires grad). The recomputed step can
            differ from the first in the last bits where a kernel sums with atomics.
        unroll: JAX's scan unroll factor; accepted for the same signature, and without
            effect in eager PyTorch.

    Returns:
        ``(p, a, window)`` trajectories, each [batch, num_steps + 1, ...], the initial
        state first.
    """
    if method not in _STEPPERS:
        raise ValueError(f"Unknown method: {method!r}")
    stepper = _STEPPERS[method]
    num_steps = int((tf - t0) / h)
    remat = remat and torch.is_grad_enabled()

    def step(x: State, t) -> State:
        if stop_gradient:
            x = tuple(xi.detach() for xi in x)
        if remat:
            return checkpoint(stepper, f, x, t, h, use_reentrant=False)
        return stepper(f, x, t, h)

    states = [tuple(latents)]
    for i in range(num_steps):
        states.append(step(states[-1], t0 + h * i))
    return tuple(torch.stack(leaf, dim=1) for leaf in zip(*states))


def solve_ode(f: Callable[[torch.Tensor, float], torch.Tensor], x0: torch.Tensor, t0: float,
              tf: float, h: float, method: str = "rk4") -> torch.Tensor:
    """Fixed-step rollout of a tensor state; returns [num_steps + 1, *x0.shape]."""
    if method not in _STEPPERS:
        raise ValueError(f"Unknown method: {method!r}")
    stepper = _STEPPERS[method]
    num_steps = int((tf - t0) / h)
    g = lambda x, t: (f(x[0], t),)  # noqa: E731  (the steppers work on tuples)
    xs = [x0]
    for i in range(num_steps):
        xs.append(stepper(g, (xs[-1],), t0 + h * i, h)[0])
    return torch.stack(xs)
