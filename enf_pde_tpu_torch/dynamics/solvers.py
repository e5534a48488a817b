"""Fixed-step latent ODE solvers.

Counterpart of ``enf_pde_tpu/dynamics/solvers.py`` for serving: a forward Python loop
(no rematerialisation; the forecast does not backpropagate through the rollout).
A latent state is a tuple of tensors ``(p, a, window)``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["euler_step", "rk4_step", "solve_latent_ode"]

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
                     method: str = "euler") -> State:
    """Roll a latent set ``(p, a, window)`` forward with a fixed-step integrator.

    ``num_steps = int((tf - t0) / h)``. Returns the trajectories, each
    [batch, num_steps + 1, ...], the initial state first.
    """
    if method not in _STEPPERS:
        raise ValueError(f"Unknown method: {method!r}")
    stepper = _STEPPERS[method]
    num_steps = int((tf - t0) / h)
    states = [tuple(latents)]
    for i in range(num_steps):
        states.append(stepper(f, states[-1], t0 + h * i, h))
    return tuple(torch.stack(leaf, dim=1) for leaf in zip(*states))
