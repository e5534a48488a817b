"""The port's latent-ODE solvers in full (``dynamics/solvers.py``) against the JAX package's.

``solve_ode`` on a harmonic oscillator; ``solve_latent_ode`` with and without
``stop_gradient`` differentiated through a PONITA field loaded from JAX's parameters,
against ``jax.grad`` of JAX's solver (rtol 2e-4 / atol 2e-5); the rematerialized
rollout against the stored one (equal trajectories, gradients to rtol 1e-6), also at the
trainer's ode and dual steps; and the trainer's rollout reading ``node.ode_unroll`` and
JAX's remat default. The ode / dual steps against JAX's, with the rollout rematerialized
as it now is, stay in ``tests/test_torch_train.py`` at their tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.dynamics.solvers import solve_latent_ode as jax_solve
from enf_pde_tpu.dynamics.solvers import solve_ode as jax_solve_ode

from chip_smoke import smooth_trajectories
from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.convert import flax_to_state_dict
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.dynamics import solvers
from enf_pde_tpu_torch.dynamics.solvers import solve_latent_ode, solve_ode
from enf_pde_tpu_torch.train import steps
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from tests.test_torch_modules import assert_close, np_tree, ponita_pair, t
from tests.test_torch_train import OVERRIDES, port_config

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_solve_ode_matches_jax_on_a_harmonic_oscillator(method):
    omega = 2.0
    field = lambda x, _: x[..., ::-1] * np.array([1.0, -1.0], np.float32) * omega  # noqa: E731
    x0 = np.array([[1.0, 0.0], [0.3, -0.5]], np.float32)
    want = jax_solve_ode(lambda x, tt: field(x, tt), jnp.asarray(x0), 0.0, 2.0, 0.05, method)
    got = solve_ode(lambda x, _: torch.flip(x, [-1]) * torch.tensor([1.0, -1.0]) * omega,
                    torch.from_numpy(x0), 0.0, 2.0, 0.05, method)
    assert got.shape == (41, 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    if method == "rk4":  # the exact solution: a rotation by omega t
        c, s = np.cos(omega * 2.0), np.sin(omega * 2.0)
        exact = x0 @ np.array([[c, -s], [s, c]], np.float32)
        np.testing.assert_allclose(got[-1].numpy(), exact, atol=1e-5)


def _objective(traj, weights):
    return sum((x * w).sum() for x, w in zip(traj, weights))


@pytest.mark.parametrize("stop_gradient", [True, False])
def test_solve_latent_ode_gradients_match_jax(stop_gradient):
    """The rollout's gradient for the ODE's parameters and the initial latents, through
    JAX's default remat and with the carry cut between steps or not."""
    jode, params, ode, lat = ponita_pair(readout_scale=300)
    rng = np.random.default_rng(4)
    weights = [rng.standard_normal((lat[0].shape[0], 4, *x.shape[1:])).astype(np.float32) for x in lat]

    def jax_loss(prm, latents):
        traj = jax_solve(lambda z, _: jode.apply(prm, z), latents, t0=0, tf=3, h=1,
                         stop_gradient=stop_gradient)
        return _objective(traj, weights)

    want_params, want_lat = jax.grad(jax_loss, argnums=(0, 1))(params, lat)
    leaves = tuple(t(v).requires_grad_(True) for v in lat)
    traj = solve_latent_ode(lambda z, _: ode(z), leaves, 0, 3, 1, stop_gradient=stop_gradient)
    loss = _objective(traj, [t(w) for w in weights])
    names = [n for n, p in ode.named_parameters()]
    got = torch.autograd.grad(loss, [*ode.parameters(), *leaves], allow_unused=True)
    want = flax_to_state_dict(np_tree(want_params))
    for name, g in zip(names, got):
        assert_close(g, want[name].reshape(g.shape), rtol=RTOL, atol=ATOL)
    for g, w in zip(got[len(names):], want_lat):
        assert_close(g, w, rtol=RTOL, atol=ATOL)
    if stop_gradient:  # the initial latents reach the loss through frame 0 only
        assert_close(got[len(names) + 1], weights[1][:, 0], rtol=0, atol=0)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_remat_gives_the_rollout_and_gradients_of_the_stored_rollout(method):
    _, _, ode, lat = ponita_pair(readout_scale=300)
    weights = [torch.randn(lat[0].shape[0], 5, *x.shape[1:], generator=torch.Generator().manual_seed(2))
               for x in lat]
    out = {}
    for remat in (True, False):
        leaves = tuple(t(v).requires_grad_(True) for v in lat)
        traj = solve_latent_ode(lambda z, _: ode(z), leaves, 0, 4, 1, method, remat=remat)
        grads = torch.autograd.grad(_objective(traj, weights), [*ode.parameters(), *leaves])
        out[remat] = (traj, grads)
    for a, b in zip(out[True][0], out[False][0]):
        assert torch.equal(a, b)
    for a, b in zip(out[True][1], out[False][1]):
        assert_close(a, b, rtol=1e-6, atol=0)
    assert any(float(g.abs().max()) > 0 for g in out[True][1])


def _trainer(**extra):
    cfg = port_config(**extra)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(8, 8), seed=0, device="cpu")
    return tr, tr.init_state()


@pytest.mark.parametrize("kind", ["ode", "dual"])
def test_step_gradients_equal_with_and_without_remat(monkeypatch, kind):
    traj = torch.from_numpy(smooth_trajectories(2, 5, 8, seed=7))
    tr, state = _trainer()
    with torch.no_grad():  # readouts that move the latents (they start at 1e-6)
        for name, p in tr.ode_model.named_parameters():
            if "Dense_3" in name or "Dense_4" in name:
                p.mul_(300)
    fn = getattr(tr, f"{kind}_grads")
    draws = dict(masks=torch.stack([torch.randperm(64, generator=torch.Generator().manual_seed(k))[:24]
                                    for k in range(OVERRIDES["meta.num_inner_steps"] + 1)]),
                 ode_masks=torch.stack([torch.randperm(64, generator=torch.Generator().manual_seed(9 + k))[:24]
                                        for k in range(OVERRIDES["dataset.traj_len_train"])]))
    calls = []
    real = solvers.solve_latent_ode

    def spy(*args, **kwargs):
        calls.append(kwargs["remat"])
        return real(*args, **kwargs)

    monkeypatch.setattr(steps, "solve_latent_ode", spy)
    loss_on, on = fn(state, traj, **draws)
    monkeypatch.setattr(steps, "solve_latent_ode", lambda *a, **kw: real(*a, **{**kw, "remat": False}))
    loss_off, off = fn(state, traj, **draws)
    assert calls == [True]  # JAX's default: the training rollout is rematerialized
    assert float(loss_on) == float(loss_off)
    for g in on:
        for k in on[g]:
            assert_close(on[g][k], off[g][k], rtol=1e-6, atol=0)
    assert float(on["ode"]["PonitaGen_0.Dense_3.weight"].abs().max()) > 0


def test_rollout_reads_ode_unroll_and_remats_only_what_records(monkeypatch):
    tr, state = _trainer(**{"node.ode_unroll": 3})
    seen = []
    real = solvers.solve_latent_ode
    monkeypatch.setattr(steps, "solve_latent_ode",
                        lambda *a, **kw: seen.append((kw["unroll"], kw["remat"])) or real(*a, **kw))
    p, a, w = (torch.zeros(2, 4, 2), torch.ones(2, 4, 16), torch.ones(2, 4, 1))
    tr._rollout((p, a, w), 3)  # the ODE's parameters require grad
    with steps.frozen(tr.ode_model):
        tr._rollout((p, a, w), 3)  # nothing of the rollout records a graph
        tr._rollout((p.requires_grad_(True), a, w), 3)
    assert seen == [(3, True), (3, False), (3, True)]
    sol = tr.rollout_latents({"p_pos": p.detach(), "a": a, "gaussian_window": w}, 3)
    assert sol[0].shape == (2, 3, 4, 2) and not sol[0].requires_grad


def test_unknown_methods_raise():
    x = torch.zeros(2)
    with pytest.raises(ValueError, match="Unknown method"):
        solve_ode(lambda y, _: y, x, 0.0, 1.0, 0.5, method="midpoint")
    with pytest.raises(ValueError, match="Unknown method"):
        solve_latent_ode(lambda z, _: z, (x,), 0.0, 1.0, 0.5, method="midpoint")
