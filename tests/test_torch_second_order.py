"""Second order through the fused decode, and the serving and tooling pieces around it.

On the CPU the kernel wrappers run their plain versions; ``FusedDecode``'s double
backward goes through ``FusedDecodeVJP`` either way. Here:

- the double backward through ``FusedDecode`` behind the self-attention stack against
  the eager decoder's, in the pattern of ``tests/test_pallas.py``'s second-order test
  (one inner SGD step on the latents, then the outer gradient), and a third derivative
  against the plain composition's; rtol 2e-3 / atol 1e-4, as that test holds JAX's
  kernels;
- ``MetaSGDTrainer`` with ``nef.backend: pallas`` (``num_layers`` 0 and 2): the nef loss
  and gradients against the JAX package's nef step (XLA, the same math) on the same
  state and draws, at ``tests/test_torch_train.py``'s tolerances (loss rtol 1e-4,
  gradients rtol 2e-4 / atol 2e-5); and the fit on the kernels against the eager fit;
- the backends each trainer resolves, what the run record says, and the refusal of
  ``backend='kernel'`` for an ``ffn`` decoder;
- ``Forecaster``'s ``backend`` argument and ``from_checkpoint`` round trip; ``StepTimer``
  and ``trace``; ``load_config`` / ``Config.copy`` / ``Config.to_json`` against JAX's.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import load_config as jax_load_config_file
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer

from chip_smoke import smooth_trajectories
from enf_pde_tpu_torch.builders import build_models, resolve_backend
from enf_pde_tpu_torch.config import load_config, load_experiment_config
from enf_pde_tpu_torch.convert import convert_params
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.inference import Forecaster
from enf_pde_tpu_torch.ops import fused_decode as fd
from enf_pde_tpu_torch.ops.layers import reset_parameters
from enf_pde_tpu_torch.train.checkpoint import CheckpointManager
from enf_pde_tpu_torch.train.loop import TrainLoop
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.utils.profiling import StepTimer, trace
from tests.test_torch_modules import assert_close, np_tree, t
from tests.test_torch_train import (
    BATCH, FRAMES, LOSS_RTOL, OVERRIDES, SIZE, compare_grads, inner_masks, port_grads,
)

torch.set_num_threads(1)

JAX_CONFIGS = os.path.join(os.path.dirname(__file__), "..", "enf_pde_tpu", "experiments", "configs")


def small(*extra):
    """The Navier-Stokes config of tests/test_torch_train.py, with ``extra`` overrides."""
    return [f"{k}={v}" for k, v in OVERRIDES.items()] + list(extra)


# ----------------------------------------------------------------- FusedDecode


@pytest.fixture(scope="module")
def attended():
    """A full-width-shaped small decoder with two self-attention blocks, and its inputs."""
    cfg = load_experiment_config("navier_stokes", small("nef.num_layers=2", "nef.num_latents=4"))
    dec = build_models(cfg)[0]
    reset_parameters(dec, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    x = t(rng.uniform(-1, 1, (2, 32, 2)).astype(np.float32))
    p = t(rng.uniform(-1, 1, (2, 4, 2)).astype(np.float32))
    a = t((1 + 0.5 * rng.standard_normal((2, 4, 16))).astype(np.float32))
    w = torch.full((2, 4, 1), 0.6)
    y = t(rng.standard_normal((2, 32, 1)).astype(np.float32))
    return dec, (x, p, a, w), y


def outer_grads(dec, backend, inputs, y):
    """The meta-SGD pattern: one inner SGD step on the latents, then the outer gradient of
    every parameter and of the latents."""
    x, p, a, w = inputs
    lat = [v.clone().requires_grad_(True) for v in (p, a)]
    inner = ((dec(x, *lat, w, backend=backend) - y) ** 2).mean()
    steps = torch.autograd.grad(inner, lat, create_graph=True)
    moved = [v - 0.05 * s for v, s in zip(lat, steps)]
    outer = ((dec(x, *moved, w, backend=backend) - y) ** 2).mean()
    return torch.autograd.grad(outer, list(dec.parameters()) + lat)


def test_double_backward_through_fused_decode_matches_eager(attended):
    dec, inputs, y = attended
    want = outer_grads(dec, "eager", inputs, y)
    got = outer_grads(dec, "kernel", inputs, y)
    assert len(got) == len(want) == len(list(dec.parameters())) + 2
    for gk, ge in zip(got, want):
        assert float(ge.abs().max()) > 0
        assert_close(gk, ge, rtol=2e-3, atol=1e-4)


def test_third_derivative_through_fused_decode_matches_the_plain_composition(attended):
    """A third derivative reaches the inputs through FusedDecodeVJP's aliases. It is held
    against autograd through ``fused_decode_plain`` on the same folded inputs, not against
    the eager decoder: ``F.layer_norm``'s third derivative is off (by 3 % here in float64
    against central differences, where the plain composition's agrees to 2e-10)."""
    dec, (x, p, a, w), _ = attended

    def third(decode):
        pl, al = p.clone().requires_grad_(True), a.clone().requires_grad_(True)
        out = decode(pl, al)
        (g1,) = torch.autograd.grad((out ** 2).sum(), [al], create_graph=True)
        (g2,) = torch.autograd.grad((g1 ** 2).sum(), [al], create_graph=True)
        return torch.autograd.grad((g2 ** 2).sum(), [pl])[0]

    got = third(lambda pl, al: dec(x, pl, al, w, backend="kernel"))
    want = third(lambda pl, al: fd.fused_decode_plain(*dec.kernel_inputs(x, pl, al, w), dec.num_heads,
                                                      dec.num_hidden))
    assert float(want.abs().max()) > 0
    assert_close(got, want, rtol=2e-3, atol=1e-4)


def test_double_backward_takes_values_from_k2(attended, monkeypatch):
    """Under create_graph the inner gradient's values come from the K2 wrapper, once. The
    double backward then runs the plain composition once (FusedDecodeVJP's backward) and
    K2 once more, first order: the cotangent of the inner loss depends on the decode's
    output, whose VJP is FusedDecode's (on the CPU, K2's plain version runs the plain
    composition too)."""
    dec, (x, p, a, w), y = attended
    calls = {"bwd": 0, "plain": 0}
    real_bwd, real_plain = fd.fused_decode_bwd, fd.fused_decode_plain

    def bwd(*args, **kw):
        calls["bwd"] += 1
        return real_bwd(*args, **kw)

    def plain(*args, **kw):
        calls["plain"] += 1
        return real_plain(*args, **kw)

    monkeypatch.setattr(fd, "fused_decode_bwd", bwd)
    monkeypatch.setattr(fd, "fused_decode_plain", plain)
    lat = p.clone().requires_grad_(True)
    inner = ((dec(x, lat, a, w, backend="kernel") - y) ** 2).mean()
    (step,) = torch.autograd.grad(inner, [lat], create_graph=True)
    assert calls["bwd"] == 1 and step.requires_grad
    before = calls["plain"]
    (second,) = torch.autograd.grad(step.sum(), [lat], retain_graph=True)
    assert calls == {"bwd": 2, "plain": before + 2}
    assert float(second.abs().max()) > 0


# ----------------------------------------------------------------- the trainer


@pytest.fixture(scope="module", params=[0, 2], ids=["layers0", "layers2"])
def trainers(request):
    """(JAX trainer on XLA, its state, the port's trainer on the kernels with that state,
    its state, trajectories) at tests/test_torch_train.py's small width."""
    over = small(f"nef.num_layers={request.param}")
    jcfg = jax_load_config("navier_stokes", over)
    coords = planar_coords(SIZE, SIZE)
    jtr = JaxTrainer(jcfg, *jax_build_models(jcfg), coords, seed=0)
    jstate = jtr.init_state()
    cfg = load_experiment_config("navier_stokes", over + ["nef.backend=pallas"])
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=0, device="cpu")
    state = tr.load_state(convert_params(np_tree(jstate.params)))
    return jtr, jstate, tr, state, smooth_trajectories(BATCH, FRAMES, SIZE, seed=7)


def test_nef_loss_and_grads_on_the_kernels_match_jax(trainers):
    jtr, jstate, tr, state, traj = trainers
    assert (tr.train_backend, tr.eval_backend, tr.ode_backend) == ("kernel",) * 3
    rng = jax.random.PRNGKey(5)
    want_loss, want = jax.jit(jax.value_and_grad(jtr._nef_loss))(jstate.params, jnp.asarray(traj), rng)
    k_sel, k_inner = jax.random.split(rng)
    frame_idx = np.asarray(jax.random.permutation(k_sel, jtr.cfg.dataset.traj_len_train)[:2])
    masks = inner_masks(jtr.cfg, k_inner, SIZE * SIZE)
    loss, got = tr.nef_grads(state, torch.from_numpy(traj), frame_idx=frame_idx, masks=masks)
    assert_close(loss, want_loss, rtol=LOSS_RTOL)
    assert compare_grads(got, port_grads(want), ("nef", "meta_sgd_lrs", "autodecoder")) > 10


def test_fit_on_the_kernels_matches_the_eager_fit(trainers):
    _, _, tr, state, traj = trainers
    masks = torch.stack([torch.randperm(SIZE * SIZE, generator=torch.Generator().manual_seed(i))[:24]
                         for i in range(3)])
    fits = {}
    for backend in ("kernel", "eager"):
        tr.train_backend = backend
        fits[backend] = tr.fit_latents(state, torch.from_numpy(traj[:, 0]), masks=masks)
    tr.train_backend = "kernel"
    for k, v in fits["eager"].items():
        assert_close(fits["kernel"][k], v, rtol=2e-4, atol=2e-5)


def test_inner_steps_and_fits_ask_k2_for_no_weight_gradient(trainers, monkeypatch):
    """K2 is asked for weight gradients only where something reads them. A nef step's K inner steps
    (create_graph) take the latents' gradients alone (``latent_grads_only``); the outer backward through
    each inner step and the query decode take the weights' too: K + 1 of its 2K + 1 K2 calls. A fit runs
    with the decoder frozen: its K calls take none. The nef step's loss and gradients and the fitted
    latents are bit for bit what they are with every K2 call asked for weight gradients (the parent's
    behaviour: the inner steps outside ``latent_grads_only``, the fit with the decoder in autograd)."""
    from enf_pde_tpu_torch.train import inner_loop as il

    _, _, tr, state, traj = trainers
    K = tr.cfg.meta.num_inner_steps
    flags = []
    real = fd.fused_decode_bwd

    def bwd(*args, **kw):
        flags.append(bool(args[11]))
        return real(*args, **kw)

    monkeypatch.setattr(fd, "fused_decode_bwd", bwd)
    masks = np.stack([np.random.default_rng(i).permutation(SIZE * SIZE)[:24] for i in range(K + 1)])
    frame_idx = np.array([0, 2])

    def nef():
        flags.clear()
        loss, grads = tr.nef_grads(state, torch.from_numpy(traj), frame_idx=frame_idx, masks=masks)
        return loss, grads, list(flags)

    loss, grads, got = nef()
    assert sorted(got) == [False] * K + [True] * (K + 1) and got[:K] == [False] * K
    monkeypatch.setattr(il, "latent_grads_only", contextlib.nullcontext)
    loss0, grads0, before = nef()
    assert before == [True] * (2 * K + 1)
    assert torch.equal(loss, loss0)
    for group in grads:
        for k, v in grads[group].items():
            assert torch.equal(v, grads0[group][k]), (group, k)

    frames = torch.from_numpy(traj[:, 0])
    flags.clear()
    fit = tr.fit_latents(state, frames, masks=torch.from_numpy(masks[:K]))
    assert flags == [False] * K
    flags.clear()
    fit0 = tr.inner_loop(state["meta_sgd_lrs"], state["autodecoder"], frames, generator=tr.generator,
                         masks=torch.from_numpy(masks[:K]))
    assert flags == [True] * K
    for k, v in fit.items():
        assert torch.equal(v, fit0[k]), k


# ----------------------------------------------------------------- backends


@pytest.mark.parametrize("overrides,want", [
    ((), ("eager", "kernel", "kernel")),  # the YAML: backend xla, eval and ode pallas
    (("nef.backend=pallas",), ("kernel", "kernel", "kernel")),
    (("nef.backend=pallas", "nef.embedding_type=ffn"), ("eager", "eager", "eager")),
    (("nef.condition_value_transform=false",), ("eager", "eager", "eager")),
])
def test_trainers_resolve_backends_once(overrides, want, capsys):
    cfg = load_experiment_config("navier_stokes", small(*overrides))
    tr = MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), seed=0, device="cpu")
    assert (tr.train_backend, tr.eval_backend, tr.ode_backend) == want
    said = capsys.readouterr().out
    assert ("resolves to eager" in said) == ("eager" in want[1:])


def test_kernel_backend_refuses_a_decoder_it_does_not_compute():
    cfg = load_experiment_config("navier_stokes", small("nef.embedding_type=ffn"))
    dec = build_models(cfg)[0]
    assert not dec.kernel_eligible and resolve_backend("pallas", dec) == "eager"
    assert resolve_backend("xla", dec) == "eager"
    x, p, a, w = torch.zeros(1, 3, 2), torch.zeros(1, 4, 2), torch.zeros(1, 4, 16), torch.ones(1, 4, 1)
    with pytest.raises(ValueError, match="backend='eager'"):
        dec(x, p, a, w, backend="kernel")


def test_the_run_record_names_the_resolved_backends(tmp_path):
    cfg = load_experiment_config("navier_stokes", small(
        "nef.backend=pallas", "nef.num_layers=1", "training.num_epochs=1", "test.test_interval=5",
        "test.test_dp_interval=5", f"logging.log_dir={tmp_path}"))
    tr = MetaSGDTrainer(cfg, *build_models(cfg), planar_coords(SIZE, SIZE), seed=0, device="cpu")
    traj = smooth_trajectories(BATCH, FRAMES, SIZE, seed=1)
    TrainLoop(tr, [traj], [traj]).run(1)
    records = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    rec = next(r for r in records if "train_backend" in r)
    assert (rec["train_backend"], rec["eval_backend"], rec["ode_backend"]) == ("kernel",) * 3
    assert np.isfinite(next(r for r in records if "train_mse_epoch" in r)["train_mse_epoch"])


# ----------------------------------------------------------------- serving


def test_forecaster_from_checkpoint_round_trip(tmp_path):
    """A checkpoint served by from_checkpoint forecasts what a Forecaster built from the
    same state does, bit for bit; backend='pallas' fits on the eager decoder and decodes
    on the kernel, as JAX's default."""
    cfg = load_experiment_config("navier_stokes", small("nef.backend=pallas", "nef.num_layers=1"))
    coords = planar_coords(SIZE, SIZE)
    tr = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=4, device="cpu")
    state = tr.init_state()
    tr.nef_train_step(state, torch.from_numpy(smooth_trajectories(BATCH, FRAMES, SIZE, seed=2)))
    CheckpointManager(str(tmp_path), every_n_epochs=1).save(1, tr, state, cfg.to_dict())
    served = Forecaster.from_checkpoint(str(tmp_path), cfg, coords, device="cpu")
    assert (served.trainer.train_backend, served.trainer.eval_backend) == ("eager", "kernel")
    assert cfg.nef.backend == "pallas"  # the caller's config is not changed
    params = {"nef": tr.decoder.state_dict(), "ode": tr.ode_model.state_dict(),
              "autodecoder": state["autodecoder"], "meta_sgd_lrs": state["meta_sgd_lrs"]}
    built = Forecaster(cfg, coords, params=params, device="cpu", backend="pallas")
    frames = smooth_trajectories(BATCH, 1, SIZE, seed=3)[:, 0]
    got, want = served.forecast(frames, num_frames=3), built.forecast(frames, num_frames=3)
    assert got.shape == (BATCH, 3, SIZE * SIZE, 1) and torch.equal(got, want)
    with pytest.raises(FileNotFoundError):
        Forecaster.from_checkpoint(str(tmp_path / "none"), cfg, coords, device="cpu")


# ----------------------------------------------------------------- utilities


def test_step_timer():
    timer = StepTimer(ema=0.5)
    assert timer.tick() is None
    import time

    time.sleep(0.01)
    dt = timer.tick()
    assert dt is not None and dt > 0.005
    assert timer.throughput(100) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


@pytest.mark.parametrize("name", sorted(f[:-5] for f in os.listdir(JAX_CONFIGS) if f.endswith(".yaml")))
def test_load_config_reads_each_yaml_as_jax_does(name):
    path = os.path.join(JAX_CONFIGS, f"{name}.yaml")
    over = ["nef.num_layers=2", "nef.backend=pallas", "training.ode.train_from_epoch=1"]
    got, want = load_config(path, over), jax_load_config_file(path, over)
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()
    copy = got.copy()
    copy.nef.num_layers = 5
    assert got.nef.num_layers == 2 and copy.to_dict() != got.to_dict()
    if name in ("navier_stokes", "diffusion_plane"):
        assert got.to_dict() == load_experiment_config(name, over).to_dict()
