"""The whole slice: the port's Forecaster against the JAX Forecaster, on the CPU.

Both packages get the same parameters (the JAX trainer's init, converted) and the
same inner-loop coordinate masks (drawn by JAX ``sample_coordinate_masks`` with the
key that JAX ``Forecaster.fit`` splits off). The JAX side decodes through the TPU
kernel in the Pallas interpreter; the port's kernel backend runs its plain version
on the CPU. Navier-Stokes config at small width (hidden 32, 16x16 grid).
"""

import jax
import numpy as np
import pytest
import torch

from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.data import planar_coords as jax_planar_coords
from enf_pde_tpu.inference import Forecaster as JaxForecaster
from enf_pde_tpu.train.inner_loop import sample_coordinate_masks

from chip_smoke import smooth_frames
from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.convert import convert_params
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.inference import Forecaster
from enf_pde_tpu_torch.models.latents import latents_to_pose
from enf_pde_tpu_torch.models import decoder as decoder_module
from tests.test_torch_modules import assert_close, np_tree

torch.set_num_threads(1)

SIZE, BATCH, FRAMES = 16, 2, 4
OVERRIDES = {
    "nef.num_hidden": 32,
    "node.num_hidden": 32,
    "node.basis_dim": 16,
    "node.num_layers": 2,
    "training.max_num_sampled_points": 64,
}


def jax_masks(cfg, num_coords):
    """The inner-loop masks of the first ``JaxForecaster.fit`` call."""
    _, key = jax.random.split(jax.random.PRNGKey(cfg.seed))
    _, k_mask, _ = jax.random.split(key, 3)
    return np.asarray(sample_coordinate_masks(
        k_mask, num_coords, cfg.meta.num_inner_steps + 1, cfg.training.max_num_sampled_points))


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_load_config("navier_stokes", [f"{k}={v}" for k, v in OVERRIDES.items()])
    cfg = load_experiment_config("navier_stokes")
    for k, v in OVERRIDES.items():
        cfg.set_path(k, v)
    coords = planar_coords(SIZE, SIZE)
    np.testing.assert_array_equal(coords, jax_planar_coords(SIZE, SIZE))
    jfc = JaxForecaster(jcfg, state=None, coords=coords, backend="pallas_interpret", coord_mesh=None)
    state = jfc.trainer.init_state()
    # Scale the ODE readouts (initialised at 1e-6) so the rollout moves the latents.
    ode = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 300 if "Dense_3" in str(path) or "Dense_4" in str(path) else v,
        state.params["ode"])
    jfc.state = state.replace(params={**state.params, "ode": ode})
    fc = Forecaster(cfg, coords, params=convert_params(np_tree(jfc.state.params)), device="cpu")
    frames = smooth_frames(BATCH, SIZE, seed=1)
    masks = jax_masks(jcfg, SIZE * SIZE)
    want = np.asarray(jfc.forecast(frames, num_frames=FRAMES))
    return jfc, fc, frames, masks, want


def test_forecast_matches_jax(pair):
    _, fc, frames, masks, want = pair
    got = fc.forecast(frames, num_frames=FRAMES, masks=masks)
    assert got.shape == (BATCH, FRAMES, SIZE * SIZE, 1) and want.shape == got.shape
    assert float(np.abs(want[:, -1] - want[:, 0]).max()) > 1e-3  # the rollout moved the field
    # 3 inner SGD steps (lr 5 on the contexts), 3 Euler steps and a decode compound
    # f32 rounding differences between the two frameworks' sum orders.
    assert_close(got, want, rtol=1e-3, atol=1e-4)


def test_fit_and_rollout_match_jax(pair):
    jfc, fc, frames, masks, _ = pair
    nef, lrs, init = (jfc.state.params[k] for k in ("nef", "meta_sgd_lrs", "autodecoder"))
    _, key = jax.random.split(jax.random.PRNGKey(jfc.cfg.seed))
    jloss, jlat = jfc.trainer.inner_loop(nef, lrs, init, jax.numpy.asarray(frames), key)
    lat = fc.trainer.inner_loop(fc.state["meta_sgd_lrs"], fc.state["autodecoder"],
                                torch.from_numpy(frames), masks=masks)
    assert set(lat) == set(jlat)
    # JAX's query loss: the fitted latents' error on the held-out (K+1)-th mask.
    held_out = torch.from_numpy(masks[fc.cfg.meta.num_inner_steps])
    with torch.no_grad():
        xs = fc.trainer.coords[held_out].expand(BATCH, -1, -1)
        pred = fc.trainer.decoder(xs, *latents_to_pose(lat))
    target = torch.from_numpy(frames).reshape(BATCH, -1, 1)[:, held_out]
    assert_close(torch.mean((pred - target) ** 2), jloss)
    for k in jlat:
        moved = float(np.abs(np.asarray(jlat[k]) - np.asarray(init[k])).max())
        assert moved > 1e-4 if k != "gaussian_window" else moved == 0.0, k  # the window is frozen
        assert_close(lat[k], jlat[k], rtol=1e-3, atol=1e-5)
    # The rollout from the same (JAX-fitted) latents.
    jtraj = jfc.rollout({k: np.asarray(v) for k, v in jlat.items()}, FRAMES)
    traj = fc.rollout({k: torch.from_numpy(np.asarray(v)) for k, v in jlat.items()}, FRAMES)
    for got, want in zip(traj, jtraj):
        assert got.shape == want.shape
        assert_close(got, want)


def test_decode_at_other_coords_and_sparse_fit(pair):
    jfc, fc, frames, masks, _ = pair
    lat = fc.fit(frames, masks=masks)
    traj = fc.rollout(lat, 2)
    hi = planar_coords(2 * SIZE, 2 * SIZE)
    got = fc.decode(traj, coords=hi, chunk_size=100)  # ragged last chunk
    want = jfc.decode(tuple(np.asarray(x.numpy()) for x in traj), coords=hi, chunk_size=100)
    assert got.shape == (BATCH, 2, 4 * SIZE * SIZE, 1)
    assert_close(got, np.asarray(want))
    sparse = fc.forecast(frames, num_frames=2, dp=0.5)
    assert sparse.shape == (BATCH, 2, SIZE * SIZE, 1) and torch.isfinite(sparse).all()


def test_decode_folds_once_for_all_chunks(pair, monkeypatch):
    """The kernel backend's weight fold runs once per decode, not once per chunk."""
    _, fc, frames, masks, _ = pair
    traj = fc.rollout(fc.fit(frames, masks=masks), 2)
    dec = fc.trainer.decoder
    fold, calls = dec.fold, []
    monkeypatch.setattr(dec, "fold", lambda p, a, w: calls.append(p.shape) or fold(p, a, w))
    got = fc.decode(traj, chunk_size=48)  # 6 chunks, the last one ragged
    assert calls == [(BATCH * 2, fc.cfg.nef.num_latents, 2)]
    p, a, w = (x.reshape(BATCH * 2, *x.shape[2:]) for x in traj)
    with torch.no_grad():
        eager = dec(fc.trainer.coords[None].expand(BATCH * 2, -1, -1), p, a, w, backend="eager")
    assert_close(got, eager.reshape(got.shape))


def test_decode_splits_the_shared_weights_once(pair, monkeypatch):
    """The kernel backend lays out what K1 reads (its shared weights split, and at the bf16 program's
    class 128 G and the tail's weights blocked: ``k1_operands``) once per decode and hands that layout
    to every chunk's launch."""
    _, fc, frames, masks, _ = pair
    traj = fc.rollout(fc.fit(frames, masks=masks), 2)
    splits, seen = [], []
    # The decode driver both trainers share, ``models.decoder.decode_trajectories``.
    k1_operands, fwd = decoder_module.k1_operands, decoder_module.fused_decode_fwd
    monkeypatch.setattr(decoder_module, "k1_operands",
                        lambda *args: splits.append(k1_operands(*args)) or splits[-1])
    monkeypatch.setattr(decoder_module, "fused_decode_fwd",
                        lambda *args, split=None, **kw: seen.append(split) or fwd(*args, split=split, **kw))
    got = fc.decode(traj, chunk_size=48)  # 6 chunks, the last one ragged
    assert got.shape == (BATCH, 2, SIZE * SIZE, 1)
    assert len(splits) == 1 and len(seen) == 6 and all(s is splits[0] for s in seen)


def test_random_init_is_seeded():
    cfg = load_experiment_config("navier_stokes")
    for k, v in OVERRIDES.items():
        cfg.set_path(k, v)
    coords = planar_coords(SIZE, SIZE)
    a, b = (Forecaster(cfg, coords, device="cpu") for _ in range(2))
    for (n, pa), pb in zip(a.trainer.decoder.state_dict().items(), b.trainer.decoder.state_dict().values()):
        assert torch.equal(pa, pb), n
    frames = smooth_frames(BATCH, SIZE, seed=2)
    assert torch.equal(a.forecast(frames, 2), b.forecast(frames, 2))
